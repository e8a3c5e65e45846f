"""4:4:4 -> 4:2:0 chroma downsample (stages A-C, RTL/mpeg2encoder.v:1086-1171).

The RTL streams pixels through a one-line buffer; here the whole frame is one
fused elementwise pass (two mean2 reductions, each with +1 rounding - NOT a
single mean4, the roundings compound differently).
"""
from __future__ import annotations

import jax.numpy as jnp


def mean2(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return (1 + a.astype(jnp.int32) + b.astype(jnp.int32)) >> 1


def _half(p: jnp.ndarray) -> jnp.ndarray:
    """(H, W) uint8 -> (H/2, W/2) uint8: horizontal pairs, then vertical."""
    ph = mean2(p[:, 0::2], p[:, 1::2])
    return mean2(ph[1::2], ph[0::2]).astype(jnp.uint8)


def subsample_420(y: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray):
    """(H, W) uint8 4:4:4 planes -> (y, u420, v420) with u/v at (H/2, W/2)."""
    return y, _half(u), _half(v)
