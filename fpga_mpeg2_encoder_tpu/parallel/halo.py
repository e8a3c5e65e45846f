"""Sequence-parallel (slice-row) sharding support: halo exchange of the reconstructed
reference frame.

P-frame motion estimation for a macroblock row needs +-YR rows (YR <= 6) of the
previous frame's reconstruction beyond its own shard (SURVEY.md section 2.9).  When a
frame's slice rows are sharded over a mesh axis, those rows live on the neighbouring
devices; ``exchange_halo`` moves them with two ``lax.ppermute`` shifts - the
neighbour exchange of a context-parallel ring.

The reference needs no such machinery only because it is a single chip; the RTL's
equivalent hazard is handled by the one-slice write-delay memory
(RTL/mpeg2encoder.v:2364-2424).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P


def exchange_halo(x: jnp.ndarray, halo: int, axis_name: str) -> jnp.ndarray:
    """Inside shard_map: pad a row-sharded block (rows, W) with ``halo`` rows from the
    ring neighbours -> (rows + 2*halo, W).  Edge shards receive zeros (their
    out-of-frame candidates are masked, RTL:1642-1645, so the value never matters)."""
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    top = x[:halo]          # my first rows -> needed by my upper neighbour's bottom halo
    bot = x[-halo:]         # my last rows  -> needed by my lower neighbour's top halo
    # receive my top halo from the neighbour above (idx-1): they send their `bot`
    from_above = jax.lax.ppermute(bot, axis_name,
                                  [(i, (i + 1) % n) for i in range(n)])
    # receive my bottom halo from the neighbour below (idx+1): they send their `top`
    from_below = jax.lax.ppermute(top, axis_name,
                                  [(i, (i - 1) % n) for i in range(n)])
    from_above = jnp.where(idx == 0, jnp.zeros_like(from_above), from_above)
    from_below = jnp.where(idx == n - 1, jnp.zeros_like(from_below), from_below)
    return jnp.concatenate([from_above, x, from_below], axis=0)


def sharded_row_sad(cur: jnp.ndarray, prev: jnp.ndarray, mesh: Mesh, yr: int,
                    axis: str = "slice") -> jnp.ndarray:
    """Demonstration/validation kernel: full-pel SAD volume of a frame whose rows are
    sharded across ``axis``, using a halo exchange for the +-YR search window.

    Returns ((2yr+1)**2, nby, nbx) identical to the single-chip computation."""
    h, w = cur.shape
    n = mesh.shape[axis]
    assert (h // 16) % n == 0, "macroblock rows must divide the mesh axis"

    def local(cur_l, prev_l):
        prev_h = exchange_halo(prev_l.astype(jnp.int32), yr, axis)
        prev_p = jnp.pad(prev_h, ((0, 0), (yr, yr)))
        c = cur_l.astype(jnp.int32)
        hl = cur_l.shape[0]
        outs = []
        for dy in range(-yr, yr + 1):
            for dx in range(-yr, yr + 1):
                win = jax.lax.dynamic_slice(prev_p, (yr + dy, yr + dx), (hl, w))
                d = jnp.abs(c - win)
                outs.append(d.reshape(hl // 16, 16, w // 16, 16).sum(axis=(1, 3)))
        return jnp.stack(outs)

    fn = jax.shard_map(local, mesh=mesh,
                       in_specs=(P(axis, None), P(axis, None)),
                       out_specs=P(None, axis, None))
    return fn(cur, prev)
