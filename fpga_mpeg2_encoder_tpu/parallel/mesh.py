"""Device-mesh helpers.

The reference is a single FPGA with zero external memory (README.md:24); its only
inter-unit parallelism is its ~20-stage pipeline (SURVEY.md section 2.9).  The
device scaling axes are:

* ``stream`` - data parallelism over independent video streams (embarrassingly
  parallel, preserves bit-exactness trivially);
* ``slice``  - optional sequence-parallel sharding of one frame's slice rows with a
  +-YR-row halo exchange of the reconstructed reference (parallel/halo.py).

The communication substrate is XLA collectives via jax.lax (NCCL on GPUs) -
there is no transport to build (SURVEY.md section 5).
"""
from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None, axis: str = "stream") -> Mesh:
    """1-D mesh over the first ``n_devices`` local devices."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def make_mesh2d(n_stream: int, n_slice: int,
                axes: tuple = ("stream", "slice")) -> Mesh:
    """2-D mesh: independent streams on the first axis (DP, no collectives),
    slice-row shards on the second (halo exchange).  Cards joined all to all
    (NVLink) reach each other at one rate, so the layout follows the
    algorithm alone: the slice axis carries the only communication."""
    devs = jax.devices()
    need = n_stream * n_slice
    if len(devs) < need:
        raise ValueError(f"need {need} devices, have {len(devs)}")
    return Mesh(np.array(devs[:need]).reshape(n_stream, n_slice), axes)


def stream_sharding(mesh: Mesh, axis: str = "stream") -> NamedSharding:
    """Shard the leading (stream-batch) dimension; replicate the rest."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
