"""Slice-row (sequence/context-parallel) sharding of the FULL frame pipeline.

One frame's macroblock rows are sharded over a mesh axis; every stage runs on
the shard's own rows (SURVEY.md section 2.9 SP/CP axis):

* 4:2:0 subsampling - row pairs never straddle a 16-row shard boundary;
* motion estimation - the only cross-shard dependency: the previous frame's
  reconstruction halo (8 luma / 4 chroma rows each side) moves between
  devices with two ``lax.ppermute`` shifts (parallel/halo.py), the array
  analog of the RTL's +-YR-row reference window fetch
  (RTL/mpeg2encoder.v:1364-1373);
  frame-edge candidate masking uses GLOBAL row indices so shard boundaries
  are not mistaken for frame edges;
* transforms and reconstruction - per-macroblock, fully local;
* entropy - per-slice symbol rows are independent by construction (DC/MV
  predictor chains reset per slice, RTL:2781-2792); slice headers carry
  global row numbers; the GOP/picture header rows are packed outside the
  sharded region (they are ~100 bits);
* bit packing - per-row packing is local; the byte-aligned row payloads
  merge into the frame payload with the ordinary merge tree on the global
  (sharded) array view.

The output payload is BYTE-IDENTICAL to the single-chip encoder's: packing
is a per-row operation and merging byte-aligned rows is associative, so the
sharding is invisible in the stream (tests/test_parallel.py asserts equality
including the edge shards).
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.encoder import (
    DEFAULT_BUDGET_BPS,
    DEFAULT_FRAME_CAP,
    DEFAULT_ROW_CAP,
    transform_recon,
)
from ..ops import bitpack, colorspace, entropy, motion
from .halo import exchange_halo


def _make_local_step(nby: int, rows_l: int, *,
                     yr: int, ur: int, q_level: int,
                     row_cap: int, budget_bps: int, axis: str):
    """Per-shard frame step (this device's slice rows only): the body shared by
    the 1-D slice-sharded encoder and the 2-D stream x slice composition."""
    def local_step(y, u, v, py, pu, pv, i_frame, frame_no):
        # y/u/v/py: (H/nsh, W); pu/pv: (H/2/nsh, W/2)
        sh = jax.lax.axis_index(axis)
        first_row = sh * rows_l
        ys, us, vs = colorspace.subsample_420(y, u, v)
        py_h = exchange_halo(py, 8, axis)
        pu_h = exchange_halo(pu, 4, axis)
        pv_h = exchange_halo(pv, 4, axis)
        mr = motion.estimate_and_predict_local(
            ys, py_h, pu_h, pv_h, i_frame == 0, yr, ur,
            first_row, jnp.int32(nby))
        quant_zig, ry, ru, rv = transform_recon(ys, us, vs, mr, q_level)
        sym = entropy.symbolize_frame(
            quant_zig, mr.inter, mr.mvx, mr.mvy,
            i_frame, frame_no, q_level,
            first_row=first_row, include_headers=False)
        words, bits, ovf = bitpack.pack_slots(
            sym.slots, row_cap, budget_bps=budget_bps)
        return ry, ru, rv, words, bits, ovf.reshape(1)

    return local_step


def make_sharded_frame_encoder(
    mesh: Mesh, height: int, width: int, *,
    yr: int, ur: int, q_level: int,
    row_cap: int = DEFAULT_ROW_CAP, frame_cap: int = DEFAULT_FRAME_CAP,
    budget_bps: int = DEFAULT_BUDGET_BPS, axis: str = "slice",
):
    """Build a jitted slice-row-sharded single-frame encoder.

    Returns ``fn(y444, u444, v444, prev_y, prev_u, prev_v, i_frame, frame_no)
    -> (recon_y, recon_u, recon_v, fwords, fbits, overflow)`` with the frame
    planes sharded over ``axis`` on their row dimension (recon outputs keep
    that sharding for the next frame); the payload is byte-identical to
    models/encoder.encode_frame_core's.

    Overflow contract: if the returned ``overflow`` flag is set, the payload
    was truncated against ``row_cap``/``frame_cap``/``budget_bps`` and MUST
    NOT be shipped - re-encode the frame through the host-stitch retry path
    (models/encoder.Encoder handles this automatically; callers using this
    factory directly gather the per-MB symbols and stitch on host, as
    models/encoder.symbolize_frame_core + stitch_slots_host do).
    """
    nsh = mesh.shape[axis]
    nby = height // 16
    if nby % nsh != 0:
        raise ValueError(f"{nby} macroblock rows do not divide {nsh} shards")
    rows_l = nby // nsh
    local_step = _make_local_step(nby, rows_l, yr=yr, ur=ur,
                                  q_level=q_level, row_cap=row_cap,
                                  budget_bps=budget_bps, axis=axis)
    sharded = jax.shard_map(
        local_step, mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis, None),
                  P(axis, None), P(axis, None), P(axis, None), P(), P()),
        out_specs=(P(axis, None), P(axis, None), P(axis, None),
                   P(axis, None), P(axis), P(axis)),
    )

    @jax.jit
    def encode_frame(y444, u444, v444, prev_y, prev_u, prev_v,
                     i_frame, frame_no):
        ry, ru, rv, rows_w, rows_b, ovf_sh = sharded(
            y444, u444, v444, prev_y, prev_u, prev_v, i_frame, frame_no)
        fwords, fbits, overflow = _frame_tail(rows_w, rows_b, ovf_sh, i_frame,
                                              frame_no, row_cap, frame_cap)
        return ry, ru, rv, fwords, fbits, overflow

    return encode_frame


def _frame_tail(rows_w, rows_b, ovf_sh, i_frame, frame_no, row_cap, frame_cap):
    """Merge the sharded slice rows under the GOP/picture header rows (tiny,
    packed outside the sharded region) into one frame payload."""
    hc, hl = entropy._header_rows(i_frame, frame_no, 16)
    hw, hb, hovf = bitpack.pack_slots(entropy.pack_slot(hc, hl), row_cap)
    all_w = jnp.concatenate([hw, rows_w], axis=0)
    all_b = jnp.concatenate([hb, rows_b], axis=0)
    fwords, fbits = bitpack.merge_rows(all_w, all_b, frame_cap)
    overflow = ovf_sh.any() | hovf | (rows_b > 32 * row_cap).any() \
        | (fbits > 32 * frame_cap)
    return fwords, fbits, overflow


def sharded_frame_shardings(mesh: Mesh, axis: str = "slice"
                            ) -> Tuple[NamedSharding, NamedSharding]:
    """(plane sharding, replicated) for placing frame planes on the mesh."""
    return (NamedSharding(mesh, P(axis, None)), NamedSharding(mesh, P()))


def make_sharded_batch_encoder(
    mesh: Mesh, batch: int, height: int, width: int, *,
    yr: int, ur: int, q_level: int,
    row_cap: int = DEFAULT_ROW_CAP, frame_cap: int = DEFAULT_FRAME_CAP,
    budget_bps: int = DEFAULT_BUDGET_BPS,
    stream_axis: str = "stream", slice_axis: str = "slice",
):
    """2-D mesh composition: stream data-parallelism x slice-row sharding.

    A batch of independent streams is sharded over ``stream_axis`` (the
    embarrassingly parallel axis - zero collectives, SURVEY.md section 2.9 DP)
    while each frame's macroblock rows are simultaneously sharded over
    ``slice_axis`` (halo exchange, as make_sharded_frame_encoder).  This is
    the scale-out layout for many concurrent encodes on several devices:
    (streams x slice-shards) devices, with all communication confined to the
    slice axis.

    Returns ``fn(y444, u444, v444, prev_y, prev_u, prev_v, i_frame, frame_no)``
    over leading-batch arrays ((B, H, W) planes, (B,) scalars) ->
    ``(recon_y, recon_u, recon_v, fwords (B, frame_cap), fbits (B,),
    overflow (B,))``; each stream's payload is byte-identical to
    models/encoder.encode_frame_core's.

    Overflow contract: a set ``overflow[b]`` means stream ``b``'s payload was
    truncated against the caps and MUST NOT be shipped - re-encode that frame
    via the host-stitch retry path (see make_sharded_frame_encoder's note).
    """
    n_stream = mesh.shape[stream_axis]
    n_slice = mesh.shape[slice_axis]
    nby = height // 16
    if batch % n_stream != 0:
        raise ValueError(f"batch {batch} does not divide {n_stream} stream shards")
    if nby % n_slice != 0:
        raise ValueError(f"{nby} macroblock rows do not divide {n_slice} shards")
    rows_l = nby // n_slice
    local_step = _make_local_step(nby, rows_l, yr=yr, ur=ur,
                                  q_level=q_level, row_cap=row_cap,
                                  budget_bps=budget_bps, axis=slice_axis)
    pb = P(stream_axis, slice_axis, None)   # (B, rows, W) planes / (B, nby, cap) words
    ps = P(stream_axis)                     # (B,) per-stream scalars
    sharded = jax.shard_map(
        jax.vmap(local_step), mesh=mesh,
        in_specs=(pb, pb, pb, pb, pb, pb, ps, ps),
        out_specs=(pb, pb, pb, pb, P(stream_axis, slice_axis),
                   P(stream_axis, slice_axis)),
    )
    tail = jax.vmap(functools.partial(_frame_tail, row_cap=row_cap,
                                      frame_cap=frame_cap))

    @jax.jit
    def encode_frames(y444, u444, v444, prev_y, prev_u, prev_v,
                      i_frame, frame_no):
        ry, ru, rv, rows_w, rows_b, ovf_sh = sharded(
            y444, u444, v444, prev_y, prev_u, prev_v, i_frame, frame_no)
        fwords, fbits, overflow = tail(rows_w, rows_b, ovf_sh, i_frame, frame_no)
        return ry, ru, rv, fwords, fbits, overflow

    return encode_frames


def sharded_batch_shardings(mesh: Mesh, stream_axis: str = "stream",
                            slice_axis: str = "slice"
                            ) -> Tuple[NamedSharding, NamedSharding]:
    """(plane sharding, per-stream-scalar sharding) for the 2-D layout."""
    return (NamedSharding(mesh, P(stream_axis, slice_axis, None)),
            NamedSharding(mesh, P(stream_axis)))
