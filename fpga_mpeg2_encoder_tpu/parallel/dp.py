"""Data-parallel multi-stream encoding: a batch of independent video streams sharded
over the ``stream`` mesh axis.

This is the device equivalent of deploying N copies of the reference IP (SURVEY.md
section 2.9 / BASELINE config 5: "Batched 8-stream 1080p ... per-chip stream
isolation").  Streams never communicate, so the jitted program contains zero
collectives and per-stream output stays bit-exact regardless of batch size or mesh
shape.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from ..config import EncoderConfig, SequenceConfig
from ..core.bitstream import BitWriter, sequence_header_chunks, SEQUENCE_END_CHUNKS
from ..models.encoder import (
    DEFAULT_BUDGET_BPS,
    DEFAULT_FRAME_CAP,
    DEFAULT_ROW_CAP,
    encode_frame_core,
    words_to_bytes,
)
from ..ops import bitpack, entropy
from .mesh import make_mesh, stream_sharding


@functools.partial(
    jax.jit,
    static_argnames=("yr", "ur", "q_level", "row_cap", "frame_cap", "budget_bps"),
)
def encode_frames_batched(
    y444, u444, v444,            # (B, H, W) uint8
    prev_y, prev_u, prev_v,      # (B, H, W) / (B, H/2, W/2)
    i_frame, frame_no,           # (B,) int32
    *, yr: int, ur: int, q_level: int, row_cap: int, frame_cap: int,
    budget_bps: int = DEFAULT_BUDGET_BPS,
):
    f = functools.partial(encode_frame_core, yr=yr, ur=ur, q_level=q_level,
                          row_cap=row_cap, frame_cap=frame_cap,
                          budget_bps=budget_bps)
    return jax.vmap(f)(y444, u444, v444, prev_y, prev_u, prev_v, i_frame, frame_no)


@functools.partial(
    jax.jit,
    static_argnames=("yr", "ur", "q_level", "row_cap", "frame_cap", "seq_cap",
                     "budget_bps", "unroll"),
)
def encode_gops_batched(
    frames_y, frames_u, frames_v,   # (B, F, H, W) uint8
    prev_y, prev_u, prev_v,         # (B, ...)
    i_frame0, frame_no0,            # (B,)
    pframes_count,                  # (B,)
    *, yr: int, ur: int, q_level: int, row_cap: int, frame_cap: int, seq_cap: int,
    budget_bps: int = DEFAULT_BUDGET_BPS, unroll: int = 1,
):
    """Batched device-resident multi-frame encode: lax.scan over frames of a
    vmapped per-frame step, with the per-stream payload appends OUTSIDE the
    vmap (bitpack.append_bitstrings_batched).

    This is deliberately NOT vmap(encode_gop_scan_core): under vmap the
    sequence-append's dynamic slices become gather/scatter over the (B,
    seq_cap) buffer with per-stream offsets.  The scan-of-vmap form keeps
    every per-frame stage batched and does the B appends as static-row
    scalar-offset slice updates.

    ``unroll`` encodes that many frames per scan step (bit-identical; see
    encode_gop_scan_core) - lets XLA overlap one frame's entropy tail with
    the next frame's subsample/ME front.  Falls back to 1 when the frame
    count is not divisible.

    Outputs match the previous vmapped form exactly: frame_bits/frame_ifs
    come back as (B, F)."""
    nb, f = frames_y.shape[:2]
    if f % max(unroll, 1) != 0:
        unroll = 1
    fenc = jax.vmap(functools.partial(
        encode_frame_core, yr=yr, ur=ur, q_level=q_level, row_cap=row_cap,
        frame_cap=frame_cap, budget_bps=budget_bps))

    def step(carry, t):
        py, pu, pv, seq_w, seq_b, i_f, fno, ovf = carry
        yy = jax.lax.dynamic_index_in_dim(frames_y, t, axis=1, keepdims=False)
        uu = jax.lax.dynamic_index_in_dim(frames_u, t, axis=1, keepdims=False)
        vv = jax.lax.dynamic_index_in_dim(frames_v, t, axis=1, keepdims=False)
        ry, ru, rv, fw, fb, o = fenc(yy, uu, vv, py, pu, pv, i_f, fno)
        seq_w, seq_b = bitpack.append_bitstrings_batched(seq_w, seq_b, fw, fb)
        i_f_next = jnp.where(i_f >= pframes_count, 0, i_f + 1)
        return (ry, ru, rv, seq_w, seq_b, i_f_next, fno + 1, ovf | o), fb, i_f

    def body(carry, t0):
        fbs, ifs = [], []
        for k in range(unroll):
            carry, fb, i_f = step(carry, t0 + k)
            fbs.append(fb)
            ifs.append(i_f)
        if unroll <= 1:
            return carry, (fbs[0], ifs[0])
        return carry, (jnp.stack(fbs), jnp.stack(ifs))

    # guard margin per the append_bitstring sizing contract (frame payloads
    # are at most frame_cap words wide; overflow still checked vs seq_cap)
    seq_w0 = jnp.zeros((nb, seq_cap + frame_cap + 1), jnp.uint32)
    carry0 = (prev_y, prev_u, prev_v, seq_w0, jnp.zeros((nb,), jnp.int32),
              i_frame0, frame_no0, jnp.zeros((nb,), jnp.bool_))
    carry, (frame_bits, frame_ifs) = jax.lax.scan(
        body, carry0, jnp.arange(0, f, unroll, dtype=jnp.int32),
        length=f // unroll)
    if unroll > 1:
        # (steps, unroll, B) -> (f, B)
        frame_bits = frame_bits.reshape(f, nb)
        frame_ifs = frame_ifs.reshape(f, nb)
    py, pu, pv, seq_w, seq_b, i_f, fno, ovf = carry
    ovf = ovf | (seq_b > 32 * seq_cap)
    return (py, pu, pv, seq_w, seq_b, i_f, fno, ovf,
            frame_bits.T, frame_ifs.T)


class BatchEncoder:
    """Encode a batch of same-sized streams concurrently.

    Each stream keeps its own GOP index, timecode and byte assembly (host side);
    the device step is one SPMD program over the sharded batch.  ``push_frames``
    steps one frame per stream; ``push_chunks`` runs a device-resident scan over
    several frames per stream (the high-throughput path).
    """

    def __init__(self, config: EncoderConfig, seq: SequenceConfig,
                 batch: int, mesh: Optional[Mesh] = None,
                 row_cap: int = DEFAULT_ROW_CAP, frame_cap: int = DEFAULT_FRAME_CAP):
        if mesh is None and len(jax.devices()) > 1:
            n = len(jax.devices())
            mesh = make_mesh(n if batch % n == 0 else 1)
        self.config = config
        self.seq = seq.validate(config)
        self.batch = batch
        self.mesh = mesh
        self.row_cap = row_cap
        self.frame_cap = frame_cap
        self._sharding = stream_sharding(mesh) if mesh is not None else None
        h, w = self.seq.height, self.seq.width
        self._prev = (self._put(np.zeros((batch, h, w), np.uint8)),
                      self._put(np.zeros((batch, h // 2, w // 2), np.uint8)),
                      self._put(np.zeros((batch, h // 2, w // 2), np.uint8)))
        self._i_frame = np.zeros(batch, np.int32)
        self._frame_no = np.zeros(batch, np.int32)
        bw = BitWriter()
        bw.put_chunks(sequence_header_chunks(self.seq.width, self.seq.height))
        hdr = bw.to_bytes_aligned()
        self._payload: List[List[bytes]] = [[hdr] for _ in range(batch)]

    def _put(self, arr):
        if self._sharding is not None:
            return jax.device_put(arr, self._sharding)
        return jnp.asarray(arr)

    def _kw(self):
        return dict(yr=self.config.yr, ur=self.config.ur,
                    q_level=self.config.q_level)

    def push_frames(self, frames: List[Tuple[np.ndarray, np.ndarray, np.ndarray]]):
        """One frame per stream (YUV 4:4:4 uint8 planes)."""
        assert len(frames) == self.batch
        args = (self._put(np.stack([f[0] for f in frames])),
                self._put(np.stack([f[1] for f in frames])),
                self._put(np.stack([f[2] for f in frames])),
                *self._prev, self._put(self._i_frame), self._put(self._frame_no))
        ry, ru, rv, fw, fb, ovf = encode_frames_batched(
            *args, **self._kw(), row_cap=self.row_cap, frame_cap=self.frame_cap)
        if bool(np.asarray(ovf).any()):
            ry, ru, rv, fw, fb, ovf = encode_frames_batched(
                *args, **self._kw(),
                row_cap=entropy.slice_words_bound(self.seq.mb_cols),
                frame_cap=entropy.frame_words_bound(self.seq.mb_cols,
                                                    self.seq.mb_rows),
                budget_bps=0)
            assert not bool(np.asarray(ovf).any()), \
                "frame exceeded the analytic worst-case buffer bound"
        self._prev = (ry, ru, rv)
        fw_h, fb_h = np.asarray(fw), np.asarray(fb)
        for b in range(self.batch):
            self._payload[b].append(words_to_bytes(fw_h[b], int(fb_h[b])))
        self._i_frame = np.where(self._i_frame >= self.seq.pframes_count,
                                 0, self._i_frame + 1).astype(np.int32)
        self._frame_no += 1

    def push_chunks(self, chunks: List[List[Tuple[np.ndarray, np.ndarray, np.ndarray]]]):
        """Several frames per stream, encoded by one batched device scan."""
        assert len(chunks) == self.batch
        n_frames = len(chunks[0])
        fy = self._put(np.stack([np.stack([f[0] for f in c]) for c in chunks]))
        fu = self._put(np.stack([np.stack([f[1] for f in c]) for c in chunks]))
        fv = self._put(np.stack([np.stack([f[2] for f in c]) for c in chunks]))
        pf = self._put(np.full(self.batch, self.seq.pframes_count, np.int32))
        args = (fy, fu, fv, *self._prev,
                self._put(self._i_frame), self._put(self._frame_no), pf)
        caps = dict(row_cap=self.row_cap, frame_cap=self.frame_cap,
                    seq_cap=self.frame_cap * max(1, n_frames // 4))
        ry, ru, rv, sw, sb, i_f, fno, ovf, _, _ = encode_gops_batched(
            *args, **self._kw(), **caps)
        if bool(np.asarray(ovf).any()):
            caps = dict(
                row_cap=entropy.slice_words_bound(self.seq.mb_cols),
                frame_cap=entropy.frame_words_bound(self.seq.mb_cols, self.seq.mb_rows),
                seq_cap=entropy.frame_words_bound(self.seq.mb_cols,
                                                  self.seq.mb_rows) * n_frames,
                budget_bps=0)
            ry, ru, rv, sw, sb, i_f, fno, ovf, _, _ = encode_gops_batched(
                *args, **self._kw(), **caps)
            assert not bool(np.asarray(ovf).any()), \
                "chunk exceeded the analytic worst-case buffer bound"
        self._prev = (ry, ru, rv)
        sw_h, sb_h = np.asarray(sw), np.asarray(sb)
        for b in range(self.batch):
            self._payload[b].append(words_to_bytes(sw_h[b], int(sb_h[b])))
        self._i_frame = np.asarray(i_f)
        self._frame_no = np.asarray(fno)

    def finish(self) -> List[bytes]:
        out = []
        bw = BitWriter()
        bw.put_chunks(SEQUENCE_END_CHUNKS)
        end = bw.to_bytes_aligned()
        for b in range(self.batch):
            data = b"".join(self._payload[b]) + end
            target = (len(data) // 32 + 1) * 32
            out.append(data + b"\x00" * (target - len(data)))
        self._payload = [[b""] for _ in range(self.batch)]
        return out
