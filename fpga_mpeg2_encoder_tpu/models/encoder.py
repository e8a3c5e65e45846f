"""The encoder: jitted per-frame pipeline + sequence runtime.

Pipeline per frame (one XLA program, all macroblocks batched):
  4:2:0 subsample -> motion estimation + prediction -> residual -> exact 64x64 DCT
  matmul -> quantise -> dequantise -> Chen-Wang integer IDCT -> reconstruct ->
  zigzag/VLC symbolise (one-hot table lookups) -> barrel-merge bit packing
  into ONE byte-aligned frame payload, GOP/picture headers included (device-side
  timecode).  The host only prepends the per-sequence header bytes and appends the
  end code - the bitstream never touches the host until it is final bytes.

The only sequential dependency is frame order (P-frames predict from the previous
frame's reconstruction, the loop the reference closes through mem_ref_Y/UV,
RTL/mpeg2encoder.v:2418-2424 -> 1387-1390); here it is an explicit prev/cur buffer
swap, or a lax.scan carry in the device-resident multi-frame path.

Packing buffers are sized by a configurable budget (default 256 KB/frame) with
exact overflow detection; an overflowing frame is transparently re-encoded with
worst-case buffers (a frame cannot exceed ~1.2 KB per macroblock even with every
coefficient escape-coded).
"""
from __future__ import annotations

import time
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import EncoderConfig, SequenceConfig
from ..runtime.state import EncoderState
from ..utils.logging import SequenceStats
from ..core.bitstream import (
    BitWriter,
    sequence_header_chunks,
    SEQUENCE_END_CHUNKS,
)
from ..ops import bitpack, colorspace, dct, entropy, motion

DEFAULT_ROW_CAP = 2048       # words/slice budget (8 KB)
DEFAULT_FRAME_CAP = 65536    # words/frame budget (256 KB)
DEFAULT_BUDGET_BPS = 8       # pack-tree statistical level budget, bits/symbol-slot
                             # (0 = worst-case widths; see bitpack.pack_symbols)

def _blockify(plane: jnp.ndarray, bs: int) -> jnp.ndarray:
    h, w = plane.shape
    return plane.reshape(h // bs, bs, w // bs, bs).transpose(0, 2, 1, 3)


def _unblockify(blocks: jnp.ndarray) -> jnp.ndarray:
    nby, nbx, bs, _ = blocks.shape
    return blocks.transpose(0, 2, 1, 3).reshape(nby * bs, nbx * bs)


def _tiles(yb: jnp.ndarray, ub: jnp.ndarray, vb: jnp.ndarray) -> jnp.ndarray:
    """(nby,nbx,16,16)+(nby,nbx,8,8)x2 -> (nby,nbx,6,64) in tile order Y00..Y11,U,V."""
    nby, nbx = yb.shape[:2]
    yt = yb.reshape(nby, nbx, 2, 8, 2, 8).transpose(0, 1, 2, 4, 3, 5).reshape(nby, nbx, 4, 64)
    return jnp.concatenate(
        [yt, ub.reshape(nby, nbx, 1, 64), vb.reshape(nby, nbx, 1, 64)], axis=2)


def _untile_y(t4: jnp.ndarray) -> jnp.ndarray:
    nby, nbx = t4.shape[:2]
    return t4.reshape(nby, nbx, 2, 2, 8, 8).transpose(0, 1, 2, 4, 3, 5).reshape(nby, nbx, 16, 16)


def transform_recon(y, u, v, mr: motion.MotionResult, q_level: int):
    """Residual -> DCT -> quantise -> dequantise -> IDCT -> reconstruct for
    every macroblock of a band of 4:2:0 planes.  Returns (quant_zig
    (nby, nbx, 6, 64) int32 in zig-zag order, recon_y, recon_u, recon_v)."""
    nby, nbx = mr.inter.shape
    cur_t = _tiles(_blockify(y.astype(jnp.int32), 16),
                   _blockify(u.astype(jnp.int32), 8),
                   _blockify(v.astype(jnp.int32), 8))
    pred_t = _tiles(mr.pred_y, mr.pred_u, mr.pred_v)

    # coefficient-major layout (64, N): one full-width vector per coefficient
    resid = (cur_t - pred_t).reshape(-1, 64).T
    inter_t = jnp.repeat(mr.inter.reshape(-1), 6)
    q = dct.quantize(dct.fdct(resid), inter_t, q_level)
    rres = dct.idct(dct.dequantize(q, inter_t, q_level))
    recon_t = jnp.clip(pred_t.reshape(-1, 64).T + rres, 0, 255) \
        .T.reshape(nby, nbx, 6, 64)

    recon_y = _unblockify(_untile_y(recon_t[:, :, :4])).astype(jnp.uint8)
    recon_u = _unblockify(recon_t[:, :, 4].reshape(nby, nbx, 8, 8)).astype(jnp.uint8)
    recon_v = _unblockify(recon_t[:, :, 5].reshape(nby, nbx, 8, 8)).astype(jnp.uint8)
    q_zig = q[entropy._ZIG_INV_NP, :]     # zig-zag scan: row permutation
    return q_zig.T.reshape(nby, nbx, 6, 64), recon_y, recon_u, recon_v


def symbolize_frame_core(
    y444: jnp.ndarray, u444: jnp.ndarray, v444: jnp.ndarray,   # (H, W) uint8
    prev_y: jnp.ndarray, prev_u: jnp.ndarray, prev_v: jnp.ndarray,
    i_frame: jnp.ndarray,                                      # scalar int32
    frame_no: jnp.ndarray,                                     # scalar int32 (timecode)
    *, yr: int, ur: int, q_level: int,
):
    """The pipeline up to symbolisation: returns (recon_y, recon_u, recon_v,
    slots (2 + nby, S) uint32).  On its own it is the budget-overflow retry
    path: packing the slot grid on the HOST (utils/native.pack_symbols_host,
    C++) needs no budget caps and no worst-case device buffers, so an
    overflowing frame costs one extra device step + a native stitch instead
    of a second compiled program with ~36K-word buffers."""
    y, u, v = colorspace.subsample_420(y444, u444, v444)
    mr = motion.estimate_and_predict(y, u, v, prev_y, prev_u, prev_v,
                                     i_frame == 0, yr, ur)
    quant_zig, recon_y, recon_u, recon_v = transform_recon(y, u, v, mr, q_level)
    sym = entropy.symbolize_frame(quant_zig, mr.inter, mr.mvx, mr.mvy,
                                  i_frame, frame_no, q_level)
    return recon_y, recon_u, recon_v, sym.slots


symbolize_frame_device = jax.jit(
    symbolize_frame_core, static_argnames=("yr", "ur", "q_level"))


def encode_frame_core(
    y444: jnp.ndarray, u444: jnp.ndarray, v444: jnp.ndarray,   # (H, W) uint8
    prev_y: jnp.ndarray, prev_u: jnp.ndarray, prev_v: jnp.ndarray,
    i_frame: jnp.ndarray,                                      # scalar int32
    frame_no: jnp.ndarray,                                     # scalar int32 (timecode)
    *, yr: int, ur: int, q_level: int, row_cap: int, frame_cap: int,
    budget_bps: int = DEFAULT_BUDGET_BPS,
):
    """Un-jitted single-frame pipeline.  Returns (recon_y, recon_u, recon_v,
    frame_words (frame_cap,) uint32, frame_bits, overflow flag)."""
    recon_y, recon_u, recon_v, slots = symbolize_frame_core(
        y444, u444, v444, prev_y, prev_u, prev_v, i_frame, frame_no,
        yr=yr, ur=ur, q_level=q_level)
    row_words, row_bits, pack_ovf = bitpack.pack_slots(
        slots, row_cap, budget_bps=budget_bps)
    fwords, fbits = bitpack.merge_rows(row_words, row_bits, frame_cap)
    overflow = pack_ovf | (row_bits > 32 * row_cap).any() | (fbits > 32 * frame_cap)
    return recon_y, recon_u, recon_v, fwords, fbits, overflow


encode_frame_device = jax.jit(
    encode_frame_core,
    static_argnames=("yr", "ur", "q_level", "row_cap", "frame_cap", "budget_bps"),
)


def stitch_slots_host(slots: np.ndarray) -> bytes:
    """Pack a frame's (R, S) packed slot grid on the host (C++ stitcher, with
    a NumPy/BitWriter fallback): rows are byte-aligned, exactly like the
    device merge tree, so the payload is byte-identical to the device path."""
    from ..ops.entropy import SLOT_CODE_MASK, SLOT_LEN_SHIFT
    from ..utils import native
    r, s = slots.shape
    flat = slots.reshape(-1)
    codes = (flat & SLOT_CODE_MASK).astype(np.uint32)
    lens = (flat >> SLOT_LEN_SHIFT).astype(np.int32)
    align = np.zeros(r * s, np.uint8)
    align[::s] = 1                      # byte-align at every row start
    data, _bits = native.pack_symbols_host(codes, lens, align)
    return data


def encode_gop_scan_core(
    frames_y: jnp.ndarray, frames_u: jnp.ndarray, frames_v: jnp.ndarray,  # (F, H, W)
    prev_y: jnp.ndarray, prev_u: jnp.ndarray, prev_v: jnp.ndarray,
    i_frame0: jnp.ndarray, frame_no0: jnp.ndarray,
    pframes_count: jnp.ndarray,
    *, yr: int, ur: int, q_level: int, row_cap: int, frame_cap: int, seq_cap: int,
    budget_bps: int = DEFAULT_BUDGET_BPS, unroll: int = 1,
):
    """Device-resident multi-frame encode: lax.scan over frames, accumulating the
    packed payload in one HBM buffer.  One upload of the frame stack, one download
    of the payload - the host link is touched twice per chunk, not per frame.

    ``unroll`` > 1 encodes that many frames per scan step (bit-identical: the
    same per-frame ops in the same order).  Only the recon carry is sequential
    across frames, so the XLA scheduler can overlap frame n's entropy/pack
    tail with frame n+1's subsample/ME front - worth a few percent at small
    geometries where per-step overhead dominates.  Falls back to 1 when the
    frame count is not divisible."""
    f = frames_y.shape[0]
    if f % max(unroll, 1) != 0:
        unroll = 1

    def step(carry, yy, uu, vv):
        py, pu, pv, seq_w, seq_b, i_f, fno, ovf = carry
        ry, ru, rv, fw, fb, o = encode_frame_core(
            yy, uu, vv, py, pu, pv, i_f, fno,
            yr=yr, ur=ur, q_level=q_level, row_cap=row_cap, frame_cap=frame_cap,
            budget_bps=budget_bps)
        seq_w, seq_b = bitpack.append_bitstring(seq_w, seq_b, fw, fb)
        i_f_next = jnp.where(i_f >= pframes_count, 0, i_f + 1)
        return (ry, ru, rv, seq_w, seq_b, i_f_next, fno + 1, ovf | o), fb, i_f

    if unroll <= 1:
        def body(carry, xs):
            carry, fb, i_f = step(carry, *xs)
            return carry, (fb, i_f)
        xs = (frames_y, frames_u, frames_v)
        steps = f
    else:
        def body(carry, xs):
            yy, uu, vv = xs
            fbs, ifs = [], []
            for k in range(unroll):
                carry, fb, i_f = step(carry, yy[k], uu[k], vv[k])
                fbs.append(fb)
                ifs.append(i_f)
            return carry, (jnp.stack(fbs), jnp.stack(ifs))
        u_shape = (f // unroll, unroll)
        xs = (frames_y.reshape(u_shape + frames_y.shape[1:]),
              frames_u.reshape(u_shape + frames_u.shape[1:]),
              frames_v.reshape(u_shape + frames_v.shape[1:]))
        steps = f // unroll

    # guard margin per the append_bitstring sizing contract: the frame-payload
    # width is at most frame_cap words, so seq_cap + frame_cap + 1 words
    # guarantee the append window always fits; overflow is still checked
    # against the logical seq_cap below
    seq_w0 = jnp.zeros((seq_cap + frame_cap + 1,), jnp.uint32)
    carry0 = (prev_y, prev_u, prev_v, seq_w0, jnp.int32(0),
              i_frame0, frame_no0, jnp.asarray(False))
    carry, (frame_bits, frame_ifs) = jax.lax.scan(body, carry0, xs, length=steps)
    if unroll > 1:
        frame_bits = frame_bits.reshape(f)
        frame_ifs = frame_ifs.reshape(f)
    py, pu, pv, seq_w, seq_b, i_f, fno, ovf = carry
    ovf = ovf | (seq_b > 32 * seq_cap)
    return py, pu, pv, seq_w, seq_b, i_f, fno, ovf, frame_bits, frame_ifs


encode_gop_scan = jax.jit(
    encode_gop_scan_core,
    static_argnames=("yr", "ur", "q_level", "row_cap", "frame_cap", "seq_cap",
                     "budget_bps", "unroll"),
)


def words_to_bytes(words: np.ndarray, nbits: int) -> bytes:
    return words.astype(">u4").tobytes()[: (nbits + 7) // 8]


class Encoder:
    """MPEG-2 encoder running on the default JAX device.

    API mirrors the reference module contract (RTL/mpeg2encoder.v:10-38):
    construction-time quality/range knobs, per-sequence size/GOP configuration,
    multi-sequence reuse after each ``encode``/``finish``.

    Two operating modes:
    * streaming (``start_sequence``/``push_frame``/``finish``): one device step per
      frame, payload bytes downloaded per frame;
    * chunked (``encode`` with ``chunk_frames > 1``): frames are staged on device
      and encoded by a lax.scan, with one payload download per chunk - the
      high-throughput path.
    """

    def __init__(self, config: EncoderConfig = EncoderConfig(),
                 row_cap: int = DEFAULT_ROW_CAP, frame_cap: int = DEFAULT_FRAME_CAP):
        self.config = config
        self.row_cap = row_cap
        self.frame_cap = frame_cap
        self._seq: Optional[SequenceConfig] = None
        self._reset_sequence_state()

    # ------------------------------------------------------------------ one-shot
    def encode(
        self,
        frames444: List[Tuple[np.ndarray, np.ndarray, np.ndarray]],
        width: int,
        height: int,
        pframes_count: int = 23,
        stop_mode: str = "clean",
        partial_groups: int = 0,
        chunk_frames: int = 1,
    ) -> bytes:
        """Encode a full sequence of YUV 4:4:4 frames to an MPEG-2 elementary stream."""
        self.start_sequence(SequenceConfig(width, height, pframes_count))
        last = len(frames444) - 1
        if chunk_frames > 1:
            fixed = list(frames444)
            if stop_mode == "partial":
                fixed[last] = self._pad_partial(fixed[last], partial_groups)
            for i in range(0, len(fixed), chunk_frames):
                self.push_chunk(fixed[i:i + chunk_frames])
            return self.finish()
        for idx, f in enumerate(frames444):
            if stop_mode == "partial" and idx == last:
                self.push_frame(*self._pad_partial(f, partial_groups))
            else:
                self.push_frame(*f)
        return self.finish(stop_mode=stop_mode)

    # ---------------------------------------------------------------- streaming
    def start_sequence(self, seq: SequenceConfig) -> None:
        if self._seq is not None:
            raise RuntimeError("sequence already active; call finish() first")
        seq = seq.validate(self.config)
        self._seq = seq
        bw = BitWriter()
        bw.put_chunks(sequence_header_chunks(seq.width, seq.height))
        self._payload: List[bytes] = [bw.to_bytes_aligned()]
        self._i_frame = 0
        self._frame_no = 0
        self._prev = None
        self.stats = SequenceStats(width=seq.width, height=seq.height)

    # ------------------------------------------------------------- checkpointing
    def get_state(self) -> "EncoderState":
        """Snapshot the complete inter-frame state (SURVEY.md section 5): recon
        reference frame, GOP index, timecode counter, emitted bytes."""
        seq = self._require_seq()
        prev = None if self._prev is None else tuple(np.asarray(p) for p in self._prev)
        return EncoderState(
            width=seq.width, height=seq.height, pframes_count=seq.pframes_count,
            i_frame=self._i_frame, frame_no=self._frame_no,
            recon_y=None if prev is None else prev[0],
            recon_u=None if prev is None else prev[1],
            recon_v=None if prev is None else prev[2],
            payload=b"".join(self._payload))

    def set_state(self, state: "EncoderState") -> None:
        """Resume a sequence from a checkpoint; continues bit-exactly."""
        if self._seq is not None:
            raise RuntimeError("sequence already active; call finish() first")
        self._seq = SequenceConfig(state.width, state.height,
                                   state.pframes_count).validate(self.config)
        self._payload = [state.payload]
        self._i_frame = state.i_frame
        self._frame_no = state.frame_no
        if state.recon_y is None:
            self._prev = None
        else:
            self._prev = (jnp.asarray(state.recon_y), jnp.asarray(state.recon_u),
                          jnp.asarray(state.recon_v))
        self.stats = SequenceStats(width=state.width, height=state.height)

    def _zero_prev(self):
        seq = self._seq
        z = np.zeros((seq.height, seq.width), np.uint8)
        zc = np.zeros((seq.height // 2, seq.width // 2), np.uint8)
        return (jnp.asarray(z), jnp.asarray(zc), jnp.asarray(zc))

    def _check_frame_shape(self, y, seq) -> None:
        """Reject frames that don't match the LATCHED sequence geometry with a
        clear error (instead of an opaque scan carry-type mismatch).  The
        latched size may be smaller than requested: SequenceConfig.validate
        clamps to the EncoderConfig's max geometry like the RTL does
        (RTL/mpeg2encoder.v:985-991)."""
        if y.shape != (seq.height, seq.width):
            hint = ""
            mw, mh = self.config.max_width, self.config.max_height
            if y.shape[0] > mh or y.shape[1] > mw:
                hint = (f"; frame exceeds this EncoderConfig's max geometry "
                        f"{mw}x{mh} (xl={self.config.xl}, yl={self.config.yl})"
                        f" - the requested sequence size was clamped")
            raise ValueError(
                f"frame shape {y.shape} != latched sequence geometry "
                f"{(seq.height, seq.width)}{hint}")

    def push_frame(self, y: np.ndarray, u: np.ndarray, v: np.ndarray) -> None:
        """Feed one YUV 4:4:4 frame (uint8 (H, W) planes)."""
        t_start = time.perf_counter()
        seq = self._require_seq()
        self._check_frame_shape(y, seq)
        if self._prev is None:
            self._prev = self._zero_prev()
        kw = dict(yr=self.config.yr, ur=self.config.ur, q_level=self.config.q_level)
        args = (jnp.asarray(y), jnp.asarray(u), jnp.asarray(v), *self._prev,
                jnp.int32(self._i_frame), jnp.int32(self._frame_no))
        ry, ru, rv, fw, fb, ovf = encode_frame_device(
            *args, **kw, row_cap=self.row_cap, frame_cap=self.frame_cap)
        if bool(ovf):
            # rare: frame exceeded the budget caps; redo via the symbols-only
            # device step + host-side C++ stitch (no caps involved)
            ry, ru, rv, payload = self._encode_frame_hoststitch(args, kw)
            self._prev = (ry, ru, rv)
            nbits = len(payload) * 8
            self._payload.append(payload)
        else:
            self._prev = (ry, ru, rv)
            nbits = int(fb)
            self._payload.append(words_to_bytes(np.asarray(fw), nbits))
        self.stats.add(index=self._frame_no, i_frame=self._i_frame, bits=nbits,
                       wall_s=time.perf_counter() - t_start)
        self._i_frame = 0 if self._i_frame >= seq.pframes_count else self._i_frame + 1
        self._frame_no += 1

    def push_chunk(self, frames: List[Tuple[np.ndarray, np.ndarray, np.ndarray]]
                   ) -> None:
        """Feed several frames at once; encoded by one device-resident scan."""
        seq = self._require_seq()
        for f in frames:
            self._check_frame_shape(f[0], seq)
        if self._prev is None:
            self._prev = self._zero_prev()
        fy = jnp.asarray(np.stack([f[0] for f in frames]))
        fu = jnp.asarray(np.stack([f[1] for f in frames]))
        fv = jnp.asarray(np.stack([f[2] for f in frames]))
        kw = dict(yr=self.config.yr, ur=self.config.ur, q_level=self.config.q_level)
        caps = dict(row_cap=self.row_cap, frame_cap=self.frame_cap,
                    seq_cap=self.frame_cap * max(1, len(frames) // 4))
        args = (fy, fu, fv, *self._prev, jnp.int32(self._i_frame),
                jnp.int32(self._frame_no), jnp.int32(seq.pframes_count))
        ry, ru, rv, sw, sb, i_f, fno, ovf, fbits, fifs = encode_gop_scan(
            *args, **kw, **caps)
        if bool(ovf):
            # rare: some frame exceeded the budget caps; redo the chunk frame
            # by frame through the symbols-only device step + host C++ stitch
            # (byte-identical, no worst-case device buffers)
            prev = self._prev
            for k, (y, u, v) in enumerate(frames):
                fargs = (jnp.asarray(y), jnp.asarray(u), jnp.asarray(v), *prev,
                         jnp.int32(self._i_frame), jnp.int32(self._frame_no))
                pry, pru, prv, payload = self._encode_frame_hoststitch(fargs, kw)
                prev = (pry, pru, prv)
                self._payload.append(payload)
                self.stats.add(index=self._frame_no, i_frame=self._i_frame,
                               bits=len(payload) * 8, wall_s=0.0)
                self._i_frame = 0 if self._i_frame >= seq.pframes_count \
                    else self._i_frame + 1
                self._frame_no += 1
            self._prev = prev
            return
        self._prev = (ry, ru, rv)
        chunk_bits = int(sb)
        self._payload.append(words_to_bytes(np.asarray(sw), chunk_bits))
        fbits_h, fifs_h = np.asarray(fbits), np.asarray(fifs)
        for k in range(len(frames)):
            self.stats.add(index=self._frame_no + k, i_frame=int(fifs_h[k]),
                           bits=int(fbits_h[k]), wall_s=0.0)
        self._i_frame = int(i_f)
        self._frame_no = int(fno)

    def _encode_frame_hoststitch(self, args, kw):
        """Symbols-only device step + host C++ stitch (overflow retry path)."""
        ry, ru, rv, slots = symbolize_frame_device(*args, **kw)
        return ry, ru, rv, stitch_slots_host(np.asarray(slots))

    def finish(self, stop_mode: str = "clean") -> bytes:
        """End the sequence (i_sequence_stop semantics) and return the stream.

        'clean' and 'coincident' produce identical streams: the RTL's raster
        counters index the group accepted THIS cycle, so stop asserted on the
        last pixel cycle finds the frame complete and pads nothing
        (RTL:1048-1058, 1070-1079).  Mid-frame stops are expressed by pushing a
        partially-fed frame (``encode(stop_mode='partial')``)."""
        self._require_seq()
        bw = BitWriter()
        bw.put_chunks(SEQUENCE_END_CHUNKS)
        self._payload.append(bw.to_bytes_aligned())
        data = b"".join(self._payload)
        target = (len(data) // 32 + 1) * 32
        data = data + b"\x00" * (target - len(data))
        self._seq = None
        self._reset_sequence_state()
        return data

    # ----------------------------------------------------------------- internals
    def _reset_sequence_state(self) -> None:
        self._payload = []
        self._prev = None
        self._i_frame = 0
        self._frame_no = 0

    def _require_seq(self) -> SequenceConfig:
        if self._seq is None:
            raise RuntimeError("no active sequence; call start_sequence() first")
        return self._seq

    def _pad_partial(self, frame, partial_groups: int):
        if partial_groups < 1:
            raise ValueError("partial_groups must be >= 1 (SEQ_ENDING is only "
                             "reachable after a group was accepted, RTL:1081-1093)")
        seq = self._require_seq()
        h, w = seq.height, seq.width
        y, u, v = (np.array(p, copy=True) for p in frame)
        flat = np.arange(h * (w // 4)).reshape(h, w // 4) >= partial_groups
        mask = np.repeat(flat, 4, axis=1)
        y[mask], u[mask], v[mask] = 0, 128, 128
        return y, u, v
