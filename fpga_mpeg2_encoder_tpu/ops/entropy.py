"""Vectorised entropy coding: VLC symbolisation of a whole frame at once.

Design
------
The reference emits symbols serially through a 7-chunk-per-cycle FSM
(RTL/mpeg2encoder.v:2476-2956).  The sequential state it carries - per-slice DC
predictors, per-slice MV predictors, per-tile run lengths - is *linear*: every
predictor depends on the previous macroblock's outputs only, never on emitted bits.
So the whole frame symbolises in parallel:

* DC prediction   : published[t] = inter ? 0 : dc[t]; pred = shift-by-one within the
                    slice (RTL:2781-2792) - a roll, not a scan.
* MV prediction   : published[mb] = inter ? mv : 0; pred = shift within slice
                    (RTL:2712-2773).
* run lengths     : prev-nonzero index via cumulative max over the zig order
                    (incl. the inter-DC-zero counts-as-run rule, RTL:2795-2834).

VLC tables are applied without gathers: every data-dependent lookup is a
one-hot matmul.  Table values are stored as bf16 byte-planes (each 0..255,
exactly representable), contracted against an exact 0/1 one-hot, accumulated
in f32 - bit-exact by construction.
The 111-entry B.14 run/level table is first compacted through a 5-case perfect
key in [0, 192); everything outside it is the 24-bit escape, computed
arithmetically (RTL:2541-2543).

Output is a slot grid - (2 + mb_rows) rows x S slots of (code<=24b, len) - with
GOP/picture headers as device-computed rows (timecode from the frame counter,
RTL:2684-2698), ready for the barrel-merge bit packer (ops/bitpack.py).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import tables as T

SLOTS_PER_MB = 4 + 6 * 65
HDR_SLOTS = 3             # slice start code, row number, quantiser scale
HEADER_ROWS = 2           # row 0: GOP header, row 1: picture header
_ZIG_INV_NP = np.asarray(T.ZIGZAG_INV)


def _onehot_lookup(idx: jnp.ndarray, table: np.ndarray) -> jnp.ndarray:
    """Exact table lookup without gathers: idx int32 in [0, K) -> int32 values.

    table: numpy int array, values < 2**24 (f32-exact).  The one-hot is a
    matmul with f32 accumulation (0/1 one-hot entries and the integer table
    values are exact, and exactly one product is nonzero per output).  For K > 32 the key factors as
    hi*16+lo: a 16-wide one-hot matmul against a (16, K/16) table produces every
    hi candidate at once, then ceil(K/16) masked selects pick the right one -
    the materialised one-hot shrinks K/16-fold."""
    k = table.shape[0]
    assert int(table.max(initial=0)) < (1 << 24)
    # NOTE: at default precision a matmul may round f32 operands (TF32 on the
    # GPU), so table values are decomposed into byte planes (0..255, bf16-exact)
    # and every operand is bf16.
    def planes_of(t):
        return np.stack([t & 255, (t >> 8) & 255, (t >> 16) & 255], -1)
    if k <= 32:
        tab = jnp.asarray(planes_of(table).astype(np.float32), dtype=jnp.bfloat16)
        oh = (idx[..., None] == jnp.arange(k)).astype(jnp.bfloat16)
        r = jax.lax.dot_general(oh, tab, (((oh.ndim - 1,), (0,)), ((), ())),
                                preferred_element_type=jnp.float32).astype(jnp.int32)
        return r[..., 0] | (r[..., 1] << 8) | (r[..., 2] << 16)
    khi = -(-k // 16)
    t2 = np.zeros((16, khi, 3), np.float32)
    for kk in range(k):
        t2[kk & 15, kk >> 4] = planes_of(np.asarray(table[kk]))
    ohlo = ((idx & 15)[..., None] == jnp.arange(16)).astype(jnp.bfloat16)
    # byte-plane values are 0..255, bf16-exact, so the matmul result can live
    # in bf16 end to end - halves the memory traffic of the hi-selection pass
    p = jax.lax.dot_general(ohlo, jnp.asarray(t2.reshape(16, khi * 3),
                                              dtype=jnp.bfloat16),
                            (((ohlo.ndim - 1,), (0,)), ((), ())),
                            preferred_element_type=jnp.bfloat16)
    p = p.reshape(idx.shape + (khi, 3))
    # hi selection: one fused multiply-reduce (exactly one nonzero term; 0/1
    # masks and 0..255 values are bf16-exact, and each output has exactly one
    # nonzero addend so the sum is exact too)
    ohhi = ((idx >> 4)[..., None] == jnp.arange(khi)).astype(jnp.bfloat16)
    out = (p * ohhi[..., None]).sum(-2).astype(jnp.int32)
    return out[..., 0] | (out[..., 1] << 8) | (out[..., 2] << 16)


# ---------------------------------------------------------------------------
# compact AC key: perfect map of B.14's 111 valid (run, am1) pairs into [0, 139),
# padded to 144 (9 one-hot groups of 16); 143 is the invalid sentinel
# ---------------------------------------------------------------------------
_AC_K = 144


def _build_ac_table() -> np.ndarray:
    tab = np.zeros(_AC_K, np.int64)   # valid<<22 | code<<6 | len
    def put(k, r, a):
        if T.AC_VALID[r, a]:
            tab[k] = (1 << 22) | (int(T.AC_CODE[r, a]) << 6) | int(T.AC_LEN[r, a])
    for r in range(8):
        for a in range(8):
            put(r * 8 + a, r, a)                      # A: [0, 64)
    for a in range(8, 40):
        put(64 + a - 8, 0, a)                         # B: [64, 96)
    for a in range(8, 18):
        put(96 + a - 8, 1, a)                         # C: [96, 106)
    for r in range(8, 17):
        for a in range(2):
            put(106 + (r - 8) * 2 + a, r, a)          # D: [106, 124)
    for r in range(17, 32):
        put(124 + r - 17, r, 0)                       # E: [124, 139)
    return tab


_AC_TABLE = _build_ac_table()


def _ac_key(run: jnp.ndarray, am1: jnp.ndarray) -> jnp.ndarray:
    a8 = (run <= 7) & (am1 <= 7)
    b = (run == 0) & (am1 >= 8) & (am1 <= 39)
    c = (run == 1) & (am1 >= 8) & (am1 <= 17)
    d = (run >= 8) & (run <= 16) & (am1 <= 1)
    e = (run >= 17) & (run <= 31) & (am1 == 0)
    k = jnp.full(run.shape, _AC_K - 1, jnp.int32)     # sentinel (invalid) row
    k = jnp.where(a8, run * 8 + am1, k)
    k = jnp.where(b, 64 + am1 - 8, k)
    k = jnp.where(c, 96 + am1 - 8, k)
    k = jnp.where(d, 106 + (run - 8) * 2 + am1, k)
    k = jnp.where(e, 124 + run - 17, k)
    return k


def _ac_symbol(v: jnp.ndarray, run: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """put_AC (RTL:2525-2547) for v != 0: (code uint32, len int32)."""
    absv = jnp.abs(v)
    am1 = absv - 1
    e = _onehot_lookup(_ac_key(run, am1), _AC_TABLE)
    valid = e >= (1 << 22)
    code_t = (((e >> 6) & 0xFFFF).astype(jnp.uint32) << 1) | (v < 0).astype(jnp.uint32)
    len_t = e & 63
    esc = (jnp.uint32(1) << 18) | (run.astype(jnp.uint32) << 12) \
        | (v.astype(jnp.int32) & 0xFFF).astype(jnp.uint32)
    return jnp.where(valid, code_t, esc), jnp.where(valid, len_t + 1, 24)


# small header/VLC tables as one-hot lookups (combined code<<5|len entries)
_MV_TAB = (T.BITS_MOTION_VECTOR.astype(np.int64) << 5) | T.LENS_MOTION_VECTOR
_CBP_TAB = (T.BITS_NZ_FLAGS.astype(np.int64) << 5) | T.LENS_NZ_FLAGS
_DCY_TAB = (T.BITS_DC_Y.astype(np.int64) << 5) | T.LENS_DC_Y
_DCUV_TAB = (T.BITS_DC_UV.astype(np.int64) << 5) | T.LENS_DC_UV


# Packed slot encoding: one uint32 per slot, code | len << 27.  Every code in
# the stream is <= 25 bits (largest: 24-bit start codes and escapes) and every
# len <= 24, so the pack fits with room to spare; a zero slot is a zero-length
# symbol.  Halves the symbolise->pack HBM traffic vs separate (codes, lens).
SLOT_LEN_SHIFT = 27
SLOT_CODE_MASK = (1 << SLOT_LEN_SHIFT) - 1


def pack_slot(code, length):
    """Pack (code uint32 <= 25 bits, len int <= 24) into one uint32 slot."""
    return code.astype(jnp.uint32) | (length.astype(jnp.uint32) << SLOT_LEN_SHIFT)


class FrameSymbols(NamedTuple):
    slots: jnp.ndarray    # (2 + nby, S) uint32, packed code | len << 27

    @property
    def codes(self) -> jnp.ndarray:
        return self.slots & SLOT_CODE_MASK

    @property
    def lens(self) -> jnp.ndarray:
        return (self.slots >> SLOT_LEN_SHIFT).astype(jnp.int32)


def _header_rows(i_frame: jnp.ndarray, frame_no: jnp.ndarray, s: int):
    """GOP + picture header rows (RTL:2650-2698), device-computed."""
    insec = frame_no % 24
    second = (frame_no // 24) % 60
    minute = (frame_no // (24 * 60)) % 60
    hour = jnp.minimum(frame_no // (24 * 3600), 63)
    is_gop = (i_frame == 0)
    gop_codes = jnp.stack([
        jnp.uint32(1), jnp.uint32(0xB8),
        hour.astype(jnp.uint32), minute.astype(jnp.uint32),
        (64 | second).astype(jnp.uint32), insec.astype(jnp.uint32), jnp.uint32(2)])
    gop_lens = jnp.where(is_gop, jnp.array([24, 8, 6, 6, 7, 6, 2], jnp.int32), 0)
    is_p = i_frame != 0
    pic_codes = jnp.stack([
        jnp.uint32(1), i_frame.astype(jnp.uint32),
        jnp.where(is_p, jnp.uint32(0x20000), jnp.uint32(0x10000)),
        jnp.where(is_p, jnp.uint32(0x380), jnp.uint32(0)),
        jnp.uint32(1), jnp.uint32(0xB58111), jnp.uint32(0x1BC000)])
    pic_lens = jnp.array([24, 18, 19, 0, 24, 24, 24], jnp.int32)
    pic_lens = pic_lens.at[3].set(jnp.where(is_p, 11, 3))
    codes = jnp.zeros((2, s), jnp.uint32)
    lens = jnp.zeros((2, s), jnp.int32)
    codes = codes.at[0, :7].set(gop_codes).at[1, :7].set(pic_codes)
    lens = lens.at[0, :7].set(gop_lens).at[1, :7].set(pic_lens)
    return codes, lens


def symbolize_frame(
    quant_zig: jnp.ndarray,  # (nby, nbx, 6, 64) int32, ZIG-ZAG coefficient order
                             # (apply the scan as a row permutation in
                             # coefficient-major space - a cheap major-axis
                             # reindex - before the tile-major transpose)
    inter: jnp.ndarray,      # (nby, nbx) bool
    mvx: jnp.ndarray,        # (nby, nbx) int32 half-pel
    mvy: jnp.ndarray,
    i_frame: jnp.ndarray,    # scalar int32 (0 => I-frame)
    frame_no: jnp.ndarray,   # scalar int32, frames since sequence start (timecode)
    q_level: int,
    first_row: jnp.ndarray | int = 0,   # global MB row of row 0 (slice sharding)
    include_headers: bool = True,       # False: slice rows only (headers packed
                                        # separately by the sharded path)
) -> FrameSymbols:
    nby, nbx = inter.shape
    zig = quant_zig                                               # (nby, nbx, 6, 64)
    nz = jnp.logical_not(inter)[:, :, None] | (zig != 0).any(-1)  # (nby, nbx, 6)
    cbp = sum((nz[..., t].astype(jnp.int32) << (5 - t)) for t in range(6))

    is_p = i_frame != 0
    intra = jnp.logical_not(inter)
    # macroblock type (RTL:2722-2731)
    type_code = jnp.where(intra & is_p, 0x23,
                          jnp.where(inter & (cbp == 0), 0x09, 0x03)).astype(jnp.uint32)
    type_len = jnp.where(intra & is_p, 6, jnp.where(inter & (cbp == 0), 4, 2))

    # motion vector differentials (RTL:2735-2763)
    def mv_symbol(mv):
        pub = jnp.where(inter, mv, 0)
        pred = jnp.concatenate([jnp.zeros((nby, 1), mv.dtype), pub[:, :-1]], axis=1)
        dmv = ((mv - pred + 16) & 31) - 16
        e = _onehot_lookup(jnp.abs(dmv), _MV_TAB)
        s = (dmv != 0).astype(jnp.uint32)
        code = ((e >> 5).astype(jnp.uint32) << s) | (dmv < 0).astype(jnp.uint32)
        ln = jnp.where(inter, (e & 31) + s.astype(jnp.int32), 0)
        return code, ln
    mvx_code, mvx_len = mv_symbol(mvx)
    mvy_code, mvy_len = mv_symbol(mvy)

    cbp_e = _onehot_lookup(cbp, _CBP_TAB)
    cbp_code = (cbp_e >> 5).astype(jnp.uint32)
    cbp_len = jnp.where(inter, cbp_e & 31, 0)

    # ---- DC prediction chains (RTL:2781-2821) --------------------------------
    dc = zig[..., 0]                                              # (nby, nbx, 6)
    pub_y = jnp.where(inter[:, :, None], 0, dc[..., :4]).reshape(nby, nbx * 4)
    pred_y = jnp.concatenate([jnp.zeros((nby, 1), dc.dtype), pub_y[:, :-1]], axis=1)
    pred_y = pred_y.reshape(nby, nbx, 4)
    pub_u = jnp.where(inter, 0, dc[..., 4])
    pred_u = jnp.concatenate([jnp.zeros((nby, 1), dc.dtype), pub_u[:, :-1]], axis=1)
    pub_v = jnp.where(inter, 0, dc[..., 5])
    pred_v = jnp.concatenate([jnp.zeros((nby, 1), dc.dtype), pub_v[:, :-1]], axis=1)
    pred_dc = jnp.concatenate([pred_y, pred_u[..., None], pred_v[..., None]], axis=-1)

    diff = dc - pred_dc                                           # (nby, nbx, 6)
    mag = jnp.abs(diff)
    vallen = sum((mag >= (1 << k)).astype(jnp.int32) for k in range(12))
    val = diff & 0xFFF
    val = jnp.where(diff < 0, (val + (1 << vallen) - 1) & 0xFFF, val)
    val = (val & ((1 << vallen) - 1)).astype(jnp.uint32)
    dce_y = _onehot_lookup(vallen, _DCY_TAB)
    dce_uv = _onehot_lookup(vallen, _DCUV_TAB)
    is_luma = (jnp.arange(6) < 4)[None, None, :]
    dce = jnp.where(is_luma, dce_y, dce_uv)
    size_code = (dce >> 5).astype(jnp.uint32)
    size_len = dce & 31
    dc_intra_code = (size_code << vallen.astype(jnp.uint32)) | val
    dc_intra_len = size_len + vallen

    # inter DC: 0 => nothing (counts as run); +-1 => 2-bit '1s'; else put_AC(v, 0)
    dc_ac_code, dc_ac_len = _ac_symbol(jnp.where(dc == 0, 1, dc), jnp.zeros_like(dc))
    one = jnp.abs(dc) == 1
    dc_inter_code = jnp.where(one, (2 | (dc < 0)).astype(jnp.uint32), dc_ac_code)
    dc_inter_len = jnp.where(dc == 0, 0, jnp.where(one, 2, dc_ac_len))

    dc_code = jnp.where(inter[:, :, None], dc_inter_code, dc_intra_code)
    dc_len = jnp.where(inter[:, :, None], dc_inter_len, dc_intra_len)

    # ---- packed non-AC slots --------------------------------------------------
    # A tile with nz=0 emits nothing at all: its AC coefficients are all zero
    # (len 0 by construction), its inter DC is 0 (len 0), so only the EOB slot
    # needs the explicit nz gate (the RTL simply skips the tile, RTL:2823-2834).
    nz_i = nz.astype(jnp.int32)
    dc_p = pack_slot(dc_code, dc_len)                             # (nby, nbx, 6)
    eob_p = pack_slot(jnp.full(nz.shape, 0b10, jnp.uint32),
                      2 * nz_i)
    type_p = pack_slot(type_code, type_len)
    mvx_p = pack_slot(mvx_code, mvx_len)
    mvy_p = pack_slot(mvy_code, mvy_len)
    cbp_p = pack_slot(cbp_code, cbp_len)

    s = HDR_SLOTS + nbx * SLOTS_PER_MB
    y16 = (jnp.arange(nby) + first_row).astype(jnp.uint32)
    hdr_p = pack_slot(
        jnp.stack([jnp.full(nby, 1, jnp.uint32), y16 + 1,
                   jnp.full(nby, 2 << q_level, jnp.uint32)], axis=1),
        jnp.broadcast_to(jnp.array([24, 8, 6], jnp.int32), (nby, 3)))

    # ---- AC run/level (RTL:2823-2834) + slot-grid assembly --------------------
    emit0 = intra[:, :, None] | (dc != 0)                         # position-0 emits
    k_idx = jnp.arange(64)
    emits = (zig != 0).at[..., 0].set(emit0)
    ew = jnp.where(emits, k_idx, -1)
    pm = jax.lax.cummax(ew, axis=ew.ndim - 1)
    prev = jnp.concatenate([jnp.full(pm.shape[:-1] + (1,), -1, pm.dtype),
                            pm[..., :-1]], axis=-1)
    run = k_idx - prev - 1                                        # (nby, nbx, 6, 64)
    ac_code, ac_len = _ac_symbol(jnp.where(zig == 0, 1, zig), run)
    ac_len = jnp.where(zig == 0, 0, ac_len)
    ac_p = pack_slot(ac_code, ac_len)[..., 1:]                    # positions 1..63

    tile_slots = jnp.concatenate(
        [dc_p[..., None], ac_p, eob_p[..., None]], axis=-1)       # (nby,nbx,6,65)
    mb_slots = jnp.concatenate(
        [type_p[..., None], mvx_p[..., None], mvy_p[..., None],
         cbp_p[..., None], tile_slots.reshape(nby, nbx, 6 * 65)], axis=-1)
    slice_slots = jnp.concatenate(
        [hdr_p, mb_slots.reshape(nby, nbx * SLOTS_PER_MB)], axis=1)

    if not include_headers:
        return FrameSymbols(slice_slots)
    hc, hl = _header_rows(i_frame, frame_no, s)
    return FrameSymbols(jnp.concatenate([pack_slot(hc, hl), slice_slots],
                                        axis=0))


def slice_words_bound(nbx: int) -> int:
    """Hard bound on packed words per slot-grid row: slice header 38 bits + worst-case
    macroblock symbols (every coefficient escaped)."""
    worst_mb = 6 + 11 + 11 + 9 + 6 * (24 + 63 * 24 + 2)
    return (38 + nbx * worst_mb + 31) // 32 + 1


def frame_words_bound(nbx: int, nby: int) -> int:
    """Hard bound on packed words per frame (headers + all slices)."""
    return nby * slice_words_bound(nbx) + 8
