"""Bit-exact NumPy golden model of the MPEG-2 encoder.

This is the framework's executable specification: every arithmetic step reproduces the
reference datapath (RTL/mpeg2encoder.v) exactly, including fixed-point truncations,
overflow masks and tie-break orders.  The JAX pipeline is unit-tested
against this model, and this model is validated by decoding its streams with
``golden.decoder`` and checking recon equality.

It is written frame-at-a-time with vectorised inner math but a per-macroblock Python
loop for motion estimation - clarity over speed (use the JAX pipeline for speed).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from ..config import EncoderConfig, SequenceConfig
from ..core import tables as T
from ..core.bitstream import (
    BitWriter,
    gop_header_chunks,
    picture_header_chunks,
    sequence_header_chunks,
    slice_header_chunks,
    SEQUENCE_END_CHUNKS,
)

# ---------------------------------------------------------------------------
# arithmetic helpers (RTL/mpeg2encoder.v:750-801)
# ---------------------------------------------------------------------------

def mean2(a, b):
    """(1 + a + b) >> 1  (RTL/mpeg2encoder.v:750-757)."""
    return (1 + a.astype(np.int32) + b.astype(np.int32)) >> 1


def mean4(a, b, c, d):
    """(1 + a + b + c + d) >> 2  (RTL/mpeg2encoder.v:760-767) - note +1, not +2."""
    return (1 + a.astype(np.int32) + b.astype(np.int32)
            + c.astype(np.int32) + d.astype(np.int32)) >> 2


def subsample_420(Y: np.ndarray, U: np.ndarray, V: np.ndarray):
    """4:4:4 -> 4:2:0: horizontal mean2 of column pairs then vertical mean2 of row
    pairs, each with +1 rounding (stages A-C, RTL/mpeg2encoder.v:1086-1171).
    This is mean2-of-mean2, NOT a single mean4."""
    Uh = mean2(U[:, 0::2], U[:, 1::2])
    Vh = mean2(V[:, 0::2], V[:, 1::2])
    U420 = mean2(Uh[1::2], Uh[0::2]).astype(np.uint8)   # cur (odd) row with prev row
    V420 = mean2(Vh[1::2], Vh[0::2]).astype(np.uint8)
    return Y.copy(), U420, V420


def find_min_in_10_values(v: List[int]) -> int:
    """Exact tournament of RTL/mpeg2encoder.v:804-840 (asymmetric tie-breaks)."""
    wi1 = v[1] < v[0]
    w01 = v[1] if wi1 else v[0]
    wi3 = v[3] < v[2]
    w23 = v[3] if wi3 else v[2]
    wi5 = v[5] < v[4]
    w45 = v[5] if wi5 else v[4]
    wi7 = v[7] < v[6]
    w67 = v[7] if wi7 else v[6]
    wi9 = v[9] < v[8]
    w89 = v[9] if wi9 else v[8]
    xi23 = w23 < w01
    x0123 = w23 if xi23 else w01
    xi67 = w67 < w45
    x4567 = w67 if xi67 else w45
    if w89 <= x0123 and w89 <= x4567:
        return 8 + int(wi9)
    if x0123 < x4567:
        if xi23:
            return 2 + int(wi3)
        return 0 + int(wi1)
    if xi67:
        return 6 + int(wi7)
    return 4 + int(wi5)


def halfpel_grid(w: np.ndarray) -> np.ndarray:
    """Half-pel interpolation grid of an (n, n) full-pel window -> (2n-1, 2n-1),
    G[2a, 2b] = w[a, b], odd positions mean2/mean4 (RTL/mpeg2encoder.v:1746-1752)."""
    n = w.shape[0]
    g = np.zeros((2 * n - 1, 2 * n - 1), dtype=np.int32)
    g[0::2, 0::2] = w
    g[0::2, 1::2] = mean2(w[:, :-1], w[:, 1:])
    g[1::2, 0::2] = mean2(w[:-1, :], w[1:, :])
    g[1::2, 1::2] = mean4(w[:-1, :-1], w[:-1, 1:], w[1:, :-1], w[1:, 1:])
    return g


# ---------------------------------------------------------------------------
# motion estimation + prediction (stages X/Y/Z/F, RTL/mpeg2encoder.v:1310-1918)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MacroblockDecision:
    inter: bool
    mvx: int          # final motion vector, half-pel units (5-bit signed domain)
    mvy: int


def motion_estimate_block(
    cfg: EncoderConfig,
    blk: np.ndarray,            # (16,16) uint8 current Y block
    prev_y_pad: np.ndarray,     # padded previous recon Y, pad = YR+1 each side
    by: int, bx: int, nby: int, nbx: int,
    is_iframe: bool,
) -> MacroblockDecision:
    yr = cfg.yr
    pad = yr + 1
    blk32 = blk.astype(np.int32)

    # --- full-pel exhaustive search (CALC_DIFF/CALC_MIN, RTL:1650-1691) ---
    base_y, base_x = by * 16 + pad, bx * 16 + pad
    sads = np.zeros((2 * yr + 1, 2 * yr + 1), dtype=np.int64)
    for dy in range(-yr, yr + 1):
        for dx in range(-yr, yr + 1):
            ref = prev_y_pad[base_y + dy: base_y + dy + 16,
                             base_x + dx: base_x + dx + 16].astype(np.int32)
            sads[dy + yr, dx + yr] = np.abs(blk32 - ref).sum()
    dyi, dxi = np.meshgrid(np.arange(-yr, yr + 1), np.arange(-yr, yr + 1), indexing="ij")
    # boundary masks depend only on block position (RTL:1642-1645)
    invalid = ((bx == 0) & (dxi < 0)) | ((bx == nbx - 1) & (dxi > 0)) \
        | ((by == 0) & (dyi < 0)) | ((by == nby - 1) & (dyi > 0))
    # 12-bit SAD accumulator overflow disables a candidate (RTL:1670)
    invalid |= sads > 4095
    if invalid.all():
        mvy_full, mvx_full = 0, 0          # defaults (RTL:1695, 1707)
    else:
        m = sads[~invalid].min()
        # survivors of the bit-plane elimination = all minima; the scan keeps the
        # LARGEST y, then the LARGEST x in that row (RTL:1694-1710)
        rows = np.where(((sads == m) & ~invalid).any(axis=1))[0]
        ry = rows.max()
        cols = np.where((sads[ry] == m) & ~invalid[ry])[0]
        mvy_full, mvx_full = int(ry) - yr, int(cols.max()) - yr

    # --- intra metric: f_Y_sum accumulates pixel sum THEN |Y - mean| without reset
    #     (RTL:1659-1662, 1774-1777), in a 16-bit register ---
    pixsum = int(blk32.sum())                         # <= 65280, fits 16 bits
    mean = (pixsum >> 8) & 0xFF                       # f_Y_mean = f_Y_sum[15:8]
    acc = (pixsum + int(np.abs(blk32 - mean).sum())) & 0xFFFF
    intra_cost = acc if acc < 4096 else 0xFFF         # RTL:1791

    # --- half-pel refinement (RTL:1743-1816) ---
    w2 = prev_y_pad[base_y + mvy_full - 1: base_y + mvy_full + 17,
                    base_x + mvx_full - 1: base_x + mvx_full + 17].astype(np.int32)
    g = halfpel_grid(w2)                              # (35, 35); g[2+p, 2+q] = half coord p,q
    vals = []
    for hy in (-1, 0, 1):
        for hx in (-1, 0, 1):
            bad = (((bx == 0 or mvx_full == -yr) and hx < 0)
                   or ((bx == nbx - 1 or mvx_full == yr) and hx > 0)
                   or ((by == 0 or mvy_full == -yr) and hy < 0)
                   or ((by == nby - 1 or mvy_full == yr) and hy > 0))
            if bad:
                vals.append(0x1000)                   # over bit set; exact partial value
                continue                              # is provably outcome-irrelevant
            ref = g[2 + hy: 2 + hy + 31: 2, 2 + hx: 2 + hx + 31: 2]
            sad = int(np.abs(blk32 - ref).sum())
            vals.append(sad if sad <= 4095 else 0x1000)
    vals.append(intra_cost)
    idx = find_min_in_10_values(vals)

    if idx == 9:
        inter, hy, hx = False, 0, 0
    else:
        inter, hy, hx = True, idx // 3 - 1, idx % 3 - 1

    if is_iframe:                                     # CALC_MIN_HALF2 (RTL:1820-1825)
        return MacroblockDecision(False, 0, 0)
    # P-frame: mv registers always updated, even if intra wins (RTL:1827-1828)
    return MacroblockDecision(inter, (mvx_full << 1) + hx, (mvy_full << 1) + hy)


def predict_block(
    cfg: EncoderConfig,
    dec: MacroblockDecision,
    prev_y_pad: np.ndarray, prev_u_pad: np.ndarray, prev_v_pad: np.ndarray,
    by: int, bx: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Prediction tiles (PREDICT, RTL:1891-1917).  Intra => constant 128."""
    if not dec.inter:
        return (np.full((16, 16), 128, np.int32), np.full((8, 8), 128, np.int32),
                np.full((8, 8), 128, np.int32))
    yr, ur = cfg.yr, cfg.ur
    padl, padc = yr + 1, ur + 1
    fy, fx = dec.mvy >> 1, dec.mvx >> 1          # full-pel part via arithmetic shift
    hy, hx = dec.mvy - (fy << 1), dec.mvx - (fx << 1)
    # luma: half-pel sample at (2y + mvy, 2x + mvx) in half-pel coords
    base_y, base_x = by * 16 + padl, bx * 16 + padl
    w2 = prev_y_pad[base_y + fy - 1: base_y + fy + 17,
                    base_x + fx - 1: base_x + fx + 17].astype(np.int32)
    g = halfpel_grid(w2)
    ypred = g[2 + hy: 2 + hy + 31: 2, 2 + hx: 2 + hx + 31: 2].copy()

    # chroma: full-pel offset = mv >>> 2, half flags = (mv >>> 1) & 1 (RTL:1854-1916)
    cfy, cfx = dec.mvy >> 2, dec.mvx >> 2
    chy, chx = (dec.mvy >> 1) & 1, (dec.mvx >> 1) & 1
    assert -ur <= cfy <= ur and -ur <= cfx <= ur, "chroma shift saturation unreachable"
    cy0, cx0 = by * 8 + padc + cfy, bx * 8 + padc + cfx
    out = []
    for plane in (prev_u_pad, prev_v_pad):
        w = plane[cy0: cy0 + 9, cx0: cx0 + 9].astype(np.int32)
        if chy and chx:
            p = mean4(w[:8, :8], w[:8, 1:9], w[1:9, :8], w[1:9, 1:9])
        elif chx:
            p = mean2(w[:8, :8], w[:8, 1:9])
        elif chy:
            p = mean2(w[:8, :8], w[1:9, :8])
        else:
            p = w[:8, :8].copy()
        out.append(p)
    return ypred, out[0], out[1]


# ---------------------------------------------------------------------------
# forward DCT + quantise (stage G, RTL:1924-2078)
# ---------------------------------------------------------------------------

def fdct(tile: np.ndarray) -> np.ndarray:
    """Exact stage-G DCT: F = round((M @ X @ M^T) / 4096) with 17-bit wrap.

    Phase 1 keeps full precision (RTL:2029-2036); rounding happens once in phase 2
    (RTL:2058): t = (t >>> 12) + t[11], result truncated to 17 bits signed."""
    t = T.DCTM.astype(np.int64) @ tile.astype(np.int64) @ T.DCTM.astype(np.int64).T
    r = (t >> 12) + ((t >> 11) & 1)
    return (((r & 0x1FFFF) ^ 0x10000) - 0x10000).astype(np.int32)


def quantize(res3: np.ndarray, inter: bool, q_level: int) -> np.ndarray:
    """Stage-G quantiser (RTL:2064-2077), 16-bit unsigned temp arithmetic."""
    a = (np.abs(res3.astype(np.int64)) & 0xFFFF).astype(np.int64)
    if inter:
        q = ((a + 2) & 0xFFFF) >> (4 + q_level)
    else:
        w = T.INTRA_Q.astype(np.int64)
        off = (w * ((3 << q_level) + 2)) >> 3
        q = (((a + off) & 0xFFFF) >> q_level) // w
        dc = (a[0, 0] >> 4) + ((a[0, 0] >> 3) & 1)
        q = q.copy()
        q[0, 0] = dc
    q = np.minimum(q, 2047)
    return np.where(res3 < 0, -q, q).astype(np.int32)


def dequantize(q: np.ndarray, inter: bool, q_level: int) -> np.ndarray:
    """Stage-H inverse quantiser (RTL:2128-2150)."""
    x = q.astype(np.int64)
    if inter:
        x = x * 2
        x = x + np.sign(x)
        x = x << q_level
        x = np.clip(x, -2047, 2047)
    else:
        w = T.INTRA_Q.astype(np.int64)
        x = x * w
        if q_level >= 3:
            x = x << (q_level - 3)
        else:
            x = x >> (3 - q_level)      # arithmetic shift (floor)
        x = np.clip(x, -2047, 2047)
        x = x.copy()
        x[0, 0] = q[0, 0] * 2           # intra DC: x = q*2 (RTL:2146)
    return x.astype(np.int32)


# ---------------------------------------------------------------------------
# fixed-point Chen-Wang inverse DCT (RTL:843-972, stages H/J/K/M)
# ---------------------------------------------------------------------------

def _trunc(v: np.ndarray, bits: int) -> np.ndarray:
    m = (1 << bits) - 1
    s = 1 << (bits - 1)
    return ((v & m) ^ s) - s


def idct(iq: np.ndarray) -> np.ndarray:
    """Row pass then column pass, exact truncations; output clipped to +-255.

    All intermediates are 32-bit (the RTL's regs are [31:0]) and WRAP on extreme
    inputs - int32 two's-complement arithmetic reproduces that exactly."""
    old = np.seterr(over="ignore")
    try:
        return _idct_i32(iq)
    finally:
        np.seterr(**old)


def _idct_i32(iq: np.ndarray) -> np.ndarray:
    a = iq.astype(np.int32)
    # --- rows (invserse_dct_rows_step12/34) ---
    x0, x1, x2, x3 = a[:, 0], a[:, 4], a[:, 6], a[:, 2]
    x4, x5, x6, x7 = a[:, 1], a[:, 7], a[:, 5], a[:, 3]
    x0 = (x0 << 11) | 128                   # +128 rounding bit (RTL:859)
    x1 = x1 << 11
    x8 = T.W7 * (x4 + x5)
    x4 = x8 + (T.W1 - T.W7) * x4
    x5 = x8 - (T.W1 + T.W7) * x5
    x8 = T.W3 * (x6 + x7)
    x6 = x8 - (T.W3 - T.W5) * x6
    x7 = x8 - (T.W3 + T.W5) * x7
    x8 = x0 + x1
    x0 = x0 - x1
    x1 = T.W6 * (x3 + x2)
    x2 = x1 - (T.W2 + T.W6) * x2
    x3 = x1 + (T.W2 - T.W6) * x3
    x1 = x4 + x6
    x4 = x4 - x6
    x6 = x5 + x7
    x5 = x5 - x7
    x7 = x8 + x3
    x8 = x8 - x3
    x3 = x0 + x2
    x0 = x0 - x2
    x2 = (181 * (x4 + x5) + 128) >> 8
    x4 = (181 * (x4 - x5) + 128) >> 8
    rows = np.stack([(x7 + x1) >> 8, (x3 + x2) >> 8, (x0 + x4) >> 8, (x8 + x6) >> 8,
                     (x8 - x6) >> 8, (x0 - x4) >> 8, (x3 - x2) >> 8, (x7 - x1) >> 8],
                    axis=1)
    rows = _trunc(rows, 18)                 # r0..r7 are 18-bit regs (RTL:886)
    # --- columns (invserse_dct_cols_step12/34) ---
    b = rows
    x0, x1, x2, x3 = b[0], b[4], b[6], b[2]
    x4, x5, x6, x7 = b[1], b[7], b[5], b[3]
    x0 = (x0 << 8) + 8192
    x1 = x1 << 8
    x8 = T.W7 * (x4 + x5) + 4
    x4 = (x8 + (T.W1 - T.W7) * x4) >> 3
    x5 = (x8 - (T.W1 + T.W7) * x5) >> 3
    x8 = T.W3 * (x6 + x7) + 4
    x6 = (x8 - (T.W3 - T.W5) * x6) >> 3
    x7 = (x8 - (T.W3 + T.W5) * x7) >> 3
    x8 = x0 + x1
    x0 = x0 - x1
    x1 = T.W6 * (x3 + x2) + 4
    x2 = (x1 - (T.W2 + T.W6) * x2) >> 3
    x3 = (x1 + (T.W2 - T.W6) * x3) >> 3
    x1 = x4 + x6
    x4 = x4 - x6
    x6 = x5 + x7
    x5 = x5 - x7
    x7 = x8 + x3
    x8 = x8 - x3
    x3 = x0 + x2
    x0 = x0 - x2
    x2 = (181 * (x4 + x5) + 128) >> 8
    x4 = (181 * (x4 - x5) + 128) >> 8
    cols = np.stack([(x7 + x1) >> 14, (x3 + x2) >> 14, (x0 + x4) >> 14, (x8 + x6) >> 14,
                     (x8 - x6) >> 14, (x0 - x4) >> 14, (x3 - x2) >> 14, (x7 - x1) >> 14],
                    axis=0)
    return np.clip(cols, -255, 255).astype(np.int32)


def add_clip(pred: np.ndarray, resid: np.ndarray) -> np.ndarray:
    return np.clip(pred + resid, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# entropy coding (stages S/T, RTL:2434-2873)
# ---------------------------------------------------------------------------

def zigzag_scan(coeff: np.ndarray) -> np.ndarray:
    return coeff.reshape(64)[T.ZIGZAG_INV]


def put_ac_symbol(v: int, run: int) -> Tuple[int, int]:
    """put_AC (RTL:2525-2547): table code + sign bit, or 24-bit escape."""
    absv = -v if v < 0 else v
    am1 = absv - 1
    if run < 32 and am1 < 41 and T.AC_VALID[run, am1]:
        code = (int(T.AC_CODE[run, am1]) << 1) | (1 if v < 0 else 0)
        return code, int(T.AC_LEN[run, am1]) + 1
    return (1 << 18) | (run << 12) | (v & 0xFFF), 24


def encode_block_symbols(
    bw: BitWriter,
    dec: MacroblockDecision,
    zig: np.ndarray,            # (6, 64) int32, tile order Y00 Y01 Y10 Y11 U V
    nzflags: int,               # 6-bit CBP, bit5 = Y00 ... bit0 = V
    i_frame: int,
    state: dict,
) -> None:
    """Macroblock emission (PUT_BLOCK_INFO + PUT_TILE, RTL:2718-2846).

    ``state`` carries the per-slice predictors: prev_mvx/prev_mvy/prev_dc[3]."""
    inter = dec.inter
    # block type (RTL:2722-2731)
    if not inter and i_frame != 0:
        bw.put(0x23, 6)
    elif inter and nzflags == 0:
        bw.put(0x09, 4)
    else:
        bw.put(0x03, 2)

    if inter:
        for comp, mv in (("x", dec.mvx), ("y", dec.mvy)):
            dmv = mv - state["prev_mv" + comp]
            if dmv > 15:
                dmv -= 32
            elif dmv < -16:
                dmv += 32
            dmvabs = -dmv if dmv < 0 else dmv
            bw.put(int(T.BITS_MOTION_VECTOR[dmvabs]), int(T.LENS_MOTION_VECTOR[dmvabs]))
            if dmv != 0:
                bw.put(1 if dmv < 0 else 0, 1)
        bw.put(int(T.BITS_NZ_FLAGS[nzflags]), int(T.LENS_NZ_FLAGS[nzflags]))
        state["prev_mvx"], state["prev_mvy"] = dec.mvx, dec.mvy
    else:
        state["prev_mvx"], state["prev_mvy"] = 0, 0

    for t in range(6):
        nz = (nzflags >> (5 - t)) & 1
        z = zig[t]
        dc = int(z[0])
        comp = 0 if t < 4 else (1 if t == 4 else 2)
        run = 0
        if inter:
            state["prev_dc"][comp] = 0
            if dc == 0:
                run = 1
            elif dc in (1, -1):
                if nz:
                    bw.put(2 | (1 if dc < 0 else 0), 2)     # first-coeff '1s' rule
            else:
                if nz:
                    c, l = put_ac_symbol(dc, 0)
                    bw.put(c, l)
        else:
            diff = dc - state["prev_dc"][comp]
            state["prev_dc"][comp] = dc
            mag = -diff if diff < 0 else diff
            vallen = mag.bit_length()
            val = diff & 0xFFF
            if diff < 0:
                val = (val + (1 << vallen) - 1) & 0xFFF
            if nz:
                if t < 4:
                    bw.put(int(T.BITS_DC_Y[vallen]), int(T.LENS_DC_Y[vallen]))
                else:
                    bw.put(int(T.BITS_DC_UV[vallen]), int(T.LENS_DC_UV[vallen]))
                bw.put(val & ((1 << vallen) - 1), vallen)
        for k in range(1, 64):
            v = int(z[k])
            if v != 0:
                if nz:
                    c, l = put_ac_symbol(v, run)
                    bw.put(c, l)
                run = 0
            else:
                run += 1
        if nz:
            bw.put(0b10, 2)                                  # EOB (RTL:2835, 2897-2899)


# ---------------------------------------------------------------------------
# frame + sequence encode
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FrameResult:
    recon_y: np.ndarray
    recon_u: np.ndarray
    recon_v: np.ndarray
    decisions: list            # [nby][nbx] MacroblockDecision
    quant: np.ndarray          # (nby, nbx, 6, 8, 8) int32
    nzflags: np.ndarray        # (nby, nbx) int


def encode_frame(
    cfg: EncoderConfig,
    y: np.ndarray, u: np.ndarray, v: np.ndarray,     # 4:2:0 planes uint8
    prev: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    i_frame: int,
) -> FrameResult:
    h, w = y.shape
    nby, nbx = h // 16, w // 16
    yr, ur = cfg.yr, cfg.ur
    is_iframe = i_frame == 0

    if prev is None:
        prev = (np.zeros_like(y), np.zeros_like(u), np.zeros_like(v))
    py = np.pad(prev[0], yr + 1).astype(np.uint8)
    pu = np.pad(prev[1], ur + 1).astype(np.uint8)
    pv = np.pad(prev[2], ur + 1).astype(np.uint8)

    recon_y = np.zeros_like(y)
    recon_u = np.zeros_like(u)
    recon_v = np.zeros_like(v)
    quant_all = np.zeros((nby, nbx, 6, 8, 8), np.int32)
    nzf_all = np.zeros((nby, nbx), np.int32)
    decisions = [[None] * nbx for _ in range(nby)]

    for by in range(nby):
        for bx in range(nbx):
            blk = y[by * 16:(by + 1) * 16, bx * 16:(bx + 1) * 16]
            ublk = u[by * 8:(by + 1) * 8, bx * 8:(bx + 1) * 8].astype(np.int32)
            vblk = v[by * 8:(by + 1) * 8, bx * 8:(bx + 1) * 8].astype(np.int32)
            dec = motion_estimate_block(cfg, blk, py, by, bx, nby, nbx, is_iframe)
            decisions[by][bx] = dec
            ypred, upred, vpred = predict_block(cfg, dec, py, pu, pv, by, bx)

            tiles = [
                (blk[0:8, 0:8].astype(np.int32), ypred[0:8, 0:8]),
                (blk[0:8, 8:16].astype(np.int32), ypred[0:8, 8:16]),
                (blk[8:16, 0:8].astype(np.int32), ypred[8:16, 0:8]),
                (blk[8:16, 8:16].astype(np.int32), ypred[8:16, 8:16]),
                (ublk, upred),
                (vblk, vpred),
            ]
            nzf = 0
            recons = []
            for t, (cur, pred) in enumerate(tiles):
                res3 = fdct(cur - pred)
                q = quantize(res3, dec.inter, cfg.q_level)
                quant_all[by, bx, t] = q
                nz = (not dec.inter) or bool((q != 0).any())
                nzf = (nzf << 1) | int(nz)
                resid = idct(dequantize(q, dec.inter, cfg.q_level))
                recons.append(add_clip(pred, resid))
            nzf_all[by, bx] = nzf

            recon_y[by * 16:by * 16 + 8, bx * 16:bx * 16 + 8] = recons[0]
            recon_y[by * 16:by * 16 + 8, bx * 16 + 8:bx * 16 + 16] = recons[1]
            recon_y[by * 16 + 8:by * 16 + 16, bx * 16:bx * 16 + 8] = recons[2]
            recon_y[by * 16 + 8:by * 16 + 16, bx * 16 + 8:bx * 16 + 16] = recons[3]
            recon_u[by * 8:(by + 1) * 8, bx * 8:(bx + 1) * 8] = recons[4]
            recon_v[by * 8:(by + 1) * 8, bx * 8:(bx + 1) * 8] = recons[5]

    return FrameResult(recon_y, recon_u, recon_v, decisions, quant_all, nzf_all)


@dataclasses.dataclass
class Timecode:
    hour: int = 0
    minute: int = 0
    second: int = 0
    insec: int = 0

    def tick(self) -> None:
        """24 fps counter (RTL:2684-2698)."""
        self.insec += 1
        if self.insec == 24:
            self.insec = 0
            self.second += 1
            if self.second == 60:
                self.second = 0
                self.minute += 1
                if self.minute == 60:
                    self.minute = 0
                    if self.hour < 63:
                        self.hour += 1


def emit_frame_bits(
    cfg: EncoderConfig,
    bw: BitWriter,
    fr: FrameResult,
    i_frame: int,
    tc: Timecode,
) -> None:
    nby, nbx = fr.nzflags.shape
    if i_frame == 0:
        bw.put_chunks(gop_header_chunks(tc.hour, tc.minute, tc.second, tc.insec))
    bw.put_chunks(picture_header_chunks(i_frame))
    tc.tick()
    for by in range(nby):
        bw.put_chunks(slice_header_chunks(by, cfg.q_level))
        state = {"prev_mvx": 0, "prev_mvy": 0, "prev_dc": [0, 0, 0]}
        for bx in range(nbx):
            dec = fr.decisions[by][bx]
            zig = np.stack([zigzag_scan(fr.quant[by, bx, t]) for t in range(6)])
            encode_block_symbols(bw, dec, zig, int(fr.nzflags[by, bx]), i_frame, state)


def black_frame_420(width: int, height: int):
    """The sequence-FSM pad pixels: Y=0, U=V=128 in 4:4:4 (RTL:1043-1044); after
    subsampling (mean2 of equal values is identity) the 4:2:0 planes are (0, 128, 128)."""
    return (np.zeros((height, width), np.uint8),
            np.full((height // 2, width // 2), 128, np.uint8),
            np.full((height // 2, width // 2), 128, np.uint8))


def encode_sequence(
    cfg: EncoderConfig,
    seq: SequenceConfig,
    frames444: List[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    stop_mode: str = "clean",
    partial_groups: int = 0,
) -> bytes:
    """Encode one video sequence to an MPEG-2 elementary stream.

    stop_mode:
      'clean'      - stop pulse after the last frame with input idle: no pad frame
                     (the testbench flow, SIM/tb_mpeg2encoder.v:249-252).
      'coincident' - stop asserted on the very cycle the frame's last 4-pixel group
                     is accepted.  Identical stream to 'clean': the raster counters
                     (a_x4, a_y) are the index of the group accepted THIS cycle, so
                     after the last group they read (max_x4, max_y) and wrap only
                     when the NEXT frame's first group is accepted (RTL:1070-1079).
                     SEQ_ENDING therefore sees a completed frame and transitions to
                     SEQ_ENDED immediately - no pad frame (RTL:1048-1058).
      'partial'    - stop asserted while a frame is partially fed: the first
                     ``partial_groups`` (>= 1) 4-pixel groups (raster order) of the
                     last frames444 entry are real, the remainder is padded black
                     (Y=0, U=V=128, RTL:1043-1044) and the frame is encoded
                     normally.  ``partial_groups=1`` is the RTL corner where stop
                     coincides with the FIRST group of a new frame: that group's 4
                     real pixels are in the stream and the rest of the frame is pad.
                     A fully-black pad frame can never occur: SEQ_ENDING is only
                     reachable after at least one group was accepted.
    """
    if stop_mode == "partial" and partial_groups < 1:
        raise ValueError("partial_groups must be >= 1 (SEQ_ENDING is only "
                         "reachable after a group was accepted, RTL:1081-1093)")
    seq = seq.validate(cfg)
    w, h = seq.width, seq.height
    bw = BitWriter()
    bw.put_chunks(sequence_header_chunks(w, h))

    plan: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    for idx, (yy, uu, vv) in enumerate(frames444):
        if stop_mode == "partial" and idx == len(frames444) - 1:
            yy, uu, vv = yy.copy(), uu.copy(), vv.copy()
            flat_mask = np.arange(h * (w // 4)).reshape(h, w // 4) >= partial_groups
            mask = np.repeat(flat_mask, 4, axis=1)
            yy[mask], uu[mask], vv[mask] = 0, 128, 128
        plan.append(subsample_420(yy, uu, vv))

    tc = Timecode()
    prev = None
    i_frame = 0
    for planes in plan:
        fr = encode_frame(cfg, *planes, prev, i_frame)
        emit_frame_bits(cfg, bw, fr, i_frame, tc)
        prev = (fr.recon_y, fr.recon_u, fr.recon_v)
        i_frame = 0 if i_frame >= seq.pframes_count else i_frame + 1

    bw.put_chunks(SEQUENCE_END_CHUNKS)
    return bw.finish_sequence()
