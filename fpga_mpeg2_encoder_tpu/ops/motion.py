"""Motion estimation + prediction over the whole macroblock grid (stages X/Y/Z/F,
RTL/mpeg2encoder.v:1310-1918).

Design
------
The RTL searches one macroblock at a time with 169 parallel SAD accumulators and
recenters its reference window by shifting registers (REF_SHIFT_*, RTL:1719-1740).
Here all macroblocks run concurrently as whole-frame array operations built from
static slices, with no gathers or scatters:

* full-pel: 169 statically-shifted whole-frame absolute differences; the 16x16
  block reduction is an exact bf16 matmul against a block-diagonal 0/1 matrix
  (|diff| <= 255 and 0/1 entries are exact in bf16; accumulation is f32);
* argmin with the exact RTL tie-break (largest dy, then largest dx among minima,
  RTL:1694-1710) via an order-encoding key;
* recentering: the array analog of REF_SHIFT is a 13+13-case masked select over
  statically shifted sliding-window tensors - every macroblock's 18x18 search
  window lands at its own motion vector with pure static slices;
* half-pel: four interpolated grids (full/H/V/HV), 9 candidate SADs, the exact
  find_min_in_10_values tournament (RTL:804-840) against the intra activity
  metric (f_Y_sum accumulation quirk included, RTL:1659-1662/1774-1791);
* prediction: luma from the selected half-pel grid; chroma via mv>>2 full-pel
  offset + (mv>>1)&1 half flags (RTL:1847-1917), aligned the same way.

All arithmetic is integer-exact against the golden model.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class MotionResult(NamedTuple):
    inter: jnp.ndarray       # (nby, nbx) bool
    mvx: jnp.ndarray         # (nby, nbx) int32, half-pel units
    mvy: jnp.ndarray         # (nby, nbx) int32
    pred_y: jnp.ndarray      # (nby, nbx, 16, 16) int32
    pred_u: jnp.ndarray      # (nby, nbx, 8, 8) int32
    pred_v: jnp.ndarray      # (nby, nbx, 8, 8) int32


def _find_min_10(v: jnp.ndarray) -> jnp.ndarray:
    """Vectorised exact tournament of RTL:804-840.  v: (..., 10) int32 -> (...) index."""
    def pick(lo, hi):
        w = jnp.where(v[..., hi] < v[..., lo], v[..., hi], v[..., lo])
        i = jnp.where(v[..., hi] < v[..., lo], hi, lo)
        return w, i
    w01, i01 = pick(0, 1)
    w23, i23 = pick(2, 3)
    w45, i45 = pick(4, 5)
    w67, i67 = pick(6, 7)
    w89, i89 = pick(8, 9)
    x0123 = jnp.where(w23 < w01, w23, w01)
    i0123 = jnp.where(w23 < w01, i23, i01)
    x4567 = jnp.where(w67 < w45, w67, w45)
    i4567 = jnp.where(w67 < w45, i67, i45)
    left = jnp.where(x0123 < x4567, i0123, i4567)
    use89 = (w89 <= x0123) & (w89 <= x4567)
    return jnp.where(use89, i89, left)


def _block_reduce_matmul(x: jnp.ndarray, bs: int) -> jnp.ndarray:
    """(H, W) nonneg int (values <= 255) -> (H//bs, W//bs) block sums.

    Column groups reduce as a matmul (x_bf16 @ block-diagonal 0/1 matrix; |x| <= 255
    and 0/1 entries are bf16-exact, accumulation is f32), then the row groups
    reduce with a cheap f32 reshape-sum.  Every partial sum stays below 2^24, so
    the result is exact."""
    h, w = x.shape
    b = (jnp.arange(w)[:, None] // bs == jnp.arange(w // bs)[None, :])
    cols = jnp.dot(x.astype(jnp.bfloat16), b.astype(jnp.bfloat16),
                   preferred_element_type=jnp.float32)          # (H, W/bs)
    return cols.reshape(h // bs, bs, w // bs).sum(axis=1).astype(jnp.int32)


def _sliding_block_windows(plane: jnp.ndarray, bs: int) -> jnp.ndarray:
    """(Hp, Wp) plane padded by bs//2 each side -> (nby, nbx, 2*bs, 2*bs) windows:
    window [by, bx] covers rows/cols [bs*by - bs/2, bs*by + 3*bs/2) of the
    unpadded plane - a static 2x2-block sliding expansion (concat-of-reshapes).
    This covers every recentering target (|mv| <= 3/8*bs plus the interpolation
    halo) at half the footprint of a 3x3 expansion."""
    hp, wp = plane.shape
    nby, nbx = hp // bs - 1, wp // bs - 1
    r = plane.reshape(hp // bs, bs, wp)
    rows = jnp.concatenate([r[:-1], r[1:]], axis=1)             # (nby, 2bs, Wp)
    c = rows.reshape(nby, 2 * bs, wp // bs, bs)
    return jnp.concatenate([c[:, :, :-1], c[:, :, 1:]], axis=3) \
        .transpose(0, 2, 1, 3)                                  # (nby, nbx, 2bs, 2bs)


def _barrel_stages(rng: int):
    """Greedy halving decomposition of a shift amount in [0, 2*rng]: every value
    is the sum of a subset of the stages, chosen greedily (take stage s iff the
    remaining amount is >= s).  rng=6 -> (6, 3, 2, 1); rng=3 -> (3, 2, 1)."""
    stages, rem = [], 2 * rng
    while rem > 0:
        s = (rem + 1) // 2
        stages.append(s)
        rem -= s
    return stages


def _barrel_align(t: jnp.ndarray, amt: jnp.ndarray, rng: int, out: int,
                  lo: int, axis: int) -> jnp.ndarray:
    """Shift windows along `axis` by a per-macroblock dynamic amount in
    [0, 2*rng] using log-many static-slice selects (the bit-packer's word-barrel
    idea applied to pixel windows): 4 passes for rng=6 instead of 13 masked
    selects.  Returns width-`out` windows starting at offset lo + amt."""
    width = out + 2 * rng
    cur = jax.lax.slice_in_dim(t, lo, lo + width, axis=axis)
    rem = amt
    for s in _barrel_stages(rng):
        width -= s
        take = (rem >= s)[:, :, None, None]
        cur = jnp.where(take,
                        jax.lax.slice_in_dim(cur, s, s + width, axis=axis),
                        jax.lax.slice_in_dim(cur, 0, width, axis=axis))
        rem = rem - jnp.where(rem >= s, s, 0)
    return cur


def _align_windows(t: jnp.ndarray, off_y: jnp.ndarray, off_x: jnp.ndarray,
                   rng: int, out: int, base: int) -> jnp.ndarray:
    """Barrel-select recentering: t (nby, nbx, 2bs, 2bs) sliding windows,
    off in [-rng, rng] per macroblock -> (nby, nbx, out, out) windows starting at
    relative coordinate (base + off) (base relative to the window's -bs origin)."""
    a = _barrel_align(t, off_y + rng, rng, out, base - rng, axis=2)
    return _barrel_align(a, off_x + rng, rng, out, base - rng, axis=3)


def estimate_and_predict(
    cur_y: jnp.ndarray,        # (H, W) uint8 current luma
    cur_u: jnp.ndarray,        # (H/2, W/2) uint8
    cur_v: jnp.ndarray,
    prev_y: jnp.ndarray,       # previous recon planes, uint8
    prev_u: jnp.ndarray,
    prev_v: jnp.ndarray,
    is_iframe: jnp.ndarray,    # scalar bool (traced: one compiled program for I and P)
    yr: int,                   # static: luma search range
    ur: int,                   # static: chroma search range
) -> MotionResult:
    nby = cur_y.shape[0] // 16
    return estimate_and_predict_local(
        cur_y,
        jnp.pad(prev_y, ((8, 8), (0, 0))),
        jnp.pad(prev_u, ((4, 4), (0, 0))),
        jnp.pad(prev_v, ((4, 4), (0, 0))),
        is_iframe, yr, ur, jnp.int32(0), jnp.int32(nby))


def estimate_and_predict_local(
    cur_y: jnp.ndarray,        # (Hl, W) uint8: a band of macroblock rows
    prev_y_h: jnp.ndarray,     # (Hl + 16, W): recon band + 8-row halo each side
    prev_u_h: jnp.ndarray,     # (Hl/2 + 8, W/2): + 4-row halo
    prev_v_h: jnp.ndarray,
    is_iframe: jnp.ndarray,
    yr: int,
    ur: int,
    first_mb_row: jnp.ndarray,   # traced: global MB row of local row 0
    total_mb_rows: jnp.ndarray,  # traced: global MB row count
) -> MotionResult:
    """Band-local motion estimation, the one formulation behind both the
    whole-frame path and slice-row sharding (SURVEY section 2.9 SP/CP axis):
    the reference planes arrive with their +-8/+-4-row halos already
    exchanged (parallel/halo.py; the RTL analog is the +-YR-row reference
    window fetch, RTL:1364-1373) and frame-edge candidate masking uses GLOBAL
    row indices, so shard boundaries are not mistaken for frame edges."""
    h, w = cur_y.shape
    nby, nbx = h // 16, w // 16
    cy16 = cur_y.astype(jnp.int16)

    # ---- full-pel SAD volume --------------------------------------------------
    prevp = jnp.pad(prev_y_h[8 - yr:8 + h + yr], ((0, 0), (yr, yr))) \
        .astype(jnp.int16)
    sads = []
    for dy in range(-yr, yr + 1):
        for dx in range(-yr, yr + 1):
            win = jax.lax.dynamic_slice(prevp, (yr + dy, yr + dx), (h, w))
            d = jnp.abs(cy16 - win)
            sads.append(_block_reduce_matmul(d, 16))
    sad = jnp.stack(sads)                                   # (169, nby, nbx)

    n = 2 * yr + 1
    dyi = (jnp.arange(n * n) // n) - yr
    dxi = (jnp.arange(n * n) % n) - yr
    col = jnp.arange(nbx)
    row = jnp.arange(nby) + first_mb_row                    # global MB rows
    edge_l = (col == 0)[None, :]
    edge_r = (col == nbx - 1)[None, :]
    edge_t = (row == 0)[:, None]
    edge_b = (row == total_mb_rows - 1)[:, None]
    invalid = (edge_l[None] & (dxi < 0)[:, None, None]) \
        | (edge_r[None] & (dxi > 0)[:, None, None]) \
        | (edge_t[None] & (dyi < 0)[:, None, None]) \
        | (edge_b[None] & (dyi > 0)[:, None, None])
    invalid = invalid | (sad > 4095)                        # 12-bit overflow (RTL:1670)

    # tie-break: min SAD, then largest dy, then largest dx == largest linear index
    big = jnp.int32(1 << 24)
    key = jnp.where(invalid, big,
                    sad * (n * n) + (n * n - 1 - jnp.arange(n * n))[:, None, None])
    kmin = key.min(axis=0)
    lin = (n * n - 1) - (kmin % (n * n))
    center = yr * n + yr
    lin = jnp.where(kmin >= big, center, lin)               # all-invalid => mv (0,0)
    mvy_full = lin // n - yr                                # (nby, nbx)
    mvx_full = lin % n - yr

    # ---- intra activity metric (16-bit accumulator semantics) -----------------
    pixsum = _block_reduce_matmul(cur_y.astype(jnp.int16), 16)   # <= 65280
    mean = (pixsum >> 8) & 0xFF
    blk = cy16.reshape(nby, 16, nbx, 16).transpose(0, 2, 1, 3)   # (nby,nbx,16,16) i16
    sad_mean = jnp.sum(jnp.abs(blk - mean[:, :, None, None].astype(jnp.int16)),
                       axis=(2, 3), dtype=jnp.int32)
    acc = (pixsum + sad_mean) & 0xFFFF
    intra_cost = jnp.where(acc < 4096, acc, 0xFFF)

    # ---- recentring: every MB's 18x18 window at its own full-pel mv -----------
    # (gather-free REF_SHIFT analog: sliding windows + barrel selects)
    prevp8 = jnp.pad(prev_y_h, ((0, 0), (8, 8)))            # rows already halo'd
    t32 = _sliding_block_windows(prevp8, 16)
    # window starts at relative coord (mv - 1); rel -8 is window index 0
    w18 = _align_windows(t32, mvy_full, mvx_full, yr, 18, 7).astype(jnp.int16)

    def m2(a, b):                       # int16 mean2/mean4 (values <= 1021)
        return (1 + a + b) >> 1

    def m4_(a, b, c, d):
        return (jnp.int16(1) + a + b + c + d) >> 2

    full = w18
    hh = m2(w18[..., :, :-1], w18[..., :, 1:])              # (.., 18, 17)
    vv = m2(w18[..., :-1, :], w18[..., 1:, :])              # (.., 17, 18)
    m4 = m4_(w18[..., :-1, :-1], w18[..., :-1, 1:],
             w18[..., 1:, :-1], w18[..., 1:, 1:])           # (.., 17, 17)

    def cand_grid(hy: int, hx: int) -> jnp.ndarray:
        ry, rx = (hy + 1) >> 1, (hx + 1) >> 1
        if hy == 0 and hx == 0:
            return full[..., 1:17, 1:17]
        if hy == 0:
            return hh[..., 1:17, rx:rx + 16]
        if hx == 0:
            return vv[..., ry:ry + 16, 1:17]
        return m4[..., ry:ry + 16, rx:rx + 16]

    grids = [cand_grid(hy, hx) for hy in (-1, 0, 1) for hx in (-1, 0, 1)]
    over = jnp.int32(0x1000)
    vals = []
    for i9, (hy, hx) in enumerate([(hy, hx) for hy in (-1, 0, 1) for hx in (-1, 0, 1)]):
        s = jnp.sum(jnp.abs(blk - grids[i9]), axis=(2, 3), dtype=jnp.int32)
        bad = jnp.zeros((nby, nbx), bool)
        if hx < 0:
            bad |= edge_l | (mvx_full == -yr)
        if hx > 0:
            bad |= edge_r | (mvx_full == yr)
        if hy < 0:
            bad |= edge_t | (mvy_full == -yr)
        if hy > 0:
            bad |= edge_b | (mvy_full == yr)
        vals.append(jnp.where(bad | (s > 4095), over, s))
    vals.append(intra_cost)
    idx = _find_min_10(jnp.stack(vals, axis=-1))            # (nby, nbx) in 0..9

    inter = (idx != 9) & jnp.logical_not(is_iframe)
    hy_sel = jnp.where(idx == 9, 0, idx // 3 - 1)
    hx_sel = jnp.where(idx == 9, 0, idx % 3 - 1)
    # P-frame: mv registers always updated even when intra wins (RTL:1827-1828);
    # I-frame: forced zero (RTL:1820-1825).
    mvy = jnp.where(is_iframe, 0, (mvy_full << 1) + hy_sel)
    mvx = jnp.where(is_iframe, 0, (mvx_full << 1) + hx_sel)

    # ---- luma prediction: selected half-pel grid, or 128 for intra ------------
    pred_y = jnp.full((nby, nbx, 16, 16), 128, jnp.int16)
    for i9 in range(9):
        pred_y = jnp.where((inter & (idx == i9))[:, :, None, None], grids[i9], pred_y)
    pred_y = pred_y.astype(jnp.int32)

    return MotionResult(inter, mvx, mvy, pred_y,
                        _chroma_pred_h(prev_u_h, inter, mvx, mvy, ur),
                        _chroma_pred_h(prev_v_h, inter, mvx, mvy, ur))


def _chroma_pred_h(plane_h: jnp.ndarray, inter: jnp.ndarray,
                   mvx: jnp.ndarray, mvy: jnp.ndarray, ur: int) -> jnp.ndarray:
    """Chroma prediction: luma mv halved, own half-pel interp (RTL:1847-1917).
    plane_h arrives with a 4-row halo each side (zero at frame edges)."""
    cfy, cfx = mvy >> 2, mvx >> 2                           # full-pel chroma offset
    chy, chx = (mvy >> 1) & 1, (mvx >> 1) & 1
    pp = jnp.pad(plane_h, ((0, 0), (4, 4)))
    t16 = _sliding_block_windows(pp, 8)                     # (nby, nbx, 16, 16)
    w9 = _align_windows(t16, cfy, cfx, ur, 9, 4).astype(jnp.int16)
    p00 = w9[..., :8, :8]
    ph = (1 + w9[..., :8, :8] + w9[..., :8, 1:9]) >> 1
    pv = (1 + w9[..., :8, :8] + w9[..., 1:9, :8]) >> 1
    pm = (jnp.int16(1) + w9[..., :8, :8] + w9[..., :8, 1:9]
          + w9[..., 1:9, :8] + w9[..., 1:9, 1:9]) >> 2
    hyb = chy[:, :, None, None].astype(bool)
    hxb = chx[:, :, None, None].astype(bool)
    p = jnp.where(hyb & hxb, pm, jnp.where(hxb, ph, jnp.where(hyb, pv, p00)))
    return jnp.where(inter[:, :, None, None], p, jnp.int16(128)).astype(jnp.int32)
