"""Forward DCT + quantise and dequantise + inverse DCT, batched over tiles.

Design notes
------------
* Everything runs in coefficient-major layout ``(64, N)``: the tile axis (millions
  of elements) is the minor, contiguous axis, while the 64 coefficient positions
  index the major axis.  Butterfly slices like x[k] are then full (N,)-wide
  vector ops instead of 8-wide ones.
* The reference's stage-G DCT (RTL/mpeg2encoder.v:2025-2062) keeps phase 1 at full
  precision and rounds once after phase 2, so the whole 2-D transform is ONE exact
  64x64 integer matmul: F = DCT64 @ X.  We split DCT64 = 128*HI + LO (|HI|<=62,
  0<=LO<=127) so each half runs as an exact bf16 matmul with f32 accumulation
  (every partial sum stays below 2^24), recombined in int32.
* The quantisers (RTL:2064-2077, 2128-2150) are elementwise integer ops with the
  reference's exact 16-bit wrap semantics; the intra division by the quantiser
  matrix runs as float32 reciprocal multiplication + floor, which is exact for
  the full 16-bit dividend range (validated exhaustively in tests).
* The inverse DCT is the reference's fixed-point Chen-Wang pipeline
  (RTL:843-972) with its 18-bit row truncations and 32-bit wrap semantics; it is
  NOT a linear map, so it runs as vectorised int32 butterflies.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..core import tables as T

# bf16 inputs are exact here: residuals are integers in [-255, 255] and bf16
# represents all integers of magnitude <= 256; LO in [0,127], |HI| <= 62;
# accumulation is f32 (every partial sum < 2^24, also exact).  No f32 operand
# ever reaches a matmul, so TF32 rounding cannot enter.
# The matrices are embedded block-diagonally 8x (kron(I8, M)) and the N axis is
# folded 8-way into the contraction: a (512,512)@(512,N/8) product instead of a
# thin (64,64)@(64,N) one.
# Constants are kept as NUMPY arrays and converted inside the traced functions,
# so they embed as program literals.
_DCT64_LO_NP = np.kron(np.asarray(T.DCT64_LO), np.eye(8)).astype(np.float32)  # (512, 512)
_DCT64_HI_NP = np.kron(np.asarray(T.DCT64_HI), np.eye(8)).astype(np.float32)
_INTRA_Q_COL_NP = np.asarray(T.INTRA_Q).reshape(64, 1).astype(np.int32)
# reciprocal biased up by (1 + 2^-21) so exact multiples k*w never floor to k-1;
# the overshoot (< 2^-21 * 2^13) stays far below the 1/83 quotient-boundary gap
_INTRA_Q_RECIP_NP = ((1.0 + 2.0 ** -21)
                     / np.asarray(T.INTRA_Q, np.float32).reshape(64, 1))

W1, W2, W3, W5, W6, W7 = T.W1, T.W2, T.W3, T.W5, T.W6, T.W7


def fdct(resid: jnp.ndarray) -> jnp.ndarray:
    """(64, N) int32 residual tiles, coefficient-major (|x| <= 255) ->
    (64, N) int32 stage-G DCT output.

    Exact: round((M @ X @ M^T)/4096) with 17-bit wrap (RTL:2058-2059)."""
    n = resid.shape[1]
    n8 = -(-n // 8) * 8
    x = resid.astype(jnp.bfloat16)
    if n8 != n:
        x = jnp.pad(x, ((0, 0), (0, n8 - n)))
    # fold 8 column chunks into the row axis by plain row-major reshape:
    # (64, n8) -> (512, n8/8) puts coefficient i, chunk g at row 8i+g, matching
    # the kron(M, I8) block structure - no transpose needed
    x = x.reshape(512, n8 // 8)
    t_hi = jnp.asarray(_DCT64_HI_NP, dtype=jnp.bfloat16)
    t_lo = jnp.asarray(_DCT64_LO_NP, dtype=jnp.bfloat16)
    hi = jnp.dot(t_hi, x, preferred_element_type=jnp.float32)
    lo = jnp.dot(t_lo, x, preferred_element_type=jnp.float32)
    t = hi.astype(jnp.int32) * 128 + lo.astype(jnp.int32)
    r = (t >> 12) + ((t >> 11) & 1)
    r = ((r & 0x1FFFF) ^ 0x10000) - 0x10000
    return r.reshape(64, n8)[:, :n]


def quantize(res3: jnp.ndarray, inter: jnp.ndarray, q_level: int) -> jnp.ndarray:
    """(64, N) coefficients + (N,) bool inter -> (64, N) quantised (RTL:2064-2077)."""
    a = jnp.abs(res3) & 0xFFFF
    q_inter = ((a + 2) & 0xFFFF) >> (4 + q_level)
    iq_col = jnp.asarray(_INTRA_Q_COL_NP)
    off = (iq_col * ((3 << q_level) + 2)) >> 3
    t = ((a + off) & 0xFFFF) >> q_level
    # exact integer division by the quantiser matrix: t < 2^16 and 1/w has
    # relative error ~2^-23, far below the 1/83 distance to a quotient boundary
    q_intra = jnp.floor(t.astype(jnp.float32)
                        * jnp.asarray(_INTRA_Q_RECIP_NP)).astype(jnp.int32)
    dc_intra = (a >> 4) + ((a >> 3) & 1)
    is_dc = (jnp.arange(64) == 0)[:, None]
    q_intra = jnp.where(is_dc, dc_intra, q_intra)
    q = jnp.where(inter[None, :], q_inter, q_intra)
    q = jnp.minimum(q, 2047)
    return jnp.where(res3 < 0, -q, q)


def dequantize(q: jnp.ndarray, inter: jnp.ndarray, q_level: int) -> jnp.ndarray:
    """(64, N) quantised -> (64, N) reconstruction-loop coefficients (RTL:2128-2150)."""
    x2 = q * 2
    xi = (x2 + jnp.sign(x2)) << q_level
    xi = jnp.clip(xi, -2047, 2047)
    xa = q * jnp.asarray(_INTRA_Q_COL_NP)
    if q_level >= 3:
        xa = xa << (q_level - 3)
    else:
        xa = xa >> (3 - q_level)
    xa = jnp.clip(xa, -2047, 2047)
    is_dc = (jnp.arange(64) == 0)[:, None]
    xa = jnp.where(is_dc, q * 2, xa)
    return jnp.where(inter[None, :], xi, xa)


def _cw_stage(a, rounding: bool):
    """One Chen-Wang butterfly stage; ``a`` is a list of 8 (N,)-wide int32 lanes.

    rounding=False: row pass (RTL:844-905); True: column pass (RTL:911-970)."""
    x0, x1, x2, x3 = a[0], a[4], a[6], a[2]
    x4, x5, x6, x7 = a[1], a[7], a[5], a[3]
    if not rounding:
        x0 = (x0 << 11) | 128
        x1 = x1 << 11
        r4, sh = 0, 0
    else:
        x0 = (x0 << 8) + 8192
        x1 = x1 << 8
        r4, sh = 4, 3
    x8 = W7 * (x4 + x5) + r4
    x4 = (x8 + (W1 - W7) * x4) >> sh
    x5 = (x8 - (W1 + W7) * x5) >> sh
    x8 = W3 * (x6 + x7) + r4
    x6 = (x8 - (W3 - W5) * x6) >> sh
    x7 = (x8 - (W3 + W5) * x7) >> sh
    x8 = x0 + x1
    x0 = x0 - x1
    x1 = W6 * (x3 + x2) + r4
    x2 = (x1 - (W2 + W6) * x2) >> sh
    x3 = (x1 + (W2 - W6) * x3) >> sh
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
    fs = 8 if not rounding else 14
    return [(x7 + x1) >> fs, (x3 + x2) >> fs, (x0 + x4) >> fs, (x8 + x6) >> fs,
            (x8 - x6) >> fs, (x0 - x4) >> fs, (x3 - x2) >> fs, (x7 - x1) >> fs]


def _trunc18(v: jnp.ndarray) -> jnp.ndarray:
    return ((v & 0x3FFFF) ^ 0x20000) - 0x20000


def idct(iq: jnp.ndarray) -> jnp.ndarray:
    """(64, N) int32 dequantised coefficients, coefficient-major (row-major 8x8
    positions along axis 0) -> (64, N) residual in [-255, 255].

    Every butterfly lane is a full-width (N,) vector; the 8x8 structure is just
    index bookkeeping on axis 0 - no 8-wide arrays, no transposes."""
    n = iq.shape[1]
    g = iq.reshape(8, 8, n)
    # row pass: for each row i, lanes are the 8 column positions
    rows_out = [None] * 8
    for i in range(8):
        rows_out[i] = [_trunc18(v) for v in
                       _cw_stage([g[i, k] for k in range(8)], rounding=False)]
    # column pass: for each column j, lanes are the 8 row positions
    out = [None] * 64
    for j in range(8):
        col = _cw_stage([rows_out[i][j] for i in range(8)], rounding=True)
        for i in range(8):
            out[i * 8 + j] = jnp.clip(col[i], -255, 255)
    return jnp.stack(out, axis=0)
