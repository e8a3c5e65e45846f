"""Constant tables of the MPEG-2 encoder (numpy form).

Every table mirrors a LUT of the reference design:
  DCTM        RTL/mpeg2encoder.v:102-112   integer DCT basis (DCTP=0 variant)
  INTRA_Q     RTL/mpeg2encoder.v:130-138   ISO default intra quantiser matrix
  ZIGZAG      RTL/mpeg2encoder.v:155-163   zig-zag scan order
  W1..W7      RTL/mpeg2encoder.v:169-174   Chen-Wang IDCT constants
  VLC tables  RTL/mpeg2encoder.v:178-740   ISO 13818-2 tables B.9/B.10/B.12/B.13/B.14

Derived, framework-specific layouts (not in the reference, built for vectorised use):
  DCT64_HI/DCT64_LO : the 2-D DCT as a single exact 64x64 integer matrix, split into
                      7-bit halves so each half-matmul is exact (bf16 operands, f32 sums).
  AC_CODE/AC_LEN    : dense (33, 41) run/level -> (code<<1 | needs-sign, bits) lookup,
                      entry invalid (use 24-bit escape) where AC_VALID is 0.
"""
from __future__ import annotations

import numpy as np

from . import _vlc_data as _d

# ---------------------------------------------------------------------------
# transform / quantiser constants
# ---------------------------------------------------------------------------
DCTM = np.array(_d.DCTM, dtype=np.int32)                      # (8, 8)
INTRA_Q = np.array(_d.INTRA_Q, dtype=np.int32)                # (8, 8)
ZIGZAG = np.array(_d.ZIGZAG, dtype=np.int32)                  # (8, 8) raster -> zigzag pos

# permutation arrays: zig[ZIGZAG_FLAT[k]] = raster_flat[k]
ZIGZAG_FLAT = ZIGZAG.reshape(64)
# inverse: raster index of zig position z
ZIGZAG_INV = np.argsort(ZIGZAG_FLAT)                          # zig[z] = raster_flat[ZIGZAG_INV[z]]

W1, W2, W3, W5, W6, W7 = 2841, 2676, 2408, 1609, 1108, 565    # 2048*sqrt(2)*cos(k*pi/16)

# 2-D forward DCT as one 64x64 integer matrix: F2d = M @ X @ M^T has no intermediate
# rounding in the reference (phase-1 result g_dct_res1 is kept at full precision,
# RTL/mpeg2encoder.v:2029-2057), so F2d.flat = kron(M, M) @ X.flat exactly.
DCT64 = np.kron(DCTM, DCTM).astype(np.int64)                  # (64, 64), entries in [-7921, 7921]
# split into halves that keep every f32 matmul partial sum below 2^24 (exact):
#   |x| <= 255, |lo| < 128, |hi| <= 62  ->  255*127*64 = 2.07e6 < 2^24.
DCT64_LO = (DCT64 & 127).astype(np.int32)                     # in [0, 127]
DCT64_HI = ((DCT64 - (DCT64 & 127)) >> 7).astype(np.int32)    # DCT64 = HI*128 + LO

# ---------------------------------------------------------------------------
# VLC tables (uint32 codes, int32 lengths)
# ---------------------------------------------------------------------------
BITS_MOTION_VECTOR = np.array(_d.BITS_MOTION_VECTOR, dtype=np.uint32)   # (17,)
LENS_MOTION_VECTOR = np.array(_d.LENS_MOTION_VECTOR, dtype=np.int32)
BITS_NZ_FLAGS = np.array(_d.BITS_NZ_FLAGS, dtype=np.uint32)             # (64,) CBP codes
LENS_NZ_FLAGS = np.array(_d.LENS_NZ_FLAGS, dtype=np.int32)
BITS_DC_Y = np.array(_d.BITS_DC_Y, dtype=np.uint32)                     # (12,) dct_dc_size luma
LENS_DC_Y = np.array(_d.LENS_DC_Y, dtype=np.int32)
BITS_DC_UV = np.array(_d.BITS_DC_UV, dtype=np.uint32)                   # (12,) chroma
LENS_DC_UV = np.array(_d.LENS_DC_UV, dtype=np.int32)

_BITS_AC_0_3 = np.array(_d.BITS_AC_0_3, dtype=np.uint32)                # (4, 40)
_LENS_AC_0_3 = np.array(_d.LENS_AC_0_3, dtype=np.int32)
_BITS_AC_4_31 = np.array(_d.BITS_AC_4_31, dtype=np.uint32)              # (32, 3)
_LENS_AC_4_31 = np.array(_d.LENS_AC_4_31, dtype=np.int32)

# Dense combined AC table, indexed [run (0..32 clipped), absvm1 (0..40 clipped)].
# Exact validity predicate of put_AC (RTL/mpeg2encoder.v:2535-2540):
#   run==0 & absvm1<40 | run==1 & absvm1<18 | run==2 & absvm1<5 | run==3 & absvm1<4
#   | run<=6 & absvm1<3 | run<=16 & absvm1<2 | run<=31 & absvm1<1
AC_CODE = np.zeros((33, 41), dtype=np.uint32)   # table code WITHOUT the sign bit
AC_LEN = np.zeros((33, 41), dtype=np.int32)     # table length WITHOUT the sign bit
AC_VALID = np.zeros((33, 41), dtype=bool)
for _r in range(32):
    for _a in range(41):
        if (_r == 0 and _a < 40) or (_r == 1 and _a < 18) or (_r == 2 and _a < 5) \
           or (_r == 3 and _a < 4):
            AC_CODE[_r, _a] = _BITS_AC_0_3[_r, _a]
            AC_LEN[_r, _a] = _LENS_AC_0_3[_r, _a]
            AC_VALID[_r, _a] = True
        elif (_r <= 6 and _a < 3) or (_r <= 16 and _a < 2) or (_r <= 31 and _a < 1):
            AC_CODE[_r, _a] = _BITS_AC_4_31[_r, _a]
            AC_LEN[_r, _a] = _LENS_AC_4_31[_r, _a]
            AC_VALID[_r, _a] = True

__all__ = [
    "DCTM", "INTRA_Q", "ZIGZAG", "ZIGZAG_FLAT", "ZIGZAG_INV",
    "W1", "W2", "W3", "W5", "W6", "W7",
    "DCT64", "DCT64_LO", "DCT64_HI",
    "BITS_MOTION_VECTOR", "LENS_MOTION_VECTOR",
    "BITS_NZ_FLAGS", "LENS_NZ_FLAGS",
    "BITS_DC_Y", "LENS_DC_Y", "BITS_DC_UV", "LENS_DC_UV",
    "AC_CODE", "AC_LEN", "AC_VALID",
]
