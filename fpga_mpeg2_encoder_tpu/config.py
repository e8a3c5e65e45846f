"""Encoder configuration.

Mirrors the reference's two-tier config system (RTL/mpeg2encoder.v:10-14 compile-time
parameters vs :16-22 per-sequence ports):

* ``EncoderConfig`` - construction-time, shape-static knobs.  These bake array
  shapes and search-window sizes into the jitted programs (the analog of Verilog
  parameters XL/YL/VECTOR_LEVEL/Q_LEVEL sizing BRAMs and SAD arrays).
* ``SequenceConfig`` - per-sequence runtime settings, latched at sequence start
  (the analog of i_xsize16/i_ysize16/i_pframes_count, RTL/mpeg2encoder.v:1060-1068).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Static configuration (jit-shape-defining)."""

    xl: int = 6               # max width  = 16 << xl   (4..7)
    yl: int = 6               # max height = 16 << yl   (4..7)
    vector_level: int = 3     # chroma MV range UR = vector_level; luma YR = 2*UR  (1..3)
    q_level: int = 2          # quantiser coarseness (1..4)

    def __post_init__(self) -> None:
        if not 4 <= self.xl <= 7:
            raise ValueError(f"xl must be in 4..7, got {self.xl}")
        if not 4 <= self.yl <= 7:
            raise ValueError(f"yl must be in 4..7, got {self.yl}")
        if self.vector_level not in (1, 2, 3):
            raise ValueError(f"vector_level must be 1, 2 or 3, got {self.vector_level}")
        if self.q_level not in (1, 2, 3, 4):
            raise ValueError(f"q_level must be 1..4, got {self.q_level}")

    @property
    def max_width(self) -> int:
        return 16 << self.xl

    @property
    def max_height(self) -> int:
        return 16 << self.yl

    @property
    def ur(self) -> int:
        """Chroma full-pel motion range (+-UR), RTL/mpeg2encoder.v:71."""
        return self.vector_level

    @property
    def yr(self) -> int:
        """Luma full-pel motion range (+-YR), RTL/mpeg2encoder.v:72."""
        return 2 * self.vector_level


@dataclasses.dataclass(frozen=True)
class SequenceConfig:
    """Per-sequence runtime configuration (latched at sequence start)."""

    width: int                # pixels, multiple of 16, 64..max_width
    height: int               # pixels, multiple of 16, 64..max_height
    pframes_count: int = 23   # P-frames between I-frames (0..255)

    def validate(self, enc: EncoderConfig) -> "SequenceConfig":
        """Clamp like the RTL does (RTL/mpeg2encoder.v:985-991): sizes out of range are
        clamped to [64, max]; non-multiples of 16 are a hard error (the RTL cannot even
        express them - i_xsize16 is in units of 16)."""
        if self.width % 16 or self.height % 16:
            raise ValueError("width/height must be multiples of 16")
        if not 0 <= self.pframes_count <= 255:
            raise ValueError("pframes_count must be 0..255")
        w = min(max(self.width, 64), enc.max_width)
        h = min(max(self.height, 64), enc.max_height)
        if (w, h) != (self.width, self.height):
            return dataclasses.replace(self, width=w, height=h)
        return self

    @property
    def mb_cols(self) -> int:
        return self.width // 16

    @property
    def mb_rows(self) -> int:
        return self.height // 16
