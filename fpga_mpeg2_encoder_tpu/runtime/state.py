"""Encoder state as an explicit, checkpointable object.

The reference has no checkpointing; its closest concept is per-sequence restart
(SEQ_IDLE, RTL/mpeg2encoder.v:1045-1047) and its only recovery mechanism is full
reset (README.md:96).  SURVEY.md section 5 defines the device-side equivalent: the
full inter-frame state is tiny and explicit - the reconstructed reference frame,
the GOP index, the timecode/frame counter, and the bytes emitted so far (entropy
predictors reset per slice and carry nothing across frames).  This module
captures it as a plain pytree so an arbitrarily long stream can checkpoint
between any two frames and resume bit-exactly, including across processes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class EncoderState:
    """Complete inter-frame state of one active sequence."""

    width: int
    height: int
    pframes_count: int
    i_frame: int                 # GOP position of the NEXT frame
    frame_no: int                # frames encoded so far (drives the timecode)
    recon_y: Optional[np.ndarray]    # previous reconstruction (None before frame 0)
    recon_u: Optional[np.ndarray]
    recon_v: Optional[np.ndarray]
    payload: bytes               # byte-exact stream emitted so far (headers incl.)

    def save(self, path: str) -> None:
        none = np.zeros(0, np.uint8)
        np.savez_compressed(
            path,
            meta=np.array([self.width, self.height, self.pframes_count,
                           self.i_frame, self.frame_no,
                           0 if self.recon_y is None else 1], np.int64),
            recon_y=none if self.recon_y is None else self.recon_y,
            recon_u=none if self.recon_u is None else self.recon_u,
            recon_v=none if self.recon_v is None else self.recon_v,
            payload=np.frombuffer(self.payload, np.uint8),
        )

    @classmethod
    def load(cls, path: str) -> "EncoderState":
        z = np.load(path)
        w, h, pf, i_f, fno, has = (int(x) for x in z["meta"])
        return cls(
            width=w, height=h, pframes_count=pf, i_frame=i_f, frame_no=fno,
            recon_y=z["recon_y"] if has else None,
            recon_u=z["recon_u"] if has else None,
            recon_v=z["recon_v"] if has else None,
            payload=z["payload"].tobytes(),
        )
