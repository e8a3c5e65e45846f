#!/usr/bin/env python3
"""GOP-scale chunked-path soak (VERDICT r04 item 8).

The round-4 silent append corruption lived exactly at the chunked /
steady-state boundary (docs/STATUS.md "Found on-chip" item 1) and was
caught only by on-chip divergence.  This soak cements the fix at real
scale: encode a long 1080p sequence through the PUBLIC chunked API twice
with different chunkings (boundaries landing both on and off GOP edges),
require byte identity, and structurally validate the stream (start-code
census + sequence-end + 32-byte alignment).  Prints the SHA-256 payload
digest for the reval log.

Env knobs: SOAK_W/H (1920x1152), SOAK_NF (384), SOAK_CHUNKS ("96,64").
Runtime is dominated by host->device frame staging.
"""
import hashlib
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np

W = int(os.environ.get("SOAK_W", "1920"))
H = int(os.environ.get("SOAK_H", "1152"))
NF = int(os.environ.get("SOAK_NF", "384"))
CHUNKS = tuple(int(c) for c in os.environ.get("SOAK_CHUNKS", "96,64").split(","))
PFRAMES = int(os.environ.get("SOAK_PFRAMES", "23"))


def main():
    import jax


    from bench import make_frames
    from fpga_mpeg2_encoder_tpu import Encoder, EncoderConfig
    from fpga_mpeg2_encoder_tpu.golden.validator import validate_sequence

    print(f"device: {jax.devices()[0].device_kind}  {W}x{H} NF={NF} "
          f"chunks={CHUNKS} pframes={PFRAMES}", flush=True)
    frames = make_frames(W, H, NF)

    streams = []
    for ch in CHUNKS:
        xl = max(4, (W - 1).bit_length() - 4)     # 16 << xl >= W
        yl = max(4, (H - 1).bit_length() - 4)
        enc = Encoder(EncoderConfig(xl=xl, yl=yl), row_cap=4096,
                      frame_cap=262144)
        t0 = time.perf_counter()
        b = enc.encode(frames, W, H, pframes_count=PFRAMES, chunk_frames=ch)
        dt = time.perf_counter() - t0
        dig = hashlib.sha256(b).hexdigest()
        print(f"chunk={ch:4d}: {len(b)} bytes  sha256={dig[:16]}  "
              f"{W * H * NF / dt / 1e6:.1f} MP/s wall (incl. staging)",
              flush=True)
        streams.append((ch, b, dig))

    ch0, b0, d0 = streams[0]
    for ch, b, d in streams[1:]:
        assert b == b0, f"chunk={ch} diverges from chunk={ch0}"
    print(f"byte-identity across chunkings: OK ({len(streams)} encodings)")

    # structural census (full ISO validation at this scale is host-bound;
    # the syntax walk below covers the container invariants the soak is for)
    assert b0[:4] == bytes.fromhex("000001B3")
    npics = b0.count(bytes.fromhex("00000100"))
    assert npics == NF, f"picture start codes {npics} != {NF}"
    end = b0.rfind(bytes.fromhex("000001B7"))
    assert end >= 0 and set(b0[end + 4:]) <= {0} and len(b0) % 32 == 0
    ngop = b0.count(bytes.fromhex("000001B8"))
    assert ngop == (NF + PFRAMES) // (PFRAMES + 1), ngop
    if os.environ.get("SOAK_VALIDATE", "") == "1":
        v = validate_sequence(b0, expected_frames=NF)
        print(f"ISO validation: {len(v.pictures)} pictures OK")
    print(f"SOAK OK  digest={d0}")


if __name__ == "__main__":
    main()
