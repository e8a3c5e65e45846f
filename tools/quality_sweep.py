#!/usr/bin/env python3
"""Quality/size sweep: PSNR and bitrate across q_level and vector_level.

The reference publishes one compression/quality datapoint (README.md:739-750:
1440x704 clip, VECTOR_LEVEL=3, Q_LEVEL=2 -> 775,456 B at 43.33 dB).  Its fixture
clips are not available in this environment (SIM/data.zip is a missing large
blob), so this sweep uses deterministic synthetic content with natural-ish
statistics (smooth gradients + mild texture + global pan) and reports the same
metrics.  Writes docs/QUALITY.md.

Run: python tools/quality_sweep.py
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np

from bench import make_frames
from fpga_mpeg2_encoder_tpu import Encoder, EncoderConfig
from fpga_mpeg2_encoder_tpu.golden import decoder as D
from fpga_mpeg2_encoder_tpu.golden.encoder import subsample_420
from fpga_mpeg2_encoder_tpu.utils.logging import psnr


def main():
    w, h, nf = 320, 192, 12
    frames = make_frames(w, h, nf)
    srcs = [subsample_420(*f) for f in frames]
    raw_bytes = nf * w * h * 3

    rows = []
    for q in (1, 2, 3, 4):
        for vl in (1, 3):
            cfg = EncoderConfig(xl=5, yl=5, vector_level=vl, q_level=q)
            stream = Encoder(cfg).encode(frames, w, h, pframes_count=11)
            dec = D.decode_sequence(stream, cfg)
            ps = [psnr(p.y, s[0]) for p, s in zip(dec.pictures, srcs)]
            rows.append((q, vl, len(stream), raw_bytes / len(stream),
                         float(np.mean(ps)), float(np.min(ps))))
            print(rows[-1], flush=True)

    with open(os.path.join(ROOT, "docs", "QUALITY.md"), "w") as f:
        f.write(
"""# Quality / compression sweep

Metrics of this framework across its quality knobs, measured with
`tools/quality_sweep.py` on deterministic synthetic content (smooth gradient +
texture + global pan, 320x192, 12 frames, IPPP GOP of 12).  Streams are decoded
with the in-repo conformance decoder; PSNR-Y is against the 4:2:0 source.

The reference's single published datapoint for context (natural 1440x704 clip,
not available in this environment): VECTOR_LEVEL=3, Q_LEVEL=2 -> 43.1:1
compression at 43.33 dB (README.md:744-748).  Because every stream this
framework produces is bit-identical to the reference datapath's output, its
rate/quality trade-off on any clip is identical to the reference by
construction; this table characterises the shared behaviour.

| q_level | vector_level | stream bytes | compression | PSNR-Y mean | PSNR-Y min |
|---|---|---|---|---|---|
""")
        for q, vl, nb, ratio, pm, pmin in rows:
            f.write(f"| {q} | {vl} | {nb} | {ratio:.1f}:1 | {pm:.2f} dB"
                    f" | {pmin:.2f} dB |\n")
        f.write(
"""
Expected shape: higher q_level -> smaller streams, lower PSNR; a wider motion
search (vector_level 3 vs 1) buys bitrate on panning content at identical
quality (prediction residuals shrink; the quantiser is unchanged).
""")
    print("wrote docs/QUALITY.md")


if __name__ == "__main__":
    main()
