#!/usr/bin/env python3
"""Reference-geometry quality datapoint (VERDICT round-2 missing item 3).

The reference's only published compression/quality number is a natural
1440x704 clip at the testbench parameters - VECTOR_LEVEL=3, Q_LEVEL=2,
GOP g=24 -> 775,456 B at 43.33 dB (README.md:744-748).  Its clip is not in
this environment (SIM/data.zip missing), so this tool produces the directly
comparable row on the procedurally filmic clip (bench.make_filmic_frames:
multi-octave value noise, slow pan, moving soft object, film grain - natural
low-frequency-dominated statistics):

* encode 24 frames, 1440x704, vl=3 q=2, pframes_count=23 (one I + 23 P);
* PSNR-Y against the 4:2:0 source, computed from the encoder's recon planes
  (bit-identical to any conformant decoder's output - the recon/decode
  equality is pinned by tests/test_golden.py and the validator suite);
* the stream is checked by the INDEPENDENT ISO validator (golden/validator
  .py - full syntax validation + spec-formula decode sharing no code with
  the encoder).

Appends the row to docs/QUALITY.md.  Run: python tools/quality_filmic.py
(CPU-safe; uses whatever backend is default).
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np


def main():
    import jax
    import os
    if os.environ.get("FPGA_MPEG2_BENCH_BACKEND") == "cpu":
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from bench import make_filmic_frames
    from fpga_mpeg2_encoder_tpu import Encoder, EncoderConfig
    from fpga_mpeg2_encoder_tpu.golden.encoder import subsample_420
    from fpga_mpeg2_encoder_tpu.models.encoder import encode_frame_device
    from fpga_mpeg2_encoder_tpu.utils.logging import psnr

    w, h, nf = 1440, 704, 24
    cfg = EncoderConfig(xl=7, yl=6, vector_level=3, q_level=2)
    frames = make_filmic_frames(w, h, nf)
    srcs = [subsample_420(*f) for f in frames]
    raw_bytes = nf * w * h * 3

    enc = Encoder(cfg)
    kw = dict(yr=cfg.yr, ur=cfg.ur, q_level=cfg.q_level,
              row_cap=2048, frame_cap=65536)
    prev = (jnp.zeros((h, w), jnp.uint8),
            jnp.zeros((h // 2, w // 2), jnp.uint8),
            jnp.zeros((h // 2, w // 2), jnp.uint8))
    payloads = []
    ps = []
    i_f = 0
    for fi, (y, u, v) in enumerate(frames):
        t0 = time.time()
        ry, ru, rv, fw, fb, ovf = encode_frame_device(
            jnp.asarray(y), jnp.asarray(u), jnp.asarray(v), *prev,
            jnp.int32(i_f), jnp.int32(fi), **kw)
        assert not bool(ovf)
        from fpga_mpeg2_encoder_tpu.models.encoder import words_to_bytes
        payloads.append(words_to_bytes(np.asarray(fw), int(fb)))
        prev = (ry, ru, rv)
        ps.append(psnr(np.asarray(ry), srcs[fi][0]))
        i_f = 0 if i_f >= 23 else i_f + 1
        print(f"frame {fi}: {len(payloads[-1])} B psnr {ps[-1]:.2f} "
              f"({time.time()-t0:.1f}s)", flush=True)

    from fpga_mpeg2_encoder_tpu.core.bitstream import (
        BitWriter, sequence_header_chunks, SEQUENCE_END_CHUNKS)
    bw = BitWriter()
    bw.put_chunks(sequence_header_chunks(w, h))
    stream = bw.to_bytes_aligned() + b"".join(payloads)
    bw2 = BitWriter()
    bw2.put_chunks(SEQUENCE_END_CHUNKS)
    stream += bw2.to_bytes_aligned()
    stream += b"\x00" * ((len(stream) // 32 + 1) * 32 - len(stream))

    print(f"stream: {len(stream)} B  compression {raw_bytes/len(stream):.1f}:1"
          f"  PSNR-Y mean {np.mean(ps):.2f} dB  min {np.min(ps):.2f} dB",
          flush=True)

    # independent ISO validation (syntax + spec-formula decode)
    from fpga_mpeg2_encoder_tpu.golden.validator import validate_sequence
    vs = validate_sequence(stream, expected_frames=nf)
    vps = [psnr(vp.y, np.asarray(s[0]))
           for vp, s in zip(vs.pictures, srcs)]
    print(f"validator: {len(vs.pictures)} pictures, PSNR-Y vs source "
          f"mean {np.mean(vps):.2f} dB", flush=True)

    row = (f"\n## Reference-geometry filmic datapoint\n\n"
           f"24 frames, 1440x704 procedurally filmic content "
           f"(bench.make_filmic_frames), testbench parameters "
           f"(VECTOR_LEVEL=3, Q_LEVEL=2, GOP 24 = I+23P), mirroring the "
           f"reference's published row (775,456 B at 43.33 dB on its natural "
           f"clip, README.md:744-748):\n\n"
           f"| clip | stream bytes | compression | PSNR-Y mean | PSNR-Y min |\n"
           f"|---|---|---|---|---|\n"
           f"| filmic 1440x704x24 | {len(stream)} | "
           f"{raw_bytes/len(stream):.1f}:1 | {np.mean(ps):.2f} dB | "
           f"{np.min(ps):.2f} dB |\n\n"
           f"PSNR-Y is against the 4:2:0 source from the recon planes (bit-"
           f"identical to a conformant decoder's output); the stream passes "
           f"the independent ISO validator (golden/validator.py).  Content "
           f"differs from the reference's clip (unavailable here), so the "
           f"numbers bracket, not reproduce, its row; bit-identity of the "
           f"datapath makes the rate/quality trade-off identical by "
           f"construction on any shared clip.\n")
    with open(os.path.join(ROOT, "docs", "QUALITY.md"), "a") as f:
        f.write(row)
    print("appended to docs/QUALITY.md", flush=True)


if __name__ == "__main__":
    main()
