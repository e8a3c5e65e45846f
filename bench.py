#!/usr/bin/env python3
"""Headline benchmark: 1920x1152 IPPP encode throughput on one NVIDIA GPU.

Prints ONE JSON line: {"metric": ..., "value": N, "unit": "MPixels/s",
"vs_baseline": N, "device": {...}, "card": ...}.  Baseline = the reference
FPGA's 268 MPixels/s (4 px/cycle @ 67 MHz, README.md:20-22; BASELINE.md).
Exits non-zero, printing no result, when JAX's first device is not a GPU.

Methodology: frames are staged in device memory before timing, so the
host link is excluded.  The timed region is the full device pipeline -
subsample, motion search, DCT/quant, reconstruction, entropy symbolisation and
bit packing into the final byte-exact payload - over a whole GOP via lax.scan,
steady-state, after jit warm-up.  The payload is downloaded and validated after
timing.
"""
import hashlib
import json
import os
import sys
import time

import numpy as np

# sha256 of the bench payload (warm-up rep: seed-42 frames, nf=96, 1920x1152,
# vl=3 q=2, row_cap=4096/frame_cap=262144/seq_cap=8388608).  The encoder is
# bit-exact on every backend, so one digest validates them all; regenerate
# with `python bench.py --digest` after an intentional stream change.
PAYLOAD_SHA256 = "434a187418aa943fc39ccd5b5949f198ed835b9b790151777c36e40c82cf475a"

W, H, NF = 1920, 1152, 96
# the synthetic texture is entropy-heavy (~750 KB I-frames at q_level=2), so
# budget caps are sized for it: 16 KB/slice, 1 MB/frame, 32 MB for the run
CAPS = dict(row_cap=4096, frame_cap=262144, seq_cap=8388608)


def make_frames(w, h, n):
    rng = np.random.default_rng(42)
    pad = 64
    yy, xx = np.mgrid[0:h + pad, 0:w + pad]
    tex = rng.integers(0, 48, (h + pad, w + pad)).astype(np.int32)
    y = (((xx * 3 + yy * 2) // 4) % 200 + tex).astype(np.uint8)
    u = ((xx - yy) // 3 % 160 + 48).astype(np.uint8)
    v = ((xx + yy) // 5 % 120 + 64).astype(np.uint8)
    out = []
    for i in range(n):
        dy, dx = (i * 2) % pad, (i * 3) % pad
        out.append((y[dy:dy + h, dx:dx + w].copy(),
                    u[dy:dy + h, dx:dx + w].copy(),
                    v[dy:dy + h, dx:dx + w].copy()))
    return out


def make_filmic_frames(w, h, n, seed=7):
    """Procedurally filmic clip: multi-octave smooth luminance (value noise),
    a slow camera pan, an independently moving soft-edged object, and film
    grain.  Spatial statistics (strong low-frequency energy, sparse detail)
    are close to natural video, unlike the entropy-heavy gradient+texture
    content of make_frames - this derisks the entropy-stage budget against
    real-world material (VERDICT round-1 weak item 8)."""
    rng = np.random.default_rng(seed)
    pad = 128

    def octave(cell, amp):
        gh, gw = (h + pad) // cell + 2, (w + pad) // cell + 2
        g = rng.random((gh, gw)).astype(np.float32) * amp
        up = np.kron(g, np.ones((cell, cell), np.float32))
        return up[: h + pad, : w + pad]

    base = octave(256, 90) + octave(64, 40) + octave(16, 18) + octave(4, 6)
    ob_y, ob_x = np.mgrid[0:160, 0:160].astype(np.float32)
    blob = np.clip(80 - np.hypot(ob_y - 80, ob_x - 80), 0, 40) * 2.0
    out = []
    for i in range(n):
        dy, dx = (i * 1) % pad, (i * 2) % pad
        y = base[dy:dy + h, dx:dx + w].copy()
        oy, ox = 40 + i * 3, 60 + i * 5
        if oy + 160 <= h and ox + 160 <= w:
            y[oy:oy + 160, ox:ox + 160] += blob
        grain = rng.normal(0, 2.0, (h, w)).astype(np.float32)
        yq = np.clip(y + grain + 40, 0, 255).astype(np.uint8)
        u = np.clip(base[dy:dy + h, dx:dx + w] * 0.5 + 90, 0, 255).astype(np.uint8)
        v = np.clip(255 - base[dy:dy + h, dx:dx + w] * 0.6 - 30, 0, 255) \
            .astype(np.uint8)
        out.append((yq, u, v))
    return out


def stage_frames(nf=NF):
    """The bench's frames as (F, H, W) device arrays."""
    import jax.numpy as jnp

    frames = make_frames(W, H, nf)
    return tuple(jnp.asarray(np.stack([f[k] for f in frames])) for k in range(3))


def encode_payload(fy, fu, fv, unroll=1):
    """Encode the staged frames with the bench's configuration and caps:
    encode_gop_scan's outputs (payload words at [3], bits at [4], overflow at
    [7])."""
    import jax.numpy as jnp

    from fpga_mpeg2_encoder_tpu import EncoderConfig
    from fpga_mpeg2_encoder_tpu.models.encoder import encode_gop_scan

    cfg = EncoderConfig(xl=7, yl=7, vector_level=3, q_level=2)
    py = jnp.zeros((H, W), jnp.uint8)
    pc = jnp.zeros((H // 2, W // 2), jnp.uint8)
    return encode_gop_scan(fy, fu, fv, py, pc, pc, jnp.int32(0), jnp.int32(0),
                           jnp.int32(23), yr=cfg.yr, ur=cfg.ur,
                           q_level=cfg.q_level, unroll=unroll, **CAPS)


def payload_bytes(out) -> bytes:
    from fpga_mpeg2_encoder_tpu.models.encoder import words_to_bytes

    return words_to_bytes(np.asarray(out[3]), int(out[4]))


def main():
    from fpga_mpeg2_encoder_tpu.utils.compile_cache import enable_compile_cache
    from fpga_mpeg2_encoder_tpu.utils.device import (
        card_line, device_record, require_gpu)

    enable_compile_cache()
    try:
        require_gpu()
    except RuntimeError as e:
        sys.exit(f"bench: {e}")
    card = card_line()
    import jax
    import jax.numpy as jnp
    from fpga_mpeg2_encoder_tpu.core.bitstream import (
        BitWriter, sequence_header_chunks, SEQUENCE_END_CHUNKS)

    fy, fu, fv = stage_frames()
    # FPGA_MPEG2_BENCH_UNROLL=k encodes k frames per scan step (bit-identical;
    # overlaps one frame's entropy tail with the next frame's front); default
    # 1 keeps the methodology comparable across runs.
    unroll = int(os.environ.get("FPGA_MPEG2_BENCH_UNROLL", "1"))

    # every rep gets different frame content (rolled along the frame axis)
    fys = [jnp.roll(fy, r, axis=0) for r in range(7)]
    jax.block_until_ready(fys)

    # self-validation: the warm-up payload must match the pinned digest
    out = encode_payload(fys[0], fu, fv, unroll)
    digest = hashlib.sha256(payload_bytes(out)).hexdigest()
    if "--digest" in sys.argv:
        print(f"payload sha256: {digest}", file=sys.stderr)
    assert not bool(out[7]), "payload budget overflow on warm-up content"
    assert digest == PAYLOAD_SHA256, f"payload digest mismatch: {digest}"

    # steady-state throughput: batches of 3 queued reps, one forced readback
    # per batch; best of 2 batches.  Every rep is a full 96-frame encode with
    # distinct content; every rep's overflow flag is checked.
    reps, batches = 3, 2
    int(jnp.int32(1) + jnp.int32(2))     # pre-warm the scalar combiner
    best = float("inf")
    ovf_any = False
    for b in range(batches):
        t0 = time.perf_counter()
        outs = [encode_payload(fys[1 + b * reps + r], fu, fv, unroll)
                for r in range(reps)]
        force = outs[0][4]
        for o in outs[1:]:
            force = force + o[4]
        int(force)                       # one readback forces the batch
        dt = time.perf_counter() - t0
        best = min(best, dt / reps)
        for o in outs:
            ovf_any = ovf_any or bool(o[7])
    assert not ovf_any, "payload budget overflow on bench content"

    payload = payload_bytes(outs[-1])
    bw = BitWriter()
    bw.put_chunks(sequence_header_chunks(W, H))
    stream = bw.to_bytes_aligned() + payload
    bw2 = BitWriter()
    bw2.put_chunks(SEQUENCE_END_CHUNKS)
    stream += bw2.to_bytes_aligned()
    assert stream[:4] == b"\x00\x00\x01\xb3"
    # payload starts with the GOP header then the frame-0 picture header
    # (substring-counting picture codes is unreliable: MPEG-2 entropy payloads
    # legally contain long zero runs; bit-exactness vs the golden model is
    # covered by the test suite)
    assert payload[:4] == b"\x00\x00\x01\xb8", "GOP header first"
    assert payload[8:12] == b"\x00\x00\x01\x00", "picture header after GOP"

    mpix = W * H * NF / best / 1e6
    print(json.dumps({
        "metric": "encode_throughput_1920x1152_ippp",
        "value": round(mpix, 1),
        "unit": "MPixels/s",
        "vs_baseline": round(mpix / 268.0, 3),
        "device": device_record(),
        "card": card,
    }))


if __name__ == "__main__":
    main()
