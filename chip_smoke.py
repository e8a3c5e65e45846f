#!/usr/bin/env python3
"""Bring-up check: the encoder's main path on NVIDIA GPUs, byte for byte.

    python chip_smoke.py                # one card: phases a-g
    python chip_smoke.py --four-cards   # four cards: the multi-card phase only

Everything runs in this one process (the CLI through its ``main``, the card
tests through ``pytest.main``), so only one process holds the card.  Earlier
lines give the card (nvidia-smi name and power limit), the JAX version,
XLA_FLAGS, the compile cache, every compile's seconds and one line per phase;
the last line is {"ok": true, "device": {...}}.  The script exits non-zero
without that line when JAX's first device is not a GPU or any phase fails.
"""
from __future__ import annotations

import argparse
import functools
import hashlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
TESTS = os.path.join(ROOT, "tests")
W, H, PFRAMES = 1920, 1152, 23
GOP = PFRAMES + 1
COMPILE_EVENT = "/jax/core/compile/backend_compile_duration"


def _expect(cond, msg):
    if not cond:
        raise AssertionError(msg)


def _digest(stream: bytes):
    return len(stream), hashlib.sha256(stream).hexdigest()


def _check_stream(stream: bytes):
    _expect(stream[:4] == b"\x00\x00\x01\xb3", "stream starts with a sequence header")
    _expect(b"\x00\x00\x01\xb8" in stream[:64], "GOP header follows the sequence header")
    _expect(stream.rstrip(b"\x00").endswith(b"\x00\x00\x01\xb7"),
            "stream ends with the sequence end code")
    _expect(len(stream) % 32 == 0, "stream length is a multiple of 32")


def _content():
    """Frame generators and pinned digests shared with the test suite."""
    sys.path.insert(0, TESTS)
    from conftest import structured_content
    import test_chip_exactness as chip_tests
    return structured_content, chip_tests


def _config():
    from fpga_mpeg2_encoder_tpu import EncoderConfig
    return EncoderConfig(xl=7, yl=7, vector_level=3, q_level=2)


def _counting_encoder(*args, **kw):
    """An Encoder that counts frames sent down the host-stitch retry path,
    so a phase can require that the device packer made every frame."""
    from fpga_mpeg2_encoder_tpu import Encoder

    class CountingEncoder(Encoder):
        retries = 0

        def _encode_frame_hoststitch(self, args, kw):
            self.retries += 1
            return super()._encode_frame_hoststitch(args, kw)

    return CountingEncoder(*args, **kw)


def _content_caps():
    """Packing caps sized for the bench content (~750 KB I-frames)."""
    import bench
    return dict(row_cap=bench.CAPS["row_cap"], frame_cap=bench.CAPS["frame_cap"])


# ------------------------------------------------------------------ one card
def phase_golden_1080p():
    """(a) The golden model's 1920x1152 I+P stream, through the device packer."""
    structured_content, chip_tests = _content()
    enc = _counting_encoder(_config(), **_content_caps())
    got = enc.encode(structured_content(W, H, 2, 77), W, H, pframes_count=PFRAMES)
    _expect(_digest(got) == chip_tests.GOLDEN_1080P, f"golden digest: {_digest(got)}")
    _expect(enc.retries == 0, f"{enc.retries} frames needed the retry path")


def phase_chunked_equals_streaming():
    """(b) One 24-frame GOP through the push_chunk scan and through push_frame."""
    import bench
    import jax
    from fpga_mpeg2_encoder_tpu.models import encoder as M

    frames = bench.make_frames(W, H, GOP)
    enc = _counting_encoder(_config(), **_content_caps())
    enc.encode(frames, W, H, PFRAMES, chunk_frames=GOP)          # compiles
    t0 = time.perf_counter()
    chunked = enc.encode(frames, W, H, PFRAMES, chunk_frames=GOP)
    dt = time.perf_counter() - t0
    streaming = enc.encode(frames, W, H, PFRAMES)
    _expect(chunked == streaming, "chunked stream differs from streaming")
    _expect(enc.retries == 0, f"{enc.retries} frames needed the retry path")
    _check_stream(chunked)
    print(f"  bring-up reading, not a benchmark: {GOP} frames {W}x{H} host frames "
          f"-> bytes in {dt:.3f} s = {W * H * GOP / dt / 1e6:.1f} MPixels/s "
          f"(card above)")
    cfg = _config()
    seq_cap = enc.frame_cap * max(1, GOP // 4)
    fy = jax.ShapeDtypeStruct((GOP, H, W), "uint8")
    py = jax.ShapeDtypeStruct((H, W), "uint8")
    pc = jax.ShapeDtypeStruct((H // 2, W // 2), "uint8")
    i32 = jax.ShapeDtypeStruct((), "int32")
    mem = M.encode_gop_scan.lower(
        fy, fy, fy, py, pc, pc, i32, i32, i32, yr=cfg.yr, ur=cfg.ur,
        q_level=cfg.q_level, row_cap=enc.row_cap, frame_cap=enc.frame_cap,
        seq_cap=seq_cap).compile().memory_analysis()
    print(f"  memory_analysis of the {GOP}-frame {W}x{H} chunk scan: "
          f"{_memory_fields(mem)}")


def _memory_fields(mem):
    return {k: getattr(mem, k) for k in (
        "argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
        "alias_size_in_bytes", "generated_code_size_in_bytes")
        if hasattr(mem, k)}


def phase_bench_payload():
    """(c) The bench's own 96-frame encode_gop_scan payload digest."""
    import bench

    out = bench.encode_payload(*bench.stage_frames())
    _expect(not bool(out[7]), "bench payload overflowed its caps")
    digest = hashlib.sha256(bench.payload_bytes(out)).hexdigest()
    _expect(digest == bench.PAYLOAD_SHA256, f"bench payload digest {digest}")


def phase_cli():
    """(d) cli.encode.main on a 1920x1152 .yuv writes Encoder.encode's bytes."""
    import bench
    from fpga_mpeg2_encoder_tpu import Encoder
    from fpga_mpeg2_encoder_tpu.cli import encode as cli_encode
    from fpga_mpeg2_encoder_tpu.utils import yuv

    work = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(work, exist_ok=True)
    src, dst = os.path.join(work, "in.yuv"), os.path.join(work, "out.m2v")
    frames = bench.make_frames(W, H, 2)
    yuv.write_frames(src, frames)
    rc = cli_encode.main(["--input", src, "--size", f"{W}x{H}", "--out", dst,
                          "--quiet"])
    _expect(rc == 0, f"CLI exit code {rc}")
    with open(dst, "rb") as f:
        got = f.read()
    _expect(got == Encoder(_config()).encode(frames, W, H, PFRAMES),
            "CLI output differs from Encoder.encode")


def phase_batch_cif():
    """(e) BatchEncoder: 8 CIF streams in one push_chunks, each equal to its
    single-stream encode."""
    import bench
    from fpga_mpeg2_encoder_tpu import Encoder, SequenceConfig
    from fpga_mpeg2_encoder_tpu.parallel.dp import BatchEncoder

    w, h, n = 352, 288, 8
    clip = bench.make_frames(w, h, GOP + n - 1)
    streams = [clip[b:b + GOP] for b in range(n)]
    be = BatchEncoder(_config(), SequenceConfig(w, h, PFRAMES), batch=n)
    be.push_chunks(streams)
    outs = be.finish()
    for b in range(n):
        _expect(outs[b] == Encoder(_config()).encode(streams[b], w, h, PFRAMES),
                f"batched stream {b} differs from its single-stream encode")


def phase_max_geometry():
    """(f) 2048x2048, 2 frames, the golden digest: the memory edge of the
    169-candidate SAD volume."""
    import jax

    structured_content, chip_tests = _content()
    enc = _counting_encoder(_config(), **chip_tests.CAPS_2048)
    got = enc.encode(structured_content(2048, 2048, 2, 99), 2048, 2048,
                     pframes_count=PFRAMES)
    _expect(_digest(got) == chip_tests.GOLDEN_2048, f"2048 digest: {_digest(got)}")
    _expect(enc.retries == 0, f"{enc.retries} frames needed the retry path")
    stats = jax.devices()[0].memory_stats() or {}
    print(f"  peak_bytes_in_use so far: {stats.get('peak_bytes_in_use')}")


class _Outcomes:
    """pytest plugin: counts test outcomes."""

    def __init__(self):
        self.passed = self.failed = self.skipped = 0

    def pytest_runtest_logreport(self, report):
        if report.failed:
            self.failed += 1
        elif report.skipped:
            self.skipped += 1
        elif report.when == "call":
            self.passed += 1


def phase_chip_tests():
    """(g) Every test marked ``chip`` passes on the card; none skips."""
    import pytest

    count = _Outcomes()
    rc = pytest.main([TESTS, "-m", "chip", "-q", "-p", "no:cacheprovider"],
                     plugins=[count])
    print(f"  chip tests: {count.passed} passed, {count.failed} failed, "
          f"{count.skipped} skipped")
    _expect(rc == 0 and count.failed == 0 and count.skipped == 0
            and count.passed > 0, f"pytest -m chip exit code {rc}")


# ---------------------------------------------------------------- four cards
def phase_four_cards():
    """Stream-DP, slice-row sharding and the 2x2 composition at 1920x1152,
    each compared with single-card encodes on device 0."""
    import bench
    import jax
    import jax.numpy as jnp
    import numpy as np
    from fpga_mpeg2_encoder_tpu import SequenceConfig
    from fpga_mpeg2_encoder_tpu.models.encoder import encode_frame_core
    from fpga_mpeg2_encoder_tpu.parallel.dp import BatchEncoder
    from fpga_mpeg2_encoder_tpu.parallel.mesh import make_mesh, make_mesh2d
    from fpga_mpeg2_encoder_tpu.parallel.spatial import (
        make_sharded_batch_encoder, make_sharded_frame_encoder,
        sharded_batch_shardings, sharded_frame_shardings)

    structured_content, _ = _content()
    cfg, caps = _config(), _content_caps()
    kw = dict(yr=cfg.yr, ur=cfg.ur, q_level=cfg.q_level, **caps)

    # stream-DP: 4 GOPs, one per card
    clip = bench.make_frames(W, H, GOP + 3)
    streams = [clip[b:b + GOP] for b in range(4)]
    be = BatchEncoder(cfg, SequenceConfig(W, H, PFRAMES), batch=4,
                      mesh=make_mesh(4), **caps)
    be.push_chunks(streams)
    ndev = len(be._prev[0].sharding.device_set)
    _expect(ndev == 4, f"stream-DP state lives on {ndev} devices, not 4")
    outs = be.finish()
    for b in range(4):
        enc = _counting_encoder(cfg, **caps)
        want = enc.encode(streams[b], W, H, PFRAMES, chunk_frames=GOP)
        _expect(enc.retries == 0, "single-card reference needed the retry path")
        _expect(outs[b] == want, f"stream-DP stream {b} differs from one card")
    print(f"  stream-DP over 4 cards: 4 x {GOP}-frame GOPs byte-identical")

    # slice-row sharding of one frame over 4 cards, I then P
    ref = jax.jit(functools.partial(encode_frame_core, **kw))
    mesh = make_mesh(4, axis="slice")
    senc = make_sharded_frame_encoder(mesh, H, W, **kw)
    plane, _ = sharded_frame_shardings(mesh)
    zero = [np.zeros((H, W), np.uint8), np.zeros((H // 2, W // 2), np.uint8),
            np.zeros((H // 2, W // 2), np.uint8)]
    prev_s = [jax.device_put(z, plane) for z in zero]
    prev_r = [jnp.asarray(z) for z in zero]
    for fi, frame in enumerate(structured_content(W, H, 2, 77)):
        out_s = senc(*(jax.device_put(p, plane) for p in frame), *prev_s,
                     jnp.int32(fi), jnp.int32(fi))
        out_r = ref(*(jnp.asarray(p) for p in frame), *prev_r,
                    jnp.int32(fi), jnp.int32(fi))
        _check_frame(out_s, out_r, f"slice-sharded frame {fi}")
        prev_s, prev_r = list(out_s[:3]), list(out_r[:3])
    print("  slice-sharded over 4 cards: I and P frames byte-identical")

    # 2 streams x 2 slice shards, streams in different GOP phases
    mesh2 = make_mesh2d(2, 2)
    benc = make_sharded_batch_encoder(mesh2, 2, H, W, **kw)
    plane2, scalar2 = sharded_batch_shardings(mesh2)
    clips = [structured_content(W, H, 2, 77 + s) for s in range(2)]
    prev_b = [jax.device_put(np.stack([z, z]), plane2) for z in zero]
    prev_r = [[jnp.asarray(z) for z in zero] for _ in range(2)]
    for fi in range(2):
        i_f = np.asarray([fi, fi + 1], np.int32)
        fno = np.full(2, fi, np.int32)
        out_b = benc(*(jax.device_put(np.stack([c[fi][k] for c in clips]), plane2)
                       for k in range(3)), *prev_b,
                     jax.device_put(i_f, scalar2), jax.device_put(fno, scalar2))
        for s in range(2):
            out_r = ref(*(jnp.asarray(p) for p in clips[s][fi]), *prev_r[s],
                        jnp.int32(i_f[s]), jnp.int32(fno[s]))
            _check_frame([np.asarray(o)[s] for o in out_b], out_r,
                         f"2x2 stream {s} frame {fi}")
            prev_r[s] = list(out_r[:3])
        prev_b = list(out_b[:3])
    print("  2 x 2 mesh: both streams' I and P frames byte-identical")


def _check_frame(got, want, what):
    """Frame outputs (recon y/u/v, words, bits, overflow) equal a reference."""
    import numpy as np

    _expect(not bool(np.asarray(got[5]).any()) and not bool(want[5]),
            f"{what}: overflow")
    bits = int(want[4])
    _expect(int(got[4]) == bits, f"{what}: {int(got[4])} bits != {bits}")
    nw = (bits + 31) // 32
    _expect((np.asarray(got[3])[:nw] == np.asarray(want[3])[:nw]).all(),
            f"{what}: payload differs")
    for k in range(3):
        _expect((np.asarray(got[k]) == np.asarray(want[k])).all(),
                f"{what}: reconstruction differs")


ONE_CARD_PHASES = (
    ("a golden 1920x1152", phase_golden_1080p),
    ("b chunked = streaming", phase_chunked_equals_streaming),
    ("c bench payload", phase_bench_payload),
    ("d CLI = API", phase_cli),
    ("e 8 CIF streams batched = single", phase_batch_cif),
    ("f 2048x2048 golden", phase_max_geometry),
    ("g chip tests", phase_chip_tests),
)
FOUR_CARD_PHASES = (("four cards = one card", phase_four_cards),)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four-cards", action="store_true",
                   help="run only the four-card phase (needs 4 GPUs)")
    return p.parse_args(argv)


def phases_for(args):
    return FOUR_CARD_PHASES if args.four_cards else ONE_CARD_PHASES


def _print_compile(event, duration, **kw):
    if event == COMPILE_EVENT:
        print(f"  compile {kw.get('fun_name', '?')}: {duration:.1f} s", flush=True)


def main(argv=None) -> int:
    args = parse_args(argv)
    from fpga_mpeg2_encoder_tpu.utils.compile_cache import enable_compile_cache
    from fpga_mpeg2_encoder_tpu.utils.device import (
        card_line, device_record, require_gpu)

    cache = enable_compile_cache()
    import jax

    try:
        require_gpu()
    except RuntimeError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    need = 4 if args.four_cards else 1
    if len(jax.devices()) < need:
        print(f"chip_smoke: needs {need} GPUs, JAX sees {len(jax.devices())}",
              file=sys.stderr)
        return 1
    print(f"card: {card_line()}")
    print(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}; "
          f"compile cache {cache}", flush=True)
    jax.monitoring.register_event_duration_secs_listener(_print_compile)
    os.environ["FPGA_MPEG2_CHIP_TESTS"] = "1"      # tests/conftest.py: keep the GPU
    for name, phase in phases_for(args):
        t0 = time.perf_counter()
        phase()
        print(f"phase {name}: ok in {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": device_record()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
