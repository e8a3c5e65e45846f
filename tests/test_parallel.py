"""Multi-device tests on the virtual 8-device CPU mesh: stream-DP batched encoding
(bit-exact per stream) and the slice-row halo exchange."""
import os
import sys

import numpy as np
import pytest

import jax

from fpga_mpeg2_encoder_tpu import Encoder, EncoderConfig, SequenceConfig
from fpga_mpeg2_encoder_tpu.golden import encoder as G
from fpga_mpeg2_encoder_tpu.parallel.dp import BatchEncoder
from fpga_mpeg2_encoder_tpu.parallel.halo import sharded_row_sad
from fpga_mpeg2_encoder_tpu.parallel.mesh import make_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
needs_8dev = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 devices")


@needs_8dev
def test_batched_streams_bit_exact(video_factory):
    cfg = EncoderConfig(xl=4, yl=4, vector_level=2, q_level=2)
    seq = SequenceConfig(64, 64, 2)
    n = 8
    videos = [video_factory(64, 64, 4, kind=k)
              for k in (["pan", "noise", "still", "pan"] * 2)]
    be = BatchEncoder(cfg, seq, batch=n, mesh=make_mesh(8))
    for t in range(4):
        be.push_frames([videos[b][t] for b in range(n)])
    streams = be.finish()
    for b in range(n):
        gold = G.encode_sequence(cfg, seq, videos[b])
        assert streams[b] == gold, f"stream {b} diverged"


@needs_8dev
def test_batched_matches_single_encoder(video_factory):
    cfg = EncoderConfig(xl=4, yl=4)
    seq = SequenceConfig(64, 64, 23)
    video = video_factory(64, 64, 3)
    be = BatchEncoder(cfg, seq, batch=8, mesh=make_mesh(8))
    for t in range(3):
        be.push_frames([video[t]] * 8)
    streams = be.finish()
    single = Encoder(cfg).encode(video, 64, 64)
    assert all(s == single for s in streams)


@needs_8dev
def test_halo_exchange_sad_matches_single_chip(rng):
    from fpga_mpeg2_encoder_tpu.ops.motion import estimate_and_predict  # noqa: F401
    import jax.numpy as jnp
    from fpga_mpeg2_encoder_tpu.ops import motion

    n = 8
    h, w = 16 * n, 64
    cur = rng.integers(0, 256, (h, w), dtype=np.uint8)
    prev = rng.integers(0, 256, (h, w), dtype=np.uint8)
    mesh = make_mesh(n, axis="slice")
    got = np.asarray(sharded_row_sad(cur, prev, mesh, yr=6, axis="slice"))

    # single-chip reference volume
    import jax.numpy as jnp
    prevp = jnp.pad(jnp.asarray(prev).astype(jnp.int32), 6)
    c = jnp.asarray(cur).astype(jnp.int32)
    ref = []
    for dy in range(-6, 7):
        for dx in range(-6, 7):
            win = jax.lax.dynamic_slice(prevp, (6 + dy, 6 + dx), (h, w))
            d = jnp.abs(c - win)
            ref.append(np.asarray(d.reshape(h // 16, 16, w // 16, 16).sum(axis=(1, 3))))
    ref = np.stack(ref)

    # interior shard boundaries exchange real neighbour rows; the frame-edge halos
    # are zero-filled, exactly like the single-chip zero padding - so EVERY shard,
    # edge shards included, must match bit-for-bit
    assert (got == ref).all()


def test_graft_entry_contract():
    sys.path.insert(0, ROOT)
    import __graft_entry__ as ge
    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    assert len(out) == 6


@needs_8dev
def test_graft_dryrun_multichip():
    sys.path.insert(0, ROOT)
    import __graft_entry__ as ge
    ge.dryrun_multichip(8)


@needs_8dev
def test_batched_chunked_scan_bit_exact(video_factory):
    from fpga_mpeg2_encoder_tpu.parallel.dp import BatchEncoder
    cfg = EncoderConfig(xl=4, yl=4)
    seq = SequenceConfig(64, 64, 2)
    videos = [video_factory(64, 64, 6, kind=k) for k in
              ["pan", "noise", "still", "pan", "noise", "still", "pan", "noise"]]
    be = BatchEncoder(cfg, seq, batch=8, mesh=make_mesh(8))
    be.push_chunks([v[:3] for v in videos])
    be.push_chunks([v[3:] for v in videos])
    streams = be.finish()
    for b in range(8):
        assert streams[b] == G.encode_sequence(cfg, seq, videos[b]), b


def test_batched_unrolled_scan_equals_rolled(video_factory):
    """encode_gops_batched unroll=2 must match unroll=1 exactly (payloads,
    bit counts, per-frame stats) - same per-frame ops in the same order."""
    import jax.numpy as jnp

    from fpga_mpeg2_encoder_tpu.parallel.dp import encode_gops_batched

    videos = [video_factory(64, 64, 4, kind=k)
              for k in ("pan", "noise", "still")]
    b, f, h, w = 3, 4, 64, 64
    fy = jnp.asarray(np.stack([np.stack([fr[0] for fr in v]) for v in videos]))
    fu = jnp.asarray(np.stack([np.stack([fr[1] for fr in v]) for v in videos]))
    fv = jnp.asarray(np.stack([np.stack([fr[2] for fr in v]) for v in videos]))
    py = jnp.zeros((b, h, w), jnp.uint8)
    pc = jnp.zeros((b, h // 2, w // 2), jnp.uint8)
    z = jnp.zeros((b,), jnp.int32)
    pf = jnp.full((b,), 2, jnp.int32)
    kw = dict(yr=6, ur=3, q_level=2, row_cap=1024, frame_cap=16384,
              seq_cap=131072)
    o1 = encode_gops_batched(fy, fu, fv, py, pc, pc, z, z, pf, **kw, unroll=1)
    o2 = encode_gops_batched(fy, fu, fv, py, pc, pc, z, z, pf, **kw, unroll=2)
    assert not bool(np.asarray(o1[7]).any()) and not bool(np.asarray(o2[7]).any())
    assert (np.asarray(o1[4]) == np.asarray(o2[4])).all()
    for k in range(b):
        nw = (int(np.asarray(o1[4])[k]) + 31) // 32
        assert (np.asarray(o2[3])[k, :nw] == np.asarray(o1[3])[k, :nw]).all(), k
    assert (np.asarray(o1[8]) == np.asarray(o2[8])).all()
    assert (np.asarray(o1[9]) == np.asarray(o2[9])).all()
