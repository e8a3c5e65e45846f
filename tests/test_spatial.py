"""Slice-row sharded FULL frame pipeline (parallel/spatial.py) vs single-chip.

Byte-identical payloads and bit-identical reconstructions are asserted on an
8-device CPU mesh, INCLUDING the edge shards (the 128x128 case puts exactly
one macroblock row on each shard, so shards 0 and 7 are frame edges and every
shard boundary crosses a motion-search halo)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fpga_mpeg2_encoder_tpu.models.encoder import (
    DEFAULT_FRAME_CAP,
    DEFAULT_ROW_CAP,
    encode_frame_core,
)
from fpga_mpeg2_encoder_tpu.parallel.mesh import make_mesh
from fpga_mpeg2_encoder_tpu.parallel.spatial import (
    make_sharded_frame_encoder,
    sharded_frame_shardings,
)

from conftest import make_video


@pytest.mark.parametrize("w,h,kind", [
    (128, 128, "pan"),      # 1 MB row per shard: both edge shards exercised
    (96, 256, "noise"),     # 2 MB rows per shard, escape-heavy content
])
def test_sharded_frame_bit_exact(rng, w, h, kind):
    nsh = 8
    mesh = make_mesh(nsh, axis="slice")
    frames = make_video(rng, w, h, 4, kind)
    kw = dict(yr=6, ur=3, q_level=2)
    enc = make_sharded_frame_encoder(mesh, h, w, **kw)
    plane_sh, _ = sharded_frame_shardings(mesh)

    prev_s = (jax.device_put(np.zeros((h, w), np.uint8), plane_sh),
              jax.device_put(np.zeros((h // 2, w // 2), np.uint8), plane_sh),
              jax.device_put(np.zeros((h // 2, w // 2), np.uint8), plane_sh))
    prev_r = tuple(jnp.asarray(np.zeros_like(np.asarray(p))) for p in prev_s)

    for fi, (y, u, v) in enumerate(frames):
        i_f = jnp.int32(0 if fi == 0 else fi)
        fno = jnp.int32(fi)
        ys = jax.device_put(y, plane_sh)
        us = jax.device_put(u, plane_sh)
        vs = jax.device_put(v, plane_sh)
        sy, su, sv, sw, sb, sovf = enc(ys, us, vs, *prev_s, i_f, fno)
        ry, ru, rv, fw, fb, ovf = encode_frame_core(
            jnp.asarray(y), jnp.asarray(u), jnp.asarray(v), *prev_r, i_f, fno,
            row_cap=DEFAULT_ROW_CAP, frame_cap=DEFAULT_FRAME_CAP, **kw)
        assert not bool(sovf) and not bool(ovf)
        assert int(sb) == int(fb), f"frame {fi}: payload bit count differs"
        nwords = (int(fb) + 31) // 32
        assert (np.asarray(sw)[:nwords] == np.asarray(fw)[:nwords]).all(), \
            f"frame {fi}: payload bytes differ"
        # reconstruction identical on every shard (edge shards included)
        assert (np.asarray(sy) == np.asarray(ry)).all()
        assert (np.asarray(su) == np.asarray(ru)).all()
        assert (np.asarray(sv) == np.asarray(rv)).all()
        prev_s = (sy, su, sv)
        prev_r = (ry, ru, rv)


def test_sharded_sequence_stream_decodes(rng):
    """Assemble a whole sequence from sharded frame payloads and decode it."""
    from fpga_mpeg2_encoder_tpu.core.bitstream import (
        BitWriter, SEQUENCE_END_CHUNKS, sequence_header_chunks)
    from fpga_mpeg2_encoder_tpu.golden.decoder import decode_sequence
    from fpga_mpeg2_encoder_tpu.golden.validator import validate_sequence
    from fpga_mpeg2_encoder_tpu.models.encoder import words_to_bytes

    w, h, nf = 128, 128, 5
    mesh = make_mesh(8, axis="slice")
    frames = make_video(rng, w, h, nf, "pan")
    enc = make_sharded_frame_encoder(mesh, h, w, yr=6, ur=3, q_level=2)
    plane_sh, _ = sharded_frame_shardings(mesh)
    prev = (jax.device_put(np.zeros((h, w), np.uint8), plane_sh),
            jax.device_put(np.zeros((h // 2, w // 2), np.uint8), plane_sh),
            jax.device_put(np.zeros((h // 2, w // 2), np.uint8), plane_sh))
    bw = BitWriter()
    bw.put_chunks(sequence_header_chunks(w, h))
    payload = [bw.to_bytes_aligned()]
    for fi, (y, u, v) in enumerate(frames):
        i_f = jnp.int32(fi % 3)
        sy, su, sv, sw, sb, ovf = enc(
            jax.device_put(y, plane_sh), jax.device_put(u, plane_sh),
            jax.device_put(v, plane_sh), *prev, i_f, jnp.int32(fi))
        assert not bool(ovf)
        payload.append(words_to_bytes(np.asarray(sw), int(sb)))
        prev = (sy, su, sv)
    bw2 = BitWriter()
    bw2.put_chunks(SEQUENCE_END_CHUNKS)
    data = b"".join(payload) + bw2.to_bytes_aligned()
    data += b"\x00" * ((len(data) // 32 + 1) * 32 - len(data))
    dec = decode_sequence(data)
    assert len(dec.pictures) == nf
    validate_sequence(data, expected_frames=nf)


def test_2d_mesh_stream_by_slice_bit_exact(rng):
    """Stream-DP x slice-row-SP on a 2-D (2 stream x 4 slice) mesh: every
    stream's payload and reconstruction byte-identical to single-chip, with
    per-stream GOP phases differing so the batched header rows diverge."""
    from fpga_mpeg2_encoder_tpu.parallel.mesh import make_mesh2d
    from fpga_mpeg2_encoder_tpu.parallel.spatial import (
        make_sharded_batch_encoder, sharded_batch_shardings)

    B, h, w = 4, 64, 96
    mesh = make_mesh2d(2, 4)
    kw = dict(yr=6, ur=3, q_level=2)
    enc = make_sharded_batch_encoder(mesh, B, h, w, **kw)
    plane_sh, scalar_sh = sharded_batch_shardings(mesh)
    videos = [make_video(rng, w, h, 3, k)
              for k in ("pan", "noise", "pan", "still")]

    prev_s = (jax.device_put(np.zeros((B, h, w), np.uint8), plane_sh),
              jax.device_put(np.zeros((B, h // 2, w // 2), np.uint8), plane_sh),
              jax.device_put(np.zeros((B, h // 2, w // 2), np.uint8), plane_sh))
    prev_r = [tuple(jnp.zeros(s, jnp.uint8)
                    for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2)))
              for _ in range(B)]
    for fi in range(3):
        y = np.stack([videos[b][fi][0] for b in range(B)])
        u = np.stack([videos[b][fi][1] for b in range(B)])
        v = np.stack([videos[b][fi][2] for b in range(B)])
        i_f = np.asarray([fi, fi, (fi + 1) % 2, fi], np.int32)
        fno = np.full(B, fi, np.int32)
        ry, ru, rv, fw, fb, ovf = enc(
            jax.device_put(y, plane_sh), jax.device_put(u, plane_sh),
            jax.device_put(v, plane_sh), *prev_s,
            jax.device_put(i_f, scalar_sh), jax.device_put(fno, scalar_sh))
        assert not bool(np.asarray(ovf).any())
        for b in range(B):
            ref = encode_frame_core(
                jnp.asarray(y[b]), jnp.asarray(u[b]), jnp.asarray(v[b]),
                *prev_r[b], jnp.int32(i_f[b]), jnp.int32(fno[b]),
                row_cap=DEFAULT_ROW_CAP, frame_cap=DEFAULT_FRAME_CAP, **kw)
            assert int(np.asarray(fb)[b]) == int(ref[4]), (fi, b)
            nw = (int(ref[4]) + 31) // 32
            assert (np.asarray(fw)[b, :nw] == np.asarray(ref[3])[:nw]).all(), \
                (fi, b)
            assert (np.asarray(ry)[b] == np.asarray(ref[0])).all(), (fi, b)
            assert (np.asarray(ru)[b] == np.asarray(ref[1])).all(), (fi, b)
            assert (np.asarray(rv)[b] == np.asarray(ref[2])).all(), (fi, b)
            prev_r[b] = tuple(ref[:3])
        prev_s = (ry, ru, rv)
