"""Bit-exactness on the GPU.

The CPU suite cannot catch GPU numerics: a float32 matmul may run in TF32
there, and XLA's GPU code generator reorders sums and picks its own kernels.
These tests pin whole streams at real widths against the golden model, live
or through its SHA-256 where the NumPy model takes minutes.  They are marked
``chip`` and skip unless JAX's first device is a GPU (tests/conftest.py);
``python chip_smoke.py`` runs them on the card, or:

    FPGA_MPEG2_CHIP_TESTS=1 python -m pytest tests/test_chip_exactness.py -m chip
"""
import hashlib

import numpy as np
import pytest

from conftest import structured_content

pytestmark = pytest.mark.chip

# Golden-model streams of structured_content clips at EncoderConfig(xl, yl,
# vector_level, q_level=2), pframes_count=23: (length, sha256).  Regenerate
# with G.encode_sequence on the same frames (minutes of NumPy at 2048x2048).
GOLDEN_1080P = (1044000,
                "bde5c76d2896a2eeb26049897578b8b4f1100dd92a3ae46aa458afd222487a6d")
GOLDEN_2048 = (1970528,
               "c45d00483b6d355280148a48be92108bffbc8530f973963018ea8a9e0b35b8cf")
GOLDEN_CIF_VL = {
    1: (121504, "50ae91773fecfafbd09329d91941ecc825e307d94fd7b26d210ae4c226be32fd"),
    2: (60448, "1ac3dcc6bfe7d68cb8b6b9da689dc0dd35ee482ec89f3bc524519209582e4128"),
}
# content-sized packing caps for the 2048x2048 frames (~1.2 MB I-frames)
CAPS_2048 = dict(row_cap=8192, frame_cap=524288)


def _digest(stream: bytes):
    return len(stream), hashlib.sha256(stream).hexdigest()


def test_chip_stream_bit_exact_vs_golden():
    from fpga_mpeg2_encoder_tpu import Encoder, EncoderConfig, SequenceConfig
    from fpga_mpeg2_encoder_tpu.golden import encoder as G

    rng = np.random.default_rng(11)
    frames = [tuple(rng.integers(0, 256, (64, 96), dtype=np.uint8)
                    for _ in range(3)) for _ in range(4)]
    cfg = EncoderConfig(xl=5, yl=5, q_level=1)
    got = Encoder(cfg).encode(frames, 96, 64, 1)
    want = G.encode_sequence(cfg, SequenceConfig(96, 64, 1), frames)
    assert got == want


def test_chip_chunked_equals_streaming():
    from fpga_mpeg2_encoder_tpu import Encoder, EncoderConfig

    rng = np.random.default_rng(12)
    frames = [tuple(rng.integers(0, 256, (64, 64), dtype=np.uint8)
                    for _ in range(3)) for _ in range(6)]
    enc = Encoder(EncoderConfig(xl=4, yl=4))
    a = enc.encode(frames, 64, 64, 2, chunk_frames=6)
    b = enc.encode(frames, 64, 64, 2)
    assert a == b


def test_chip_fullres_1080p_bit_exact_vs_golden():
    """A 1920x1152 I+P pair through the default Encoder (whose 256 KB frame
    budget sends these ~500 KB frames through the host-stitch retry path)."""
    from fpga_mpeg2_encoder_tpu import Encoder, EncoderConfig

    frames = structured_content(1920, 1152, 2, 77)
    cfg = EncoderConfig(xl=7, yl=7, vector_level=3, q_level=2)
    got = Encoder(cfg).encode(frames, 1920, 1152, pframes_count=23)
    assert _digest(got) == GOLDEN_1080P


def test_chip_max_geometry_2048():
    """Max geometry (2048x2048, XL=YL=7, reference README.md:81-82): the
    memory edge of the 169-candidate SAD volume, through the device packer."""
    from fpga_mpeg2_encoder_tpu import Encoder, EncoderConfig

    frames = structured_content(2048, 2048, 2, 99)
    cfg = EncoderConfig(xl=7, yl=7, vector_level=3, q_level=2)
    got = Encoder(cfg, **CAPS_2048).encode(frames, 2048, 2048, pframes_count=23)
    assert _digest(got) == GOLDEN_2048


def test_chip_batched_equals_single_stream():
    """The vmapped multi-stream step (parallel/dp): each batched stream's
    payload equals the single-stream encode bit for bit."""
    import jax.numpy as jnp

    from fpga_mpeg2_encoder_tpu.models.encoder import encode_frame_device
    from fpga_mpeg2_encoder_tpu.parallel.dp import encode_frames_batched

    rng = np.random.default_rng(17)
    b, h, w = 3, 64, 96
    y = rng.integers(0, 256, (b, h, w), dtype=np.uint8)
    u = rng.integers(0, 256, (b, h, w), dtype=np.uint8)
    v = rng.integers(0, 256, (b, h, w), dtype=np.uint8)
    py = np.zeros((b, h, w), np.uint8)
    pc = np.zeros((b, h // 2, w // 2), np.uint8)
    kw = dict(yr=6, ur=3, q_level=2, row_cap=2048, frame_cap=65536)
    i_f = jnp.ones((b,), jnp.int32)          # P-frame step vs zero reference
    fno = jnp.ones((b,), jnp.int32)
    _, _, _, fwb, fbb, ovfb = encode_frames_batched(
        jnp.asarray(y), jnp.asarray(u), jnp.asarray(v), jnp.asarray(py),
        jnp.asarray(pc), jnp.asarray(pc), i_f, fno, **kw)
    assert not bool(np.asarray(ovfb).any())
    for k in range(b):
        _, _, _, fw, fb, ovf = encode_frame_device(
            jnp.asarray(y[k]), jnp.asarray(u[k]), jnp.asarray(v[k]),
            jnp.asarray(py[k]), jnp.asarray(pc[k]), jnp.asarray(pc[k]),
            jnp.int32(1), jnp.int32(1), **kw)
        assert int(np.asarray(fbb)[k]) == int(fb)
        nw = (int(fb) + 31) // 32
        assert (np.asarray(fwb)[k][:nw] == np.asarray(fw)[:nw]).all(), k


@pytest.mark.parametrize("vl", [1, 2])
def test_chip_vector_level_1_2_vs_golden(vl):
    """The search ranges below the default (VECTOR_LEVEL 1 and 2, RTL:12,71-72)
    at CIF: the barrel-stage recentering is parameterised by yr/ur."""
    from fpga_mpeg2_encoder_tpu import Encoder, EncoderConfig

    frames = structured_content(352, 288, 3, 50 + vl)
    cfg = EncoderConfig(xl=5, yl=5, vector_level=vl, q_level=2)
    got = Encoder(cfg).encode(frames, 352, 288, pframes_count=23)
    assert _digest(got) == GOLDEN_CIF_VL[vl]
