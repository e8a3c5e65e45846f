"""Each stage of the frame pipeline against the golden model, at the widths
and geometries where their index arithmetic changes (vector levels, the
2048-wide maximum, nbx past 26, sharded bands and meshes), plus a guard that
no matmul on the path takes an f32 operand (which a GPU may run in TF32)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fpga_mpeg2_encoder_tpu.config import EncoderConfig, SequenceConfig
from fpga_mpeg2_encoder_tpu.core import tables as T
from fpga_mpeg2_encoder_tpu.core.bitstream import (
    BitWriter, SEQUENCE_END_CHUNKS, sequence_header_chunks)
from fpga_mpeg2_encoder_tpu.golden import encoder as G
from fpga_mpeg2_encoder_tpu.models import encoder as M
from fpga_mpeg2_encoder_tpu.ops import entropy, motion

from conftest import structured_content

CFG = EncoderConfig(xl=5, yl=5, vector_level=3, q_level=2)
KW = dict(yr=6, ur=3, q_level=2, row_cap=1024, frame_cap=16384)


def _golden_me(cfg, cur_y, prev, is_iframe, rows):
    """Per-macroblock golden decisions and predictions for MB rows ``rows``
    of a whole frame: (inter, mvx, mvy, pred_y, pred_u, pred_v) arrays."""
    nby, nbx = cur_y.shape[0] // 16, cur_y.shape[1] // 16
    py = np.pad(prev[0], cfg.yr + 1)
    pu = np.pad(prev[1], cfg.ur + 1)
    pv = np.pad(prev[2], cfg.ur + 1)
    out = [[] for _ in range(6)]
    for by in rows:
        for k in range(6):
            out[k].append([])
        for bx in range(nbx):
            blk = cur_y[by * 16:by * 16 + 16, bx * 16:bx * 16 + 16]
            dec = G.motion_estimate_block(cfg, blk, py, by, bx, nby, nbx, is_iframe)
            yp, up, vp = G.predict_block(cfg, dec, py, pu, pv, by, bx)
            for k, x in enumerate((dec.inter, dec.mvx, dec.mvy, yp, up, vp)):
                out[k][-1].append(x)
    return [np.asarray(o) for o in out]


def _assert_me_equal(mr, want):
    for got, w in zip(mr, want):
        assert (np.asarray(got) == w).all()


@pytest.mark.parametrize("vl", [1, 3])
@pytest.mark.parametrize("is_iframe", [False, True])
def test_me_matches_golden(vl, is_iframe):
    """Whole-frame motion estimation + prediction, I and P frames, at the
    smallest and the default search range."""
    cfg = EncoderConfig(xl=5, yl=5, vector_level=vl)
    f0, f1 = structured_content(96, 64, 2, 31 + vl)
    prev = G.subsample_420(*f0)
    cur = G.subsample_420(*f1)
    mr = motion.estimate_and_predict(
        *(jnp.asarray(p) for p in cur), *(jnp.asarray(p) for p in prev),
        jnp.asarray(is_iframe), cfg.yr, cfg.ur)
    _assert_me_equal(mr, _golden_me(cfg, cur[0], prev, is_iframe, range(4)))


def test_me_max_width_matches_golden():
    """nbx = 128 (2048 wide, the XL=7 maximum) on noise content."""
    cfg = EncoderConfig(xl=7, yl=5, vector_level=3)
    w, h = 2048, 32
    rng = np.random.default_rng(5)
    cur_y = rng.integers(0, 256, (h, w)).astype(np.uint8)
    prev = (rng.integers(0, 256, (h, w)).astype(np.uint8),
            rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8),
            rng.integers(0, 256, (h // 2, w // 2)).astype(np.uint8))
    mr = motion.estimate_and_predict(
        jnp.asarray(cur_y), jnp.asarray(prev[1]), jnp.asarray(prev[2]),
        *(jnp.asarray(p) for p in prev), jnp.asarray(False), cfg.yr, cfg.ur)
    _assert_me_equal(mr, _golden_me(cfg, cur_y, prev, False, range(2)))


def test_me_banded_halo_matches_golden():
    """A middle band of MB rows with real 8/4-row halos and global row
    offsets (the slice-sharded form) treats its seams as non-edges."""
    w, h = 96, 128                       # 8 MB rows
    f0, f1 = structured_content(w, h, 2, 41)
    prev = G.subsample_420(*f0)
    cur_y = G.subsample_420(*f1)[0]
    r0, r1 = 2, 6
    mr = motion.estimate_and_predict_local(
        jnp.asarray(cur_y[16 * r0:16 * r1]),
        jnp.asarray(prev[0][16 * r0 - 8:16 * r1 + 8]),
        jnp.asarray(prev[1][8 * r0 - 4:8 * r1 + 4]),
        jnp.asarray(prev[2][8 * r0 - 4:8 * r1 + 4]),
        jnp.asarray(False), CFG.yr, CFG.ur, jnp.int32(r0), jnp.int32(h // 16))
    _assert_me_equal(mr, _golden_me(CFG, cur_y, prev, False, range(r0, r1)))


def _random_zig(rng, nby, nbx):
    zig = np.zeros((nby, nbx, 6, 64), np.int32)
    mask = rng.random(zig.shape) < 0.15
    zig[mask] = rng.integers(-60, 61, mask.sum())
    inter = rng.random((nby, nbx)) < 0.6
    mvx = rng.integers(-12, 13, (nby, nbx)).astype(np.int32)
    mvy = rng.integers(-12, 13, (nby, nbx)).astype(np.int32)
    return zig, inter, mvx, mvy


def _golden_symbols(zig, inter, mvx, mvy, i_frame):
    """The golden emitter's bytes for a P-frame of given quantised
    coefficients and decisions (picture header + every slice)."""
    nby, nbx = inter.shape
    quant = np.zeros((nby, nbx, 6, 64), np.int32)
    quant[..., np.asarray(T.ZIGZAG_INV)] = zig
    nz = np.logical_not(inter)[:, :, None] | (zig != 0).any(-1)
    nzf = sum(nz[..., t].astype(np.int32) << (5 - t) for t in range(6))
    decisions = [[G.MacroblockDecision(bool(inter[by, bx]), int(mvx[by, bx]),
                                       int(mvy[by, bx])) for bx in range(nbx)]
                 for by in range(nby)]
    fr = G.FrameResult(None, None, None, decisions,
                       quant.reshape(nby, nbx, 6, 8, 8), nzf)
    bw = BitWriter()
    G.emit_frame_bits(CFG, bw, fr, i_frame, G.Timecode())
    return bw.to_bytes_aligned()


@pytest.mark.parametrize("nby,nbx", [(5, 4), (2, 26), (2, 120), (2, 128)])
def test_symbolize_matches_golden_emitter(nby, nbx):
    """Slot-grid symbolisation (realistic statistics: many zeros, short runs,
    escapes), packed on the host, equals the golden emitter's bytes.  nbx = 26
    is where a macroblock's slot offset first crosses 2**8; 120 and 128 are
    the 1920-wide headline and the 2048-wide maximum."""
    rng = np.random.default_rng(11 + nbx)
    zig, inter, mvx, mvy = _random_zig(rng, nby, nbx)
    zig[0, 0, 0, 5] = 2047               # escape-coded levels
    zig[-1, -1, 3, 63] = -2047
    sym = entropy.symbolize_frame(jnp.asarray(zig), jnp.asarray(inter),
                                  jnp.asarray(mvx), jnp.asarray(mvy),
                                  jnp.int32(1), jnp.int32(4), CFG.q_level)
    got = M.stitch_slots_host(np.asarray(sym.slots))
    assert got == _golden_symbols(zig, inter, mvx, mvy, 1)


@pytest.mark.parametrize("q_level", [2, 4])
def test_transform_recon_matches_golden(q_level):
    """Residual -> DCT -> quantise -> IDCT -> reconstruct over a frame, I and
    P macroblocks mixed, both dequantiser shift branches (q_level < 3, >= 3)."""
    w, h = 96, 64
    f0, f1 = structured_content(w, h, 2, 13)
    cur = G.subsample_420(*f1)
    pred = [p.astype(np.int32) for p in G.subsample_420(*f0)]
    nby, nbx = h // 16, w // 16
    inter = np.random.default_rng(3).random((nby, nbx)) < 0.5
    blocks = [M._blockify(jnp.asarray(p), bs) for p, bs in zip(pred, (16, 8, 8))]
    mr = motion.MotionResult(jnp.asarray(inter), None, None, *blocks)
    qzig, ry, ru, rv = M.transform_recon(*(jnp.asarray(p) for p in cur), mr,
                                         q_level)

    want_q = np.zeros((nby, nbx, 6, 64), np.int32)
    want_r = [np.zeros_like(p) for p in cur]
    for by in range(nby):
        for bx in range(nbx):
            for t in range(6):
                p, s = (0, 16) if t < 4 else (t - 3, 8)
                y0 = by * s + (8 * (t // 2) if t < 4 else 0)
                x0 = bx * s + (8 * (t % 2) if t < 4 else 0)
                c = cur[p][y0:y0 + 8, x0:x0 + 8].astype(np.int32)
                pr = pred[p][y0:y0 + 8, x0:x0 + 8]
                q = G.quantize(G.fdct(c - pr), bool(inter[by, bx]), q_level)
                want_q[by, bx, t] = G.zigzag_scan(q)
                resid = G.idct(G.dequantize(q, bool(inter[by, bx]), q_level))
                want_r[p][y0:y0 + 8, x0:x0 + 8] = G.add_clip(pr, resid)
    assert (np.asarray(qzig) == want_q).all()
    for got, want in zip((ry, ru, rv), want_r):
        assert (np.asarray(got) == want).all()


def _stream(w, h, payloads):
    bw = BitWriter()
    bw.put_chunks(sequence_header_chunks(w, h))
    end = BitWriter()
    end.put_chunks(SEQUENCE_END_CHUNKS)
    data = bw.to_bytes_aligned() + b"".join(payloads) + end.to_bytes_aligned()
    return data + b"\x00" * ((len(data) // 32 + 1) * 32 - len(data))


def _frame_payload(fw, fb):
    return M.words_to_bytes(np.asarray(fw), int(fb))


def test_frame_core_stream_matches_golden():
    """encode_frame_core frame by frame (device pack + merge), I then P."""
    w, h = 96, 64
    frames = structured_content(w, h, 2, 21)
    f = jax.jit(functools.partial(M.encode_frame_core, **KW))
    prev = (jnp.zeros((h, w), jnp.uint8), jnp.zeros((h // 2, w // 2), jnp.uint8),
            jnp.zeros((h // 2, w // 2), jnp.uint8))
    payloads = []
    for fi, (y, u, v) in enumerate(frames):
        ry, ru, rv, fw, fb, ovf = f(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v),
                                    *prev, jnp.int32(fi), jnp.int32(fi))
        assert not bool(ovf)
        payloads.append(_frame_payload(fw, fb))
        prev = (ry, ru, rv)
    assert _stream(w, h, payloads) == \
        G.encode_sequence(CFG, SequenceConfig(w, h, 23), frames)


@pytest.mark.parametrize("nf,seq_cap", [
    (3, 65536),
    (4, 16384),     # seq_cap == frame_cap: the tightest accumulator sizing
])
def test_gop_scan_stream_matches_golden(nf, seq_cap):
    """The device-resident scan's sequence payload equals the golden stream;
    with seq_cap == frame_cap every append's window must still land at its
    own offset (append_bitstring sizing contract)."""
    w, h = 96, 64
    rng = np.random.default_rng(nf)
    frames = [tuple(rng.integers(0, 256, (h, w)).astype(np.uint8) for _ in range(3))
              for _ in range(nf)]
    fy, fu, fv = (jnp.asarray(np.stack([f[k] for f in frames])) for k in range(3))
    py = jnp.zeros((h, w), jnp.uint8)
    pc = jnp.zeros((h // 2, w // 2), jnp.uint8)
    out = M.encode_gop_scan(fy, fu, fv, py, pc, pc, jnp.int32(0), jnp.int32(0),
                            jnp.int32(2), **KW, seq_cap=seq_cap)
    assert not bool(out[7])
    assert _stream(w, h, [_frame_payload(out[3], out[4])]) == \
        G.encode_sequence(CFG, SequenceConfig(w, h, 2), frames)


def test_sharded_frame_encoder_4_devices_matches_golden():
    """Slice-row sharding over 4 devices (one MB row each, so every seam is a
    halo exchange and both edge shards are frame edges): I then P frame."""
    from fpga_mpeg2_encoder_tpu.parallel.mesh import make_mesh
    from fpga_mpeg2_encoder_tpu.parallel.spatial import (
        make_sharded_frame_encoder, sharded_frame_shardings)

    mesh = make_mesh(4, axis="slice")
    w, h = 96, 64
    frames = structured_content(w, h, 2, 71)
    senc = make_sharded_frame_encoder(mesh, h, w, **KW)
    plane_sh, _ = sharded_frame_shardings(mesh)
    put = functools.partial(jax.device_put, device=plane_sh)
    prev = (put(np.zeros((h, w), np.uint8)), put(np.zeros((h // 2, w // 2), np.uint8)),
            put(np.zeros((h // 2, w // 2), np.uint8)))
    payloads = []
    for fi, (y, u, v) in enumerate(frames):
        out = senc(put(y), put(u), put(v), *prev, jnp.int32(fi), jnp.int32(fi))
        assert not bool(out[5])
        payloads.append(_frame_payload(out[3], out[4]))
        prev = out[:3]
    assert _stream(w, h, payloads) == \
        G.encode_sequence(CFG, SequenceConfig(w, h, 23), frames)


def test_sharded_batch_encoder_2x2_mesh_matches_golden():
    """Stream x slice composition on a 2 x 2 mesh: two streams in different
    GOP phases (an I frame and a P frame against a zero reference), each
    frame payload equal to the golden emitter's."""
    from fpga_mpeg2_encoder_tpu.parallel.mesh import make_mesh2d
    from fpga_mpeg2_encoder_tpu.parallel.spatial import (
        make_sharded_batch_encoder, sharded_batch_shardings)

    mesh = make_mesh2d(2, 2)
    b, h, w = 2, 64, 96
    videos = [structured_content(w, h, 1, 81 + k)[0] for k in range(b)]
    i_f = np.asarray([0, 1], np.int32)
    enc = make_sharded_batch_encoder(mesh, b, h, w, **KW)
    plane_sh, scalar_sh = sharded_batch_shardings(mesh)

    def stack(k):
        return jax.device_put(np.stack([v[k] for v in videos]), plane_sh)
    zeros = [jax.device_put(np.zeros((b,) + s, np.uint8), plane_sh)
             for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
    out = enc(stack(0), stack(1), stack(2), *zeros,
              jax.device_put(i_f, scalar_sh),
              jax.device_put(np.zeros(b, np.int32), scalar_sh))
    assert not bool(np.asarray(out[5]).any())
    fw, fb = np.asarray(out[3]), np.asarray(out[4])
    for k in range(b):
        fr = G.encode_frame(CFG, *G.subsample_420(*videos[k]), None, int(i_f[k]))
        bw = BitWriter()
        G.emit_frame_bits(CFG, bw, fr, int(i_f[k]), G.Timecode())
        assert _frame_payload(fw[k], fb[k]) == bw.to_bytes_aligned(), k


@pytest.mark.parametrize("core", ["encode_frame_core", "encode_gop_scan_core"])
def test_no_f32_matmul_operands(core):
    """Every dot_general on the encode path takes integer-valued bf16 (or
    integer) operands: an f32 operand could run in TF32 on a GPU at default
    precision and round an integer sum."""
    h, w = 32, 48
    frame = jax.ShapeDtypeStruct((h, w), jnp.uint8)
    chroma = jax.ShapeDtypeStruct((h // 2, w // 2), jnp.uint8)
    i32 = jax.ShapeDtypeStruct((), jnp.int32)
    if core == "encode_frame_core":
        fn = functools.partial(M.encode_frame_core, **KW)
        args = (frame, frame, frame, frame, chroma, chroma, i32, i32)
    else:
        fn = functools.partial(M.encode_gop_scan_core, **KW, seq_cap=65536)
        frames = jax.ShapeDtypeStruct((3, h, w), jnp.uint8)
        args = (frames, frames, frames, frame, chroma, chroma, i32, i32, i32)
    jaxpr = jax.make_jaxpr(fn)(*args)

    def walk(jx):
        for eqn in jx.eqns:
            if eqn.primitive.name == "dot_general":
                yield eqn
            for p in eqn.params.values():
                for sub in (p if isinstance(p, (tuple, list)) else (p,)):
                    sub = getattr(sub, "jaxpr", sub)     # ClosedJaxpr -> Jaxpr
                    if hasattr(sub, "eqns"):
                        yield from walk(sub)

    dots = list(walk(jaxpr.jaxpr))
    assert dots, "the encode path has matmuls"
    for eqn in dots:
        dtypes = [v.aval.dtype for v in eqn.invars]
        assert jnp.float32 not in dtypes, (eqn.primitive, dtypes)
