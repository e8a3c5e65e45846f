"""JAX pipeline vs golden model: bit-exactness of every op and of full streams."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from fpga_mpeg2_encoder_tpu import Encoder, EncoderConfig, SequenceConfig
from fpga_mpeg2_encoder_tpu.golden import encoder as G
from fpga_mpeg2_encoder_tpu.golden import decoder as D
from fpga_mpeg2_encoder_tpu.ops import colorspace, dct, motion


class TestOpsVsGolden:
    def test_subsample(self, rng):
        y = rng.integers(0, 256, (32, 32), dtype=np.uint8)
        u = rng.integers(0, 256, (32, 32), dtype=np.uint8)
        v = rng.integers(0, 256, (32, 32), dtype=np.uint8)
        gy, gu, gv = G.subsample_420(y, u, v)
        jy, ju, jv = colorspace.subsample_420(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v))
        assert (np.asarray(ju) == gu).all() and (np.asarray(jv) == gv).all()

    @pytest.mark.parametrize("shape", [(16, 16), (288, 352), (64, 2048)])
    def test_subsample_impls_bitexact(self, rng, shape):
        """The chroma halving matches the golden model across
        small/production/max widths."""
        p = rng.integers(0, 256, shape, dtype=np.uint8)
        want = G.subsample_420(p, p, p)[1]
        got = np.asarray(colorspace._half(jnp.asarray(p)))
        assert (got == want).all()

    def test_fdct_exact(self, rng):
        x = rng.integers(-255, 256, (64, 8, 8)).astype(np.int32)
        want = np.stack([G.fdct(t) for t in x]).reshape(64, 64)
        got = np.asarray(dct.fdct(jnp.asarray(x.reshape(64, 64).T))).T
        assert (want == got).all()

    @pytest.mark.parametrize("q_level", [1, 2, 3, 4])
    def test_quant_dequant_exact(self, rng, q_level):
        f = rng.integers(-20000, 20000, (32, 8, 8)).astype(np.int32)
        inter = rng.integers(0, 2, 32).astype(bool)
        want_q = np.stack([G.quantize(t, bool(i), q_level) for t, i in zip(f, inter)])
        got_q = np.asarray(dct.quantize(jnp.asarray(f.reshape(32, 64).T),
                                        jnp.asarray(inter), q_level)).T.reshape(32, 8, 8)
        assert (want_q == got_q).all()
        want_d = np.stack([G.dequantize(t, bool(i), q_level) for t, i in zip(want_q, inter)])
        got_d = np.asarray(dct.dequantize(jnp.asarray(want_q.reshape(32, 64).T),
                                          jnp.asarray(inter), q_level)).T.reshape(32, 8, 8)
        assert (want_d == got_d).all()

    def test_idct_exact(self, rng):
        iq = rng.integers(-2047, 2048, (128, 8, 8)).astype(np.int32)
        want = np.stack([G.idct(t) for t in iq])
        got = np.asarray(dct.idct(jnp.asarray(iq.reshape(128, 64).T))).T.reshape(128, 8, 8)
        assert (want == got).all()

    @pytest.mark.parametrize("vl", [1, 3])
    def test_motion_exact(self, video_factory, vl):
        cfg = EncoderConfig(xl=4, yl=4, vector_level=vl)
        frames = video_factory(96, 64, 2, kind="pan")
        p0 = G.subsample_420(*frames[0])
        p1 = G.subsample_420(*frames[1])
        fr0 = G.encode_frame(cfg, *p0, None, 0)
        prev = (fr0.recon_y, fr0.recon_u, fr0.recon_v)
        mr = motion.estimate_and_predict(
            jnp.asarray(p1[0]), jnp.asarray(p1[1]), jnp.asarray(p1[2]),
            jnp.asarray(prev[0]), jnp.asarray(prev[1]), jnp.asarray(prev[2]),
            jnp.asarray(False), cfg.yr, cfg.ur)
        nby, nbx = 4, 6
        for by in range(nby):
            for bx in range(nbx):
                dec = G.motion_estimate_block(
                    cfg, p1[0][by*16:by*16+16, bx*16:bx*16+16], np.pad(prev[0], cfg.yr+1),
                    by, bx, nby, nbx, False)
                assert bool(mr.inter[by, bx]) == dec.inter, (by, bx)
                if dec.inter:
                    assert int(mr.mvx[by, bx]) == dec.mvx, (by, bx)
                    assert int(mr.mvy[by, bx]) == dec.mvy, (by, bx)
                yp, up, vp = G.predict_block(cfg, dec, np.pad(prev[0], cfg.yr+1),
                                             np.pad(prev[1], cfg.ur+1),
                                             np.pad(prev[2], cfg.ur+1), by, bx)
                assert (np.asarray(mr.pred_y[by, bx]) == yp).all(), (by, bx)
                assert (np.asarray(mr.pred_u[by, bx]) == up).all(), (by, bx)
                assert (np.asarray(mr.pred_v[by, bx]) == vp).all(), (by, bx)


class TestFullStream:
    @pytest.mark.parametrize("kind", ["pan", "noise"])
    def test_stream_bit_exact_vs_golden(self, video_factory, kind):
        cfg = EncoderConfig(xl=5, yl=5, vector_level=3, q_level=2)
        frames = video_factory(96, 64, 5, kind=kind)
        seq = SequenceConfig(96, 64, 3)
        gold = G.encode_sequence(cfg, seq, frames)
        got = Encoder(cfg).encode(frames, 96, 64, pframes_count=3)
        assert gold == got

    @pytest.mark.parametrize("q_level,vl", [(1, 1), (4, 2), (2, 3)])
    def test_stream_bit_exact_configs(self, video_factory, q_level, vl):
        cfg = EncoderConfig(xl=5, yl=5, vector_level=vl, q_level=q_level)
        frames = video_factory(80, 64, 4)
        seq = SequenceConfig(80, 64, 23)
        gold = G.encode_sequence(cfg, seq, frames)
        got = Encoder(cfg).encode(frames, 80, 64)
        assert gold == got

    def test_stream_decodes(self, video_factory):
        cfg = EncoderConfig(xl=5, yl=5)
        frames = video_factory(96, 80, 4)
        stream = Encoder(cfg).encode(frames, 96, 80, pframes_count=2)
        dec = D.decode_sequence(stream, cfg)
        assert len(dec.pictures) == 4
        assert [p.coding_type for p in dec.pictures] == [1, 2, 2, 1]

    def test_stop_modes_match_golden(self, video_factory):
        cfg = EncoderConfig(xl=4, yl=4)
        frames = video_factory(64, 64, 2)
        seq = SequenceConfig(64, 64, 5)
        for mode, pg in (("coincident", 0), ("partial", 64 * 16 // 4)):
            gold = G.encode_sequence(cfg, seq, frames, stop_mode=mode, partial_groups=pg)
            got = Encoder(cfg).encode(frames, 64, 64, 5, stop_mode=mode, partial_groups=pg)
            assert gold == got, mode

    def test_multi_sequence_reuse(self, video_factory):
        enc = Encoder(EncoderConfig(xl=5, yl=5))
        f1 = video_factory(64, 64, 2)
        f2 = video_factory(96, 64, 2)
        s1 = enc.encode(f1, 64, 64, 1)
        s2 = enc.encode(f2, 96, 64, 1)
        assert s1[:4] == b"\x00\x00\x01\xb3" and s2[:4] == b"\x00\x00\x01\xb3"
        g1 = G.encode_sequence(EncoderConfig(xl=5, yl=5), SequenceConfig(64, 64, 1), f1)
        g2 = G.encode_sequence(EncoderConfig(xl=5, yl=5), SequenceConfig(96, 64, 1), f2)
        assert s1 == g1 and s2 == g2


class TestChunkedScan:
    def test_chunked_encode_bit_exact(self, video_factory):
        cfg = EncoderConfig(xl=5, yl=5, vector_level=3, q_level=2)
        frames = video_factory(96, 64, 7)
        seq = SequenceConfig(96, 64, 2)
        gold = G.encode_sequence(cfg, seq, frames)
        got = Encoder(cfg).encode(frames, 96, 64, pframes_count=2, chunk_frames=3)
        assert gold == got

    def test_chunked_equals_streaming(self, video_factory):
        cfg = EncoderConfig(xl=5, yl=5)
        frames = video_factory(80, 64, 6, kind="noise")
        a = Encoder(cfg).encode(frames, 80, 64, pframes_count=4, chunk_frames=6)
        b = Encoder(cfg).encode(frames, 80, 64, pframes_count=4, chunk_frames=1)
        assert a == b

    def test_unrolled_scan_equals_rolled(self, video_factory):
        """encode_gop_scan unroll=2/3 must be byte-identical to unroll=1
        (same per-frame ops, same order; only scan step granularity changes),
        and a non-divisible unroll falls back to 1."""
        import jax.numpy as jnp

        from fpga_mpeg2_encoder_tpu.models.encoder import encode_gop_scan

        frames = video_factory(96, 64, 6)
        fy = jnp.asarray(np.stack([f[0] for f in frames]))
        fu = jnp.asarray(np.stack([f[1] for f in frames]))
        fv = jnp.asarray(np.stack([f[2] for f in frames]))
        py = jnp.zeros((64, 96), jnp.uint8)
        pc = jnp.zeros((32, 48), jnp.uint8)
        kw = dict(yr=6, ur=3, q_level=2, row_cap=1024, frame_cap=16384,
                  seq_cap=131072)

        outs = {}
        for u in (1, 2, 3, 4):   # 4 does not divide 6 -> fallback rung
            out = encode_gop_scan(fy, fu, fv, py, pc, pc, jnp.int32(0),
                                  jnp.int32(0), jnp.int32(2), **kw, unroll=u)
            assert not bool(out[7])
            outs[u] = (np.asarray(out[3]), int(out[4]),
                       np.asarray(out[8]), np.asarray(out[9]))
        sw1, sb1, fb1, fi1 = outs[1]
        nw = (sb1 + 31) // 32
        for u in (2, 3, 4):
            sw, sb, fb, fi = outs[u]
            assert sb == sb1
            assert (sw[:nw] == sw1[:nw]).all(), f"unroll={u}"
            assert (fb == fb1).all() and (fi == fi1).all(), f"unroll={u}"

    def test_overflow_retry_path(self, video_factory):
        # tiny caps force the overflow retry (symbols-only device step +
        # host-side stitch, models/encoder._encode_frame_hoststitch)
        cfg = EncoderConfig(xl=4, yl=4, q_level=1)
        frames = video_factory(64, 64, 3, kind="noise")
        enc = Encoder(cfg, row_cap=8, frame_cap=16)
        got = enc.encode(frames, 64, 64, pframes_count=1)
        seq = SequenceConfig(64, 64, 1)
        assert got == G.encode_sequence(cfg, seq, frames)

    def test_overflow_retry_path_chunked(self, video_factory):
        # the chunked scan's overflow retry re-encodes the chunk frame by
        # frame through the same host-stitch path, byte-identically
        cfg = EncoderConfig(xl=4, yl=4, q_level=1)
        frames = video_factory(64, 64, 4, kind="noise")
        enc = Encoder(cfg, row_cap=8, frame_cap=16)
        got = enc.encode(frames, 64, 64, pframes_count=1, chunk_frames=4)
        want = Encoder(cfg).encode(frames, 64, 64, pframes_count=1)
        assert got == want


@pytest.mark.parametrize("w", [416, 528])
def test_wide_geometry_stream_bit_exact(video_factory, w):
    """Width-band regression: the r04 acsym routing bug only manifested at
    frames >= 416 px wide (nbx >= 26, lane offsets crossing 256) - a band no
    other CPU test reached.  Pin the XLA path against the golden model
    there so width-scaling bugs in ANY stage surface in CI."""
    cfg = EncoderConfig(xl=6, yl=4, vector_level=3, q_level=2)
    frames = video_factory(w, 64, 3)
    seq = SequenceConfig(w, 64, 1)
    assert Encoder(cfg).encode(frames, w, 64, 1) == \
        G.encode_sequence(cfg, seq, frames)


def test_reciprocal_division_exhaustive():
    """The intra quantiser divides a 16-bit value by INTRA_Q via f32 reciprocal
    multiplication + floor; validate exactness over the entire dividend range."""
    from fpga_mpeg2_encoder_tpu.core import tables as T
    t = np.arange(65536, dtype=np.float32)
    for w in np.unique(np.asarray(T.INTRA_Q)):
        recip = np.float32((1.0 + 2.0 ** -21) / np.float32(w))
        got = np.floor(t * recip).astype(np.int64)
        want = np.arange(65536, dtype=np.int64) // int(w)
        assert (got == want).all(), f"w={w}"


def test_tile_count_not_multiple_of_8(video_factory):
    # 80x80 -> 25 MBs * 6 tiles = 150 coefficients columns: exercises the
    # kron-fold padding path in ops/dct.fdct (N % 8 != 0)
    cfg = EncoderConfig(xl=5, yl=5)
    frames = video_factory(80, 80, 3)
    seq = SequenceConfig(80, 80, 1)
    assert Encoder(cfg).encode(frames, 80, 80, 1) == G.encode_sequence(cfg, seq, frames)


def test_reference_fixture_size_288x208(video_factory):
    """Parity at the reference testbench's first clip size (SIM/tb_mpeg2encoder.v:29).

    The actual clip (SIM/data.zip) is not available in this environment; this
    uses synthetic panning content at the same geometry."""
    cfg = EncoderConfig(xl=7, yl=6, vector_level=3, q_level=2)   # tb parameters
    frames = video_factory(288, 208, 3)
    seq = SequenceConfig(288, 208, 23)
    gold = G.encode_sequence(cfg, seq, frames)
    got = Encoder(cfg).encode(frames, 288, 208, 23)
    assert got == gold
    dec = D.decode_sequence(got, cfg)
    assert [p.coding_type for p in dec.pictures] == [1, 2, 2]
