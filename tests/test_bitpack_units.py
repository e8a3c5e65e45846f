"""Unit tests for the device bit-packing primitives against the BitWriter
reference: the budgeted pack tree (with per-level overflow detection) and the
O(frame) sequence append."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fpga_mpeg2_encoder_tpu.core.bitstream import BitWriter
from fpga_mpeg2_encoder_tpu.ops import bitpack


def _random_symbols(rng, rows, s, density=0.1):
    lens = np.zeros((rows, s), np.int32)
    mask = rng.random((rows, s)) < density
    lens[mask] = rng.integers(1, 25, mask.sum())
    codes = rng.integers(0, 1 << 24, (rows, s)).astype(np.uint32) \
        & ((1 << np.minimum(lens, 31)) - 1).astype(np.uint32)
    return codes, lens


def _reference_rows(codes, lens):
    out = []
    for r in range(codes.shape[0]):
        bw = BitWriter()
        for c, l in zip(codes[r].tolist(), lens[r].tolist()):
            bw.put(int(c), int(l))
        out.append((bw.to_bytes_aligned(), bw.bit_length))
    return out


@pytest.mark.parametrize("s,cap,budget", [
    (517, 64, 0), (517, 64, 8), (2048, 256, 8), (1000, 128, 4),
])
def test_pack_symbols_matches_bitwriter(rng, s, cap, budget):
    codes, lens = _random_symbols(rng, 6, s)
    w, b, ovf = jax.jit(
        lambda c, l: bitpack.pack_symbols(c, l, cap, budget_bps=budget)
    )(jnp.asarray(codes), jnp.asarray(lens))
    assert not bool(ovf)
    wh, bh = np.asarray(w), np.asarray(b)
    for r, (ref_bytes, ref_bits) in enumerate(_reference_rows(codes, lens)):
        aligned = (ref_bits + 7) & ~7
        assert int(bh[r]) == aligned
        got = wh[r].astype(">u4").tobytes()[: len(ref_bytes)]
        assert got == ref_bytes, f"row {r}"


def test_pack_symbols_budget_overflow_detected(rng):
    """A locally dense row must trip the budget's per-level overflow flag
    rather than silently dropping bits."""
    s = 2048
    codes = np.zeros((2, s), np.uint32)
    lens = np.zeros((2, s), np.int32)
    lens[0, :400] = 24                      # 9600 bits clustered at the front
    codes[0, :400] = 0xABCDEF
    w, b, ovf = bitpack.pack_symbols(jnp.asarray(codes), jnp.asarray(lens),
                                     cap_words=4096, budget_bps=2,
                                     budget_margin=64)
    assert bool(ovf)
    # and the un-budgeted tree packs it fine
    w2, b2, ovf2 = bitpack.pack_symbols(jnp.asarray(codes), jnp.asarray(lens),
                                        cap_words=4096, budget_bps=0)
    assert not bool(ovf2) and int(np.asarray(b2)[0]) == 9600


def test_append_bitstring_matches_bitwriter(rng):
    """Random sequence of appends == one BitWriter stream (bit-for-bit),
    including appends that straddle word boundaries in every phase."""
    cap = 4096
    seq = jnp.zeros((cap,), jnp.uint32)
    seq_bits = jnp.int32(0)
    bw = BitWriter()
    append = jax.jit(bitpack.append_bitstring)
    for _ in range(25):
        nbits = int(rng.integers(1, 900))
        payload = rng.integers(0, 256, (nbits + 7) // 8, dtype=np.uint8)
        # left-justified word buffer of the payload, truncated to nbits
        bits = np.unpackbits(payload)[:nbits]
        for bit in bits.tolist():
            bw.put(int(bit), 1)
        wordbuf = np.zeros(32, np.uint32)
        packed = np.packbits(np.pad(bits, (0, 32 * 32 - nbits)))
        wordbuf = packed.view(">u4").astype(np.uint32)
        seq, seq_bits = append(seq, seq_bits,
                               jnp.asarray(wordbuf), jnp.int32(nbits))
    raw_bits = bw.bit_length
    bw_bytes = bw.to_bytes_aligned()
    got = np.asarray(seq).astype(">u4").tobytes()[: len(bw_bytes)]
    assert int(seq_bits) == raw_bits
    assert got == bw_bytes


def test_append_bitstrings_batched_matches_unbatched(rng):
    """The scatter-free batched append must equal B independent scalar
    appends for arbitrary per-stream offsets and word-boundary phases."""
    B, cap, c = 5, 512, 64
    seq = jnp.zeros((B, cap), jnp.uint32)
    seq_bits = jnp.zeros((B,), jnp.int32)
    refs = [(jnp.zeros((cap,), jnp.uint32), jnp.int32(0)) for _ in range(B)]
    batched = jax.jit(bitpack.append_bitstrings_batched)
    for step in range(6):
        b = jnp.asarray(rng.integers(0, 1 << 32, (B, c), dtype=np.uint64)
                        .astype(np.uint32))
        nbits = rng.integers(1, 32 * c, (B,)).astype(np.int32)
        # left-justify: zero bits past each stream's length
        word = np.arange(c)[None, :]
        full = word < (nbits[:, None] // 32)
        part = word == (nbits[:, None] // 32)
        rem = (nbits[:, None] % 32).astype(np.uint32)
        mask = np.where(
            full, np.uint32(0xFFFFFFFF),
            np.where(part & (rem > 0),
                     (np.uint32(0xFFFFFFFF) << (32 - rem)).astype(np.uint32),
                     np.uint32(0)))
        b = jnp.asarray(np.asarray(b) & mask)
        seq, seq_bits = batched(seq, seq_bits, b, jnp.asarray(nbits))
        for k in range(B):
            refs[k] = bitpack.append_bitstring(refs[k][0], refs[k][1],
                                               b[k], jnp.int32(nbits[k]))
    for k in range(B):
        assert int(seq_bits[k]) == int(refs[k][1]), k
        assert (np.asarray(seq)[k] == np.asarray(refs[k][0])).all(), k


def test_pack_symbols_worst_case_caps_matches_bitwriter():
    """Un-budgeted tree at a cap just above the worst case (700 symbols of up
    to 24 bits = 525 words), half the slots empty."""
    rng = np.random.default_rng(9)
    r, s, cap = 5, 700, 640
    lens = rng.integers(0, 25, (r, s)).astype(np.int32)
    lens[rng.random((r, s)) < 0.5] = 0
    codes = np.zeros((r, s), np.uint32)
    nz = lens > 0
    codes[nz] = rng.integers(0, 1 << 24, nz.sum()).astype(np.uint32) \
        & ((1 << lens[nz].astype(np.uint64)) - 1).astype(np.uint32)
    w, b, ovf = bitpack.pack_symbols(jnp.asarray(codes), jnp.asarray(lens), cap,
                                     budget_bps=0)
    assert not bool(ovf)
    wh, bh = np.asarray(w), np.asarray(b)
    for k, (ref_bytes, ref_bits) in enumerate(_reference_rows(codes, lens)):
        assert int(bh[k]) == (ref_bits + 7) & ~7
        assert wh[k].astype(">u4").tobytes()[: len(ref_bytes)] == ref_bytes, k


@pytest.mark.parametrize("r,c,cap", [
    (20, 128, 1024),      # CIF-like: 18 slice rows + headers
    (5, 256, 512),        # tiny frame, odd row count, sub-16 rows
    (33, 128, 8192),      # crosses the 32-row pow2 boundary
])
def test_merge_rows_matches_concatenation(r, c, cap):
    """Byte-aligned rows merge into their concatenation; past ``cap`` words
    the content is cut but the bit count stays exact."""
    rng = np.random.default_rng(100 + r)
    bits = (rng.integers(0, c * 24 // 8, (r,)) * 8).astype(np.int32)
    words = np.zeros((r, c), np.uint32)
    for k in range(r):
        nw = (int(bits[k]) + 31) // 32
        w = rng.integers(0, 1 << 32, nw, dtype=np.uint64).astype(np.uint32)
        rem = int(bits[k]) % 32
        if nw and rem:
            w[-1] &= np.uint32((0xFFFFFFFF << (32 - rem)) & 0xFFFFFFFF)
        words[k, :nw] = w
    want = b"".join(words[k].astype(">u4").tobytes()[: bits[k] // 8]
                    for k in range(r))
    got_w, got_b = bitpack.merge_rows(jnp.asarray(words), jnp.asarray(bits), cap)
    assert int(got_b) == int(bits.sum())
    keep = min(len(want), 4 * cap)
    assert np.asarray(got_w).astype(">u4").tobytes()[:keep] == want[:keep]


def test_append_bitstring_rejects_undersized_accumulator():
    """The sizing contract is enforced at trace time: an accumulator not
    strictly wider than the appended width + 1 corrupts silently under
    dynamic-slice clamping, so it must raise instead."""
    with pytest.raises(ValueError, match="sizing contract"):
        bitpack.append_bitstring(jnp.zeros(64, jnp.uint32), jnp.int32(0),
                                 jnp.zeros(64, jnp.uint32), jnp.int32(32))
    with pytest.raises(ValueError, match="sizing contract"):
        bitpack.append_bitstrings_batched(
            jnp.zeros((2, 64), jnp.uint32), jnp.zeros(2, jnp.int32),
            jnp.zeros((2, 64), jnp.uint32), jnp.zeros(2, jnp.int32))
