"""Parallel variable-length bit packing as a barrel-shift merge tree.

Design
------
The reference packs bits serially, 170 bits/cycle through a shift register
(RTL/mpeg2encoder.v:2879-2956).  Scatter-based packing (offset prefix-sum + two
scatter-adds per symbol) is the usual GPU idiom; whether it beats this tree on
the card is an open measurement.  Here symbols pack by *associative reduction*:
a bit-string with an explicit length is
a monoid under concatenation, so symbols merge pairwise in log2(S) levels.  Each
merge is vectorised word arithmetic:

  concat(A, B):  shift B right by len(A) bits = an elementwise funnel shift by
  (len & 31) plus a word-offset rotation by (len >> 5), done as a log2(C)-step
  barrel shifter of STATIC shifts selected by the offset's bits - no gather, no
  scatter, only elementwise word arithmetic.

Invariant: buffers are left-justified, zero-filled beyond their length, so OR is
concatenation.  Everything also byte-aligns for free (lengths rounded up to 8 with
zero padding already in place), reproducing the stage-V alignment rule
(RTL:2940-2943).
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

def _shift_words_right(x: jnp.ndarray, t: int) -> jnp.ndarray:
    """Shift along the last (word) axis by a static t words, filling zeros."""
    if t == 0:
        return x
    pad = [(0, 0)] * (x.ndim - 1) + [(t, 0)]
    return jnp.pad(x, pad)[..., :x.shape[-1]]


def _funnel_shift(b: jnp.ndarray, bits: jnp.ndarray) -> jnp.ndarray:
    """Shift the bit-string b (words on last axis) right by `bits` (0..31 per node)."""
    s = (bits & 31).astype(jnp.uint32)[..., None]
    prev = _shift_words_right(b, 1)
    lo = b >> s
    hi = jnp.where(s > 0, prev << ((32 - s) & 31), jnp.uint32(0))
    return jnp.where(s > 0, lo | hi, b)


def _word_barrel(b: jnp.ndarray, words: jnp.ndarray, max_words: int) -> jnp.ndarray:
    """Shift right by a dynamic per-node word count via log2 static steps.

    max_words bounds the largest possible shift (the left operand's capacity),
    so early merge levels need only one or two steps."""
    j = 0
    while (1 << j) <= max_words:
        take = ((words >> j) & 1).astype(bool)[..., None]
        b = jnp.where(take, _shift_words_right(b, 1 << j), b)
        j += 1
    return b


def concat_bitstrings(a: jnp.ndarray, bl_a: jnp.ndarray,
                      b: jnp.ndarray, bl_b: jnp.ndarray,
                      out_words: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Concatenate left-justified bit-strings: (..., Ca)+(..., Cb) -> (..., out_words).

    Content beyond out_words*32 bits is silently dropped (callers size for the
    worst case or detect overflow from the returned lengths)."""
    ca, cb = a.shape[-1], b.shape[-1]
    pad_a = [(0, 0)] * (a.ndim - 1) + [(0, out_words - ca)]
    a2 = jnp.pad(a, pad_a) if out_words > ca else a[..., :out_words]
    pad_b = [(0, 0)] * (b.ndim - 1) + [(0, out_words - cb)]
    b2 = jnp.pad(b, pad_b) if out_words > cb else b[..., :out_words]
    b2 = _funnel_shift(b2, bl_a)
    b2 = _word_barrel(b2, (bl_a >> 5).astype(jnp.int32), ca)
    return a2 | b2, bl_a + bl_b


def _pad_last(x: jnp.ndarray, n: int, axis: int = -1) -> jnp.ndarray:
    if n == 0:
        return x
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, n)
    return jnp.pad(x, pad)


def pack_slots(slots: jnp.ndarray, cap_words: int,
               budget_bps: int = 0, budget_margin: int = 1536,
               ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Pack rows of PACKED slots (uint32 = code | len << 27, entropy.pack_slot)
    into left-justified byte-aligned bit-strings; the production entry point
    (one slot array instead of separate code/len arrays halves the HBM
    traffic between symbolisation and packing).

    slots: (..., S) -> (words (..., cap_words) uint32, bits (...,) int32
    byte-aligned, overflow () bool).  Semantics as pack_symbols."""
    return pack_symbols(slots & ((1 << 27) - 1), (slots >> 27).astype(jnp.int32),
                        cap_words, budget_bps, budget_margin)


def pack_symbols(codes: jnp.ndarray, lens: jnp.ndarray, cap_words: int,
                 budget_bps: int = 0, budget_margin: int = 1536,
                 ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Pack rows of (<=24-bit code, len) symbols into left-justified byte-aligned
    bit-strings.

    codes/lens: (..., S) -> (words (..., cap_words) uint32, bits (...,) int32
    byte-aligned, overflow () bool).

    Merge-level buffer widths are normally sized for the worst case (every
    symbol 24 bits).  With ``budget_bps > 0`` a level whose nodes span 2**L
    symbols is instead capped at ``(budget_bps * 2**L + budget_margin) / 32``
    words - a statistical budget that cuts the tree's HBM traffic severalfold
    on real content.  Dropping bits at a capped level is detected EXACTLY
    (a concat drops bits iff its output length exceeds its width; lengths are
    always exact) and reported in the overflow flag, on which callers re-encode
    with worst-case buffers (models/encoder.py's retry path).
    """
    s = codes.shape[-1]
    c = _pad_last(codes.astype(jnp.uint32), s % 2)
    l = _pad_last(lens.astype(jnp.int32), s % 2)

    # fused levels 0+1: pack symbol PAIRS (<=48 bits) into 2-word nodes with
    # direct shift arithmetic, skipping one full pass over the widest level
    c0, c1 = c[..., 0::2], c[..., 1::2]
    l0, l1 = l[..., 0::2], l[..., 1::2]
    l01 = l0 + l1
    over = l01 > 32
    t0 = jnp.where(l0 > 0, c0 << jnp.clip(32 - l0, 0, 31).astype(jnp.uint32),
                   jnp.uint32(0))
    t1in = jnp.where(l1 > 0,
                     c1 << jnp.clip(32 - l01, 0, 31).astype(jnp.uint32),
                     jnp.uint32(0))
    w0 = t0 | jnp.where(over, c1 >> jnp.clip(l01 - 32, 0, 31).astype(jnp.uint32),
                        t1in)
    w1 = jnp.where(over, c1 << jnp.clip(64 - l01, 0, 31).astype(jnp.uint32),
                   jnp.uint32(0))
    buf = jnp.stack([w0, w1], axis=-1)                          # (..., ceil(S/2), 2)
    bl = l01

    level = 1
    ovf = jnp.asarray(False)
    while buf.shape[-2] > 1:
        m = buf.shape[-2]
        buf = _pad_last(buf, m % 2, axis=-2)
        bl = _pad_last(bl, m % 2)
        level += 1
        # nodes at this level cover up to 2**level input symbols of <=24 bits each
        need = (24 * (1 << level) + 31) // 32
        w = min(need, 2 * buf.shape[-1], cap_words)
        if budget_bps > 0:
            w = min(w, max((budget_bps * (1 << level) + budget_margin + 31) // 32, 2))
        a, la = buf[..., 0::2, :], bl[..., 0::2]
        b, lb = buf[..., 1::2, :], bl[..., 1::2]
        buf, bl = concat_bitstrings(a, la, b, lb, w)
        if w < need:
            ovf = ovf | (bl > 32 * w).any()
    # byte-align (stage-V rule, RTL:2940-2943): zero padding is already present
    out = _pad_last(buf[..., 0, :], cap_words - buf.shape[-1])
    return out, align_bytes(bl[..., 0]), ovf


def align_bytes(bits: jnp.ndarray) -> jnp.ndarray:
    """Round bit-lengths up to a byte boundary (zero padding is already present)."""
    return (bits + 7) & ~7


def merge_rows(words: jnp.ndarray, bits: jnp.ndarray, cap_words: int
               ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Concatenate R left-justified bit-strings (rows) into one: (R, C) -> (cap,).

    Used for slice rows -> frame payload and frame payloads -> sequence payload;
    rows are byte-aligned by the caller so start-code alignment is preserved."""
    buf, bl = words, bits
    while buf.shape[-2] > 1:
        m = buf.shape[-2]
        buf = _pad_last(buf, m % 2, axis=-2)
        bl = _pad_last(bl, m % 2)
        w = min(2 * buf.shape[-1], cap_words)
        buf, bl = concat_bitstrings(buf[..., 0::2, :], bl[..., 0::2],
                                    buf[..., 1::2, :], bl[..., 1::2], w)
    return buf[..., 0, :], bl[..., 0]


def append_bitstring(seq: jnp.ndarray, seq_bits: jnp.ndarray,
                     b: jnp.ndarray, b_bits: jnp.ndarray,
                     ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Append a left-justified bit-string b (C words) to a left-justified
    accumulator seq (cap words): funnel-shift b by (seq_bits & 31) and OR it
    in at word offset seq_bits >> 5 via dynamic slices.

    Unlike concat_bitstrings (whose word barrel costs O(cap * log cap) - fine
    inside the merge tree, ruinous for a per-frame sequence append), this
    touches only C+1 words.

    SIZING CONTRACT: the accumulator must be at least C+1 words LARGER than
    the logical capacity checked for overflow, i.e. allocate
    ``seq_cap + C + 1`` words and check ``seq_bits > 32 * seq_cap``.  The
    C+1-word slice window can then sit at any in-range offset; only a
    genuinely overflowing append (off > seq_cap words, which the check
    flags) hits dynamic_slice's offset clamp and corrupts the (discarded)
    content.  Without the margin the clamp bites BELOW the overflow
    threshold - in the worst case (C + 1 == buffer width, e.g. frame
    payloads frame_cap words wide appended with seq_cap == frame_cap) every
    append lands at word 0 and the corruption is silent - so undersized
    accumulators are rejected at trace time."""
    if b.shape[-1] + 1 > seq.shape[-1]:
        raise ValueError(
            f"append_bitstring accumulator ({seq.shape[-1]} words) must "
            f"exceed the appended width + 1 ({b.shape[-1]} + 1); allocate "
            f"seq_cap + C + 1 words (see sizing contract)")
    c = b.shape[-1]
    s = (seq_bits & 31).astype(jnp.uint32)
    bpad = jnp.concatenate([b, jnp.zeros((1,), jnp.uint32)])
    prev = jnp.concatenate([jnp.zeros((1,), jnp.uint32), b])
    sh = jnp.where(s > 0, (bpad >> s) | (prev << ((32 - s) & 31)), bpad)
    off = (seq_bits >> 5).astype(jnp.int32)
    region = jax.lax.dynamic_slice(seq, (off,), (c + 1,)) | sh
    return jax.lax.dynamic_update_slice(seq, region, (off,)), seq_bits + b_bits


def append_bitstrings_batched(seq: jnp.ndarray, seq_bits: jnp.ndarray,
                              b: jnp.ndarray, b_bits: jnp.ndarray,
                              ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched append_bitstring: seq (B, cap), seq_bits (B,), b (B, C),
    b_bits (B,) -> per-stream independent appends.

    NOT vmap(append_bitstring): vmapping turns the scalar dynamic slices into
    gather/scatter with per-row dynamic offsets over the whole (B, cap)
    buffer.  Here the funnel shift vectorises over the batch and the
    placement runs as B
    STATIC-row dynamic_update_slice ops, each touching only C+1 words -
    the exact single-stream fast path, B times.

    Same sizing contract as append_bitstring: allocate seq_cap + C + 1
    words per stream, check seq_bits > 32 * seq_cap."""
    nb, cap = seq.shape
    if b.shape[-1] + 1 > cap:
        raise ValueError(
            f"append_bitstrings_batched accumulator ({cap} words) must "
            f"exceed the appended width + 1 ({b.shape[-1]} + 1); allocate "
            f"seq_cap + C + 1 words (see append_bitstring sizing contract)")
    c = b.shape[-1]
    s = (seq_bits & 31).astype(jnp.uint32)[:, None]           # (B, 1)
    z1 = jnp.zeros((nb, 1), jnp.uint32)
    bpad = jnp.concatenate([b, z1], axis=1)                   # (B, C+1)
    prev = jnp.concatenate([z1, b], axis=1)
    sh = jnp.where(s > 0, (bpad >> s) | (prev << ((32 - s) & 31)), bpad)
    off = (seq_bits >> 5).astype(jnp.int32)                   # (B,)
    for bi in range(nb):
        region = jax.lax.dynamic_slice(
            seq, (jnp.int32(bi), off[bi]), (1, c + 1)) | sh[bi:bi + 1]
        seq = jax.lax.dynamic_update_slice(
            seq, region, (jnp.int32(bi), off[bi]))
    return seq, seq_bits + b_bits
