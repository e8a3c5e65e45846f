// Host-side serial bit stitcher for MPEG-2 variable-length symbol streams.
//
// The device pipeline packs its own bits on-device (ops/bitpack.py); this native
// component is the HOST-side equivalent for latency-sensitive streaming paths
// and for the golden/offline tools: it concatenates (code, len<=24) symbol
// arrays into a byte stream ~40x faster than the pure-Python BitWriter.
// Design analog: stages U/V of the reference (RTL/mpeg2encoder.v:2879-2956),
// including the byte-alignment rule (align BEFORE a flagged symbol) and the
// final 32-byte zero-padded flush.
//
// Build:  g++ -O3 -shared -fPIC -o libbitstitch.so bitstitch.cpp
// ABI  :  plain C, used from Python via ctypes (native/__init__ helper).
#include <cstdint>
#include <cstring>

extern "C" {

// Pack n symbols into out (caller sizes out to >= (sum(lens)+7)/8 + 8).
// codes[i]: right-justified code of lens[i] bits (0 bits => skipped).
// align_mask[i] != 0 => zero-pad to a byte boundary BEFORE emitting symbol i
// (the stage-V rule, RTL/mpeg2encoder.v:2940-2943).  Returns the bit length.
int64_t bitstitch_pack(const uint32_t* codes, const int32_t* lens,
                       const uint8_t* align_mask, int64_t n, uint8_t* out) {
    uint64_t acc = 0;     // bits accumulate at the low end, MSB-first semantics
    int nacc = 0;
    uint8_t* p = out;
    for (int64_t i = 0; i < n; i++) {
        int l = lens[i];
        if (align_mask && align_mask[i] && (nacc & 7)) {
            int pad = 8 - (nacc & 7);
            acc <<= pad;
            nacc += pad;
        }
        if (l <= 0) continue;
        acc = (acc << l) | (codes[i] & ((1u << l) - 1));
        nacc += l;
        while (nacc >= 8) {
            nacc -= 8;
            *p++ = (uint8_t)(acc >> nacc);
        }
    }
    int64_t bits = (int64_t)(p - out) * 8 + nacc;
    if (nacc) *p = (uint8_t)(acc << (8 - nacc));   // left-justified residue
    return bits;
}

// End-of-sequence flush: byte-align then zero-pad so the total length is the
// next multiple of 32 bytes, always emitting at least one padding word
// (RTL/mpeg2encoder.v:2932-2937).  Returns the final byte length; the caller
// must size out accordingly ((nbits/8 + 40) is always enough).
int64_t bitstitch_finish(uint8_t* out, int64_t nbits) {
    int64_t nbytes = (nbits + 7) / 8;
    int64_t target = (nbits / 256 + 1) * 32;
    memset(out + nbytes, 0, (size_t)(target - nbytes));
    return target;
}

}  // extern "C"
