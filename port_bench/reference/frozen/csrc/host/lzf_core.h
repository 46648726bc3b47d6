// LZF codec and HDF5 byte shuffle, for the port's HDF5 writer and reader.
//
// LZF stream format (liblzf; HDF5 filter 32000, as h5py registers it):
//   ctrl < 0x20           : a literal run of ctrl + 1 bytes follows
//   ctrl >= 0x20, len < 9 : ((len - 2) << 5) | ((dist - 1) >> 8),
//                           (dist - 1) & 0xff
//   ctrl >= 0x20, len >= 9: (7 << 5) | ((dist - 1) >> 8), len - 9,
//                           (dist - 1) & 0xff
// with a back-reference distance dist in [1, 8192] and a match length len
// in [3, 264].  The encoder is greedy over a 4-byte hash of every probe
// position; after repeated misses it steps faster through incompressible
// bytes.  The HDF5 shuffle of n records of rec bytes is the transpose of
// an (n, rec) byte matrix: byte plane p holds byte p of every record.
#pragma once
#include <cstdint>
#include <cstring>
#if defined(__x86_64__)
#include <immintrin.h>
#include <cpuid.h>
#endif

namespace {

constexpr int kHashLog = 16;
constexpr int kHashSize = 1 << kHashLog;
constexpr int kMaxDist = 8192;
constexpr int kMaxMatch = 264;   // 2 + 7 + 255
constexpr int kMaxLit = 32;

inline uint32_t read32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;
}

inline uint64_t read64(const uint8_t* p) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    return v;
}

inline uint32_t hash3(const uint8_t* p) {
    // hash the full 4-byte window (match verification still only needs 3
    // bytes); measured both faster AND a hair better ratio than the
    // 3-byte hash on shuffled truth records — fewer collisions
    return (read32(p) * 2654435761u) >> (32 - kHashLog);
}

// Greedy LZF encode of in[0..n) into out (capacity out_cap).
// Returns compressed size, or 0 if the output would not fit (caller then
// stores the shuffled-raw chunk with the lzf filter bit masked out).
int lzf_encode(const uint8_t* in, int n, uint8_t* out, int out_cap) {
    if (n <= 0) return 0;
    int32_t htab[kHashSize];
    for (int i = 0; i < kHashSize; ++i) htab[i] = -1;

    int ip = 0, op = 0;
    int lit_start = 0;  // first byte of the pending literal run

    auto flush_literals = [&](int end) -> bool {
        int len = end - lit_start;
        while (len > 0) {
            int take = len < kMaxLit ? len : kMaxLit;
            if (op + 1 + take > out_cap) return false;
            out[op++] = uint8_t(take - 1);
            std::memcpy(out + op, in + lit_start, take);
            op += take;
            lit_start += take;
            len -= take;
        }
        return true;
    };

    // skip-acceleration: after repeated probe misses advance faster
    // through incompressible regions (costs a little ratio on borderline
    // data, big speedup on the float-mantissa byte planes)
    int misses = 0;
    // stop 4 bytes from the end: hash3 loads a full 4-byte window (a
    // trailing 3-byte match is forfeited; the tail flushes as literals)
    while (ip < n - 3) {
        uint32_t h = hash3(in + ip);
        int32_t ref = htab[h];
        htab[h] = ip;
        if (ref >= 0 && ip - ref <= kMaxDist &&
            (read32(in + ref) & 0xffffffu) == (read32(in + ip) & 0xffffffu)) {
            misses = 0;
            // extend the match 8 bytes at a time
            int len = 3;
            int max_len = n - ip;
            if (max_len > kMaxMatch) max_len = kMaxMatch;
            while (len + 8 <= max_len) {
                uint64_t diff = read64(in + ref + len) ^ read64(in + ip + len);
                if (diff) {
                    len += __builtin_ctzll(diff) >> 3;
                    goto extended;
                }
                len += 8;
            }
            while (len < max_len && in[ref + len] == in[ip + len]) ++len;
        extended:
            if (!flush_literals(ip)) return 0;
            int dist = ip - ref - 1;          // stored distance - 1
            int l = len - 2;
            if (l < 7) {
                if (op + 2 > out_cap) return 0;
                out[op++] = uint8_t((l << 5) | (dist >> 8));
                out[op++] = uint8_t(dist & 0xff);
            } else {
                if (op + 3 > out_cap) return 0;
                out[op++] = uint8_t((7 << 5) | (dist >> 8));
                out[op++] = uint8_t(l - 7);
                out[op++] = uint8_t(dist & 0xff);
            }
            // seed only the match edges: long runs are found again from
            // the trailing seed
            int stop = ip + len - 2;
            if (stop > n - 4) stop = n - 4;
            if (ip + 1 <= stop) htab[hash3(in + ip + 1)] = ip + 1;
            if (ip + 2 <= stop) htab[hash3(in + ip + 2)] = ip + 2;
            if (stop > ip + 2) htab[hash3(in + stop)] = stop;
            ip += len;
            lit_start = ip;
        } else {
            ip += 1 + (misses >> 4);
            ++misses;
        }
    }
    if (!flush_literals(n)) return 0;
    return op;
}

// Byte-plane shuffle: records of `rec` bytes; out[plane*n_rec + i] =
// in[i*rec + plane] (HDF5 shuffle filter layout).
void shuffle_scalar(const uint8_t* in, int nbytes, int rec, uint8_t* out) {
    int n_rec = nbytes / rec;
    for (int plane = 0; plane < rec; ++plane) {
        const uint8_t* src = in + plane;
        uint8_t* dst = out + plane * n_rec;
        for (int i = 0; i < n_rec; ++i) dst[i] = src[int64_t(i) * rec];
    }
}

#if defined(__x86_64__)
bool have_avx512vbmi() {
    unsigned eax, ebx, ecx, edx;
    if (!__get_cpuid_count(7, 0, &eax, &ebx, &ecx, &edx)) return false;
    // AVX512F (ebx bit 16), AVX512BW (ebx bit 30), AVX512VBMI (ecx bit 1)
    return (ebx & (1u << 16)) && (ebx & (1u << 30)) && (ecx & (1u << 1));
}

// Transpose a 64 x 64 byte tile (rows of src_stride bytes) into dst (rows
// of dst_stride bytes) with six rounds of two-source byte permutes.
__attribute__((target("avx512f,avx512bw,avx512vbmi")))
void transpose64x64(const uint8_t* src, int64_t src_stride, uint8_t* dst,
                    int64_t dst_stride) {
    __m512i r[64];
    for (int i = 0; i < 64; ++i)
        r[i] = _mm512_loadu_si512(src + i * src_stride);
    // 6 butterfly rounds, each exchanging ONE index bit between the row
    // and column coordinates.  Invariant: after rounds 0..k-1, register i
    // lane j holds in[(i & ~M) | (j & M)][(j & ~M) | (i & M)] with
    // M = 2^k - 1; after all 6 rounds register i is byte-plane i.
    // Round k update (derived from the invariant): for the pair
    // (a, b) = (row i, row i^step) with bit k of i clear,
    //   new_a[j] = (bit_k(j) ? b : a)[j & ~step]
    //   new_b[j] = (bit_k(j) ? b : a)[j |  step]
    // — one vpermi2b per output register.
    for (int k = 0; k < 6; ++k) {
        const int step = 1 << k;
        alignas(64) uint8_t idx_lo[64], idx_hi[64];
        for (int j = 0; j < 64; ++j) {
            int from_b = (j & step) ? 64 : 0;
            idx_lo[j] = uint8_t(from_b + (j & ~step));
            idx_hi[j] = uint8_t(from_b + (j | step));
        }
        __m512i vlo = _mm512_load_si512(idx_lo);
        __m512i vhi = _mm512_load_si512(idx_hi);
        for (int i = 0; i < 64; ++i) {
            if (i & step) continue;
            __m512i a = r[i], b = r[i ^ step];
            r[i] = _mm512_permutex2var_epi8(a, vlo, b);
            r[i ^ step] = _mm512_permutex2var_epi8(a, vhi, b);
        }
    }
    for (int i = 0; i < 64; ++i)
        _mm512_storeu_si512(dst + i * dst_stride, r[i]);
}

// AVX-512 shuffle for 32-byte records (the TRUTH_DTYPE case — the only
// record size on the hot path).  The HDF5 shuffle is the transpose of an
// (n_rec, 32) byte matrix.  Process 128 records (4 KiB) per tile: load
// them as a 64x64 byte matrix (each 64-byte row holds records {2j, 2j+1}),
// transpose with the vpermi2b butterfly above, then tile row c holds
// plane c%32 of the even (c < 32) / odd (c >= 32) local records,
// contiguous in j.  One vpermi2b pair re-interleaves (plane p of evens,
// plane p of odds) into the two contiguous 64-byte plane stores.  Other
// record sizes fall back to the scalar shuffle.
__attribute__((target("avx512f,avx512bw,avx512vbmi")))
void shuffle_avx512_rec32(const uint8_t* in, int nbytes, uint8_t* out) {
    constexpr int rec = 32;
    int n_rec = nbytes / rec;
    int n_tiles = nbytes / (64 * 64);       // 64 rows of 64 bytes
    // interleave patterns: z = even-row byte j -> lane 2j, odd -> 2j+1
    alignas(64) uint8_t ilo[64], ihi[64];
    for (int j = 0; j < 32; ++j) {
        ilo[2 * j] = uint8_t(j);            // evens from a (lanes 0..31)
        ilo[2 * j + 1] = uint8_t(64 + j);   // odds from b
        ihi[2 * j] = uint8_t(32 + j);
        ihi[2 * j + 1] = uint8_t(64 + 32 + j);
    }
    __m512i vlo = _mm512_load_si512(ilo);
    __m512i vhi = _mm512_load_si512(ihi);
    alignas(64) uint8_t tile[64 * 64];
    for (int t = 0; t < n_tiles; ++t) {
        const uint8_t* src = in + t * 64 * 64;   // 128 records
        transpose64x64(src, 64, tile, 64);
        // tile row c = plane c%32 of records 2j + (c>=32), j = 0..63
        for (int p = 0; p < 32; ++p) {
            __m512i even = _mm512_load_si512(tile + p * 64);
            __m512i odd = _mm512_load_si512(tile + (p + 32) * 64);
            uint8_t* dst = out + p * n_rec + t * 128;
            _mm512_storeu_si512(dst,
                                _mm512_permutex2var_epi8(even, vlo, odd));
            _mm512_storeu_si512(dst + 64,
                                _mm512_permutex2var_epi8(even, vhi, odd));
        }
    }
    int done = n_tiles * 128;               // records consumed
    if (done < n_rec)
        for (int plane = 0; plane < rec; ++plane) {
            const uint8_t* src = in + plane;
            uint8_t* dst = out + plane * n_rec;
            for (int i = done; i < n_rec; ++i)
                dst[i] = src[int64_t(i) * rec];
        }
}

const bool kAvx512 = have_avx512vbmi();

inline void shuffle(const uint8_t* in, int nbytes, int rec, uint8_t* out) {
    if (kAvx512 && rec == 32 && nbytes % 32 == 0)
        shuffle_avx512_rec32(in, nbytes, out);
    else
        shuffle_scalar(in, nbytes, rec, out);
}
#else
inline void shuffle(const uint8_t* in, int nbytes, int rec, uint8_t* out) {
    shuffle_scalar(in, nbytes, rec, out);
}
#endif

// Decode the LZF stream in[0..n) into out (capacity out_cap).  Returns the
// decoded size, or -1 if the stream is malformed or does not fit.
int64_t lzf_decode(const uint8_t* in, int64_t n, uint8_t* out,
                   int64_t out_cap) {
    int64_t ip = 0, op = 0;
    while (ip < n) {
        unsigned ctrl = in[ip++];
        if (ctrl < 0x20) {                       // literal run
            int64_t len = int64_t(ctrl) + 1;
            if (ip + len > n || op + len > out_cap) return -1;
            std::memcpy(out + op, in + ip, len);
            ip += len;
            op += len;
            continue;
        }
        int64_t len = ctrl >> 5;                 // back reference
        if (len == 7) {
            if (ip >= n) return -1;
            len += in[ip++];
        }
        if (ip >= n) return -1;
        int64_t ref = op - (int64_t(ctrl & 0x1f) << 8) - 1 - in[ip++];
        len += 2;
        if (ref < 0 || op + len > out_cap) return -1;
        int64_t dist = op - ref;
        if (dist >= len) {
            std::memcpy(out + op, out + ref, len);
            op += len;
        } else if (dist >= 8) {                  // overlapping, 8 at a time
            int64_t end = op + len;
            for (; op + 8 <= end; op += 8, ref += 8)
                std::memcpy(out + op, out + ref, 8);
            while (op < end) out[op++] = out[ref++];
        } else {                                 // a run of a short period
            for (int64_t i = 0; i < len; ++i) out[op++] = out[ref + i];
        }
    }
    return op;
}

// Inverse of the shuffle: out[i * rec + plane] = in[plane * n_rec + i],
// a tile of records at a time so that the scattered writes stay in cache;
// bytes past the last whole record are copied as they are, as HDF5 does.
void unshuffle(const uint8_t* in, int64_t nbytes, int rec, uint8_t* out) {
    constexpr int64_t kTile = 256;
    int64_t n_rec = nbytes / rec;
    for (int64_t i0 = 0; i0 < n_rec; i0 += kTile) {
        int64_t i1 = i0 + kTile < n_rec ? i0 + kTile : n_rec;
        for (int plane = 0; plane < rec; ++plane) {
            const uint8_t* src = in + plane * n_rec;
            uint8_t* dst = out + plane;
            for (int64_t i = i0; i < i1; ++i) dst[i * rec] = src[i];
        }
    }
    std::memcpy(out + n_rec * rec, in + n_rec * rec, nbytes - n_rec * rec);
}

}  // namespace
