// Chunk codec of the port's HDF5 files: byte shuffle + LZF over whole
// chunks, and the inverse, with a plain C interface (bound with ctypes by
// larndsim_tpu_torch/io/lzf.py).
//
// A chunk's stream is what the HDF5 pipeline "shuffle (filter 2), then
// LZF (filter 32000)" writes and h5py's LZF filter reads.  A chunk that
// LZF cannot shrink by at least one byte is stored shuffled but not
// compressed, and its filter mask skips LZF, as the HDF5 pipeline does for
// an optional filter that fails.
#include <atomic>
#include <thread>
#include <vector>

#include "lzf_core.h"

namespace {

// Shuffle (rec > 0) and LZF-encode one chunk into dst (chunk_bytes of
// room); returns the stored size and sets *skipped when LZF was skipped.
int64_t encode_one(const uint8_t* src, int chunk_bytes, int rec,
                   uint8_t* scratch, uint8_t* dst, uint8_t* skipped) {
    const uint8_t* plain = src;
    if (rec > 0) {
        shuffle(src, chunk_bytes, rec, scratch);
        plain = scratch;
    }
    int size = lzf_encode(plain, chunk_bytes, dst, chunk_bytes - 1);
    if (size > 0) {
        *skipped = 0;
        return size;
    }
    std::memcpy(dst, plain, chunk_bytes);
    *skipped = 1;
    return chunk_bytes;
}

}  // namespace

extern "C" {

// Encode n_chunks chunks of chunk_bytes each, read one after another from
// in, on up to n_threads threads.  Chunk i's stream starts at
// out + i * chunk_bytes; sizes[i] is its length, skipped[i] 1 when it is
// stored without LZF.  rec 0: no shuffle.
void h5lzf_encode_chunks(const uint8_t* in, int64_t n_chunks,
                         int chunk_bytes, int rec, uint8_t* out,
                         int64_t* sizes, uint8_t* skipped, int n_threads) {
    std::atomic<int64_t> next(0);
    auto work = [&]() {
        std::vector<uint8_t> scratch(rec > 0 ? chunk_bytes : 0);
        for (int64_t c = next++; c < n_chunks; c = next++)
            sizes[c] = encode_one(in + c * int64_t(chunk_bytes), chunk_bytes,
                                  rec, scratch.data(),
                                  out + c * int64_t(chunk_bytes),
                                  skipped + c);
    };
    int64_t n = n_threads < n_chunks ? n_threads : n_chunks;
    if (n <= 1) {
        work();
        return;
    }
    std::vector<std::thread> pool;
    for (int64_t t = 0; t < n; ++t) pool.emplace_back(work);
    for (auto& t : pool) t.join();
}

// Decode one chunk's stream in[0..n) into out (out_cap bytes): LZF unless
// skip_lzf, then unshuffle when rec > 0 (scratch holds out_cap bytes).
// Returns the decoded size, or -1 for a malformed stream.
int64_t h5lzf_decode(const uint8_t* in, int64_t n, int skip_lzf, int rec,
                     uint8_t* scratch, uint8_t* out, int64_t out_cap) {
    uint8_t* plain = rec > 0 ? scratch : out;
    int64_t size = n;
    if (skip_lzf) {
        if (n > out_cap) return -1;
        std::memcpy(plain, in, n);
    } else {
        size = lzf_decode(in, n, plain, out_cap);
        if (size < 0) return -1;
    }
    if (rec > 0) unshuffle(plain, size, rec, out);
    return size;
}

}  // extern "C"
