// Light-truth record emitter of the host truth route, with a plain C
// interface (bound with ctypes by larndsim_tpu_torch/models/light.py).
//
// The numpy emitter (models/light._emit_truth_plain) makes a transpose, a
// nonzero and six strided field writes per channel.  Here one pass counts
// the records, and one more writes them, whole 32-byte records in order:
// each channel's (rows, S) block of values is small enough to stay in
// cache while its records are written.
//
// A record is io/export.TRUTH_DTYPE, packed, 32 bytes:
//   [0]  int32  trigger_id
//   [4]  int32  op_channel_id
//   [8]  int32  tick
//   [12] int32  event_id
//   [16] int64  segment_id
//   [24] double pe_current   (the float32 value, widened)
//
// The records come in the numpy emitter's order: channel, then tick, then
// contributor row.  A value is kept where |v| > threshold in float32: the
// numpy emitter compares a float32 array with a Python float, which numpy
// casts to float32.
#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// Records of the (n_rows, S) float32 values res: |v| > (float)threshold.
int64_t truth_count(const float* res, int64_t n_rows, int64_t S,
                    double threshold) {
    const float thr = (float)threshold;
    const int64_t total = n_rows * S;
    int64_t n = 0;
    for (int64_t i = 0; i < total; ++i) n += std::fabs(res[i]) > thr;
    return n;
}

// Writes truth_count(...) records into out.  Channel c owns the rows
// [c_starts[c], c_starts[c + 1]) of res; row r is contributor rows_k[r]
// of its channel, whose segment id is ids[c * K + rows_k[r]].
void truth_emit(const float* res, const int32_t* rows_k,
                const int64_t* c_starts, const int32_t* op_channel,
                const int64_t* ids, int64_t C, int64_t K, int64_t S,
                double threshold, int32_t event_id, int32_t trigger_id,
                char* out) {
    const float thr = (float)threshold;
    char* p = out;
    for (int64_t c = 0; c < C; ++c) {
        const int64_t r0 = c_starts[c], r1 = c_starts[c + 1];
        const int32_t oc = op_channel[c];
        const int64_t* ids_c = ids + c * K;
        for (int64_t s = 0; s < S; ++s) {
            for (int64_t r = r0; r < r1; ++r) {
                const float v = res[r * S + s];
                if (!(std::fabs(v) > thr)) continue;
                const int32_t head[4] = {trigger_id, oc, (int32_t)s,
                                         event_id};
                const int64_t seg = ids_c[rows_k[r]];
                const double pe = (double)v;
                std::memcpy(p, head, 16);
                std::memcpy(p + 16, &seg, 8);
                std::memcpy(p + 24, &pe, 8);
                p += 32;
            }
        }
    }
}

}  // extern "C"
