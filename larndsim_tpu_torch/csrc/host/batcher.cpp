// Batch assigner of the port's batch planner, with a plain C interface
// (bound with ctypes by larndsim_tpu_torch/utils/batching.py).
//
// Each segment goes to the first TPC group (tpc_batch_size TPCs a group,
// in TPC order) whose sorted bounding box holds its start or its end point
// strictly inside, or to -1: one pass over the segments, in place of one
// masking pass over all of them per TPC (utils/batching.
// assign_groups_plain).  A TPC's group index never falls as the TPC index
// rises, so the first TPC that holds a point gives the segment's group.
//
// The coordinates come as float64: the planner's float32 fields widen
// exactly, and the comparisons against the float64 borders are then those
// of numpy's, which compares a float32 array with a float64 scalar in
// float64.
#include <cstdint>

extern "C" {

// xyz: six arrays of n (x, y, z of the start points, then of the end
// points); borders: (n_tpc, 3, 2), each pair sorted; out: (n,) group.
void assign_batches(int64_t n, int64_t n_tpc, const double* xs,
                    const double* ys, const double* zs, const double* xe,
                    const double* ye, const double* ze,
                    const double* borders, int64_t tpc_batch_size,
                    int32_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        int32_t group = -1;
        for (int64_t t = 0; t < n_tpc; ++t) {
            const double* b = borders + t * 6;
            const bool in_start = xs[i] > b[0] && xs[i] < b[1] &&
                                  ys[i] > b[2] && ys[i] < b[3] &&
                                  zs[i] > b[4] && zs[i] < b[5];
            const bool in_end = xe[i] > b[0] && xe[i] < b[1] &&
                                ye[i] > b[2] && ye[i] < b[3] &&
                                ze[i] > b[4] && ze[i] < b[5];
            if (in_start || in_end) {
                group = (int32_t)(t / tpc_batch_size);
                break;
            }
        }
        out[i] = group;
    }
}

}  // extern "C"
