// Native batch builder for the parallel-streams stateful training
// layout (data.gen_stateful_streams; the per-window Python generator
// loop of the reference tool's rating.py).
//
// Given a vocab-encoded id sequence, cuts it into `batch` contiguous
// streams advancing in lockstep and emits all (x, y, mask) windows in
// one pass.  Compiled on first use by ocrd_keraslm_torch/native.py
// (g++ -O3 -shared) and called through ctypes; the exact NumPy path
// (data._stream_windows_numpy) is the lane for KERASLM_NATIVE=0.

#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// Returns the number of windows written (<= max_windows).
// x, y: [max_windows][batch][length] int32; mask: same shape float32.
// B_used receives the number of active streams.
int64_t build_stream_batches(const int32_t* ids, int64_t n,
                             int64_t batch, int64_t length,
                             int32_t* x, int32_t* y, float* mask,
                             int64_t max_windows, int64_t* B_used) {
    if (n < 2 || batch < 1 || length < 1) {
        *B_used = 0;
        return 0;
    }
    int64_t B = std::min<int64_t>(
        batch, std::max<int64_t>((n - 1) / (length + 1), 1));
    int64_t stream_len = (n - 1) / B;
    // the LAST stream absorbs the tiling remainder (n-1) % B — plain
    // equal tiling silently dropped up to B-1 trailing chars of every
    // file from training
    int64_t last_len = (n - 1) - (B - 1) * stream_len;
    // CEIL: the masked final partial window must be included
    int64_t n_windows = std::max<int64_t>(
        (last_len + length - 1) / length, 1);
    n_windows = std::min(n_windows, max_windows);
    *B_used = B;

    const int64_t plane = batch * length;
    for (int64_t w = 0; w < n_windows; ++w) {
        int32_t* xw = x + w * plane;
        int32_t* yw = y + w * plane;
        float* mw = mask + w * plane;
        std::memset(xw, 0, sizeof(int32_t) * plane);
        std::memset(yw, 0, sizeof(int32_t) * plane);
        std::memset(mw, 0, sizeof(float) * plane);
        for (int64_t b = 0; b < B; ++b) {
            int64_t end = (b == B - 1) ? (n - 1)
                                       : (b + 1) * stream_len;
            int64_t lo = b * stream_len + w * length;
            int64_t hi = std::min(lo + length, end);
            if (hi <= lo)
                continue;
            int64_t cnt = hi - lo;
            std::memcpy(xw + b * length, ids + lo,
                        sizeof(int32_t) * cnt);
            std::memcpy(yw + b * length, ids + lo + 1,
                        sizeof(int32_t) * cnt);
            for (int64_t t = 0; t < cnt; ++t)
                mw[b * length + t] = 1.0f;
        }
    }
    return n_windows;
}

}  // extern "C"
