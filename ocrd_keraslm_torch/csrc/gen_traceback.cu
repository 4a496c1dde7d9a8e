// Backpointer walk of the generation records for Hopper (sm_90a).
//
// Replaces the TPU kernel ocrd_keraslm_tpu/ops/gen_kernel.py::
// _traceback_pallas (_make_tb_kernel): from each cursor's end slot at
// step out_length - 1 (a run-time argument), walk the (char, backptr)
// records (N, T, 3, K) back to step 0 and write the chars in forward
// order, 0 at steps >= out_length.
//
// What bounds it on this card: latency.  Each step's backpointer load
// depends on the previous one, so a cursor is a chain of T dependent
// loads from L2 (the records were just written by the beam-step kernel);
// the bytes it needs (two floats a step and cursor) are nothing.
//
// What the design does about it: one thread per cursor, one block per
// stream, every cursor in one launch (the TPU kernel chunks its cursors
// to fit its scalar memory; there is no such limit here), and the char
// load issued beside the backpointer load, so a step costs one round
// trip.

#include <cuda_runtime.h>

__global__ void gen_traceback_kernel(const float* __restrict__ rec,
                                     const int* __restrict__ best,
                                     int* __restrict__ out, int T, int K,
                                     int VARS, int out_length) {
  const int n = blockIdx.x;
  const float* rn = rec + (size_t)n * T * 3 * K;
  for (int v = threadIdx.x; v < VARS; v += blockDim.x) {
    int* o = out + ((size_t)n * VARS + v) * T;
    for (int t = out_length; t < T; ++t) o[t] = 0;
    int k = best[(size_t)n * VARS + v];
    for (int t = out_length - 1; t >= 0; --t) {
      const float* r = rn + (size_t)t * 3 * K;
      k = min(max(k, 0), K - 1);
      const float ch = r[k];
      k = (int)r[K + k];
      o[t] = (int)ch;
    }
  }
}

extern "C" int gen_traceback_launch(const float* rec, const int* best,
                                    int* out, int N, int T, int K, int VARS,
                                    int out_length, void* stream) {
  if (N < 1 || VARS < 1 || out_length < 1 || out_length > T)
    return (int)cudaErrorInvalidValue;
  const int threads = VARS < 1024 ? (VARS + 31) / 32 * 32 : 1024;
  gen_traceback_kernel<<<N, threads, 0, (cudaStream_t)stream>>>(
      rec, best, out, T, K, VARS, out_length);
  return (int)cudaGetLastError();
}
