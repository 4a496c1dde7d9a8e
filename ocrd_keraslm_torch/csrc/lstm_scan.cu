// One LSTM layer's forward recurrence over a precomputed input
// projection, for Hopper (sm_90a).
//
// Replaces the TPU kernel ocrd_keraslm_tpu/ops/lstm_cell.py::
// _lstm_scan_pallas_raw (forward only, f32 weights).  For each stream b
// and step t:  z = x_proj[b, t] + h @ U,  gates i, f, g, o (sigmoid,
// sigmoid, tanh, sigmoid),  c = f*c + i*g,  h = o*tanh(c).  Writes
// h_all and (when asked) c_all time-major (T, B, W), and the final
// (hT, cT).
//
// What bounds it on this card: the recurrence and the weight stream.
// Step t+1 needs step t's h, so a stream's T steps run in order; the
// only parallelism in a step is across the 4W gate columns and the
// streams.  U is W x 4W f32 (256 KiB at W=128), more than a block's
// 227 KiB of shared memory, so it is read again from L2 at every step:
// at a few streams a block spends most of a step waiting on those
// reads, not on its 2*W*4W FLOPs per stream.  The bound of the whole
// call (each input read once, each output written once, or the FLOPs at
// the card's f32 peak) is far below what one block per few streams can
// reach; the kernel is latency-bound by design in this first version.
//
// What the design does about it:
//  * a loop over T inside the block replaces the TPU's sequential grid;
//    streams are independent, so each block takes RB <= 8 of them and
//    the grid covers B;
//  * each thread owns one gate column of U and keeps RB accumulators in
//    registers, so one weight read from L2 feeds RB FMAs; h and c live
//    in shared memory, read as broadcast float4s;
//  * each dot product is summed in blocks of 32 terms (lstm_common.cuh,
//    shared with score_scan.cu): one chain of W FMAs drifts from the
//    plain version over thousands of steps.
// All arithmetic is f32 on CUDA cores: no TF32.

#include "lstm_common.cuh"

#define NT 512  // threads per block

template <int RB>
__global__ void __launch_bounds__(NT, 1)
    lstm_scan_kernel(const float* __restrict__ xp, const float* h0,
                     const float* c0, const float* __restrict__ U,
                     float* h_all, float* c_all, float* hT, float* cT,
                     int B, int T, int W) {
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x, G = 4 * W;
  float* h = reinterpret_cast<float*>(smem4);  // (RB, W)
  float* c = h + RB * W;                       // (RB, W)
  float* z = c + RB * W;                       // (RB, G)
  const int s0 = blockIdx.x * RB;
  const int nr = min(RB, B - s0);
  for (int i = tid; i < RB * W; i += NT) {
    const int r = i / W;
    h[i] = r < nr ? h0[(size_t)s0 * W + i] : 0.0f;
    c[i] = r < nr ? c0[(size_t)s0 * W + i] : 0.0f;
  }
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    for (int j = tid; j < G; j += NT) {
      float tot[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) tot[r] = 0.0f;
      dot_col<RB>(h, W, U, G, j, tot);
#pragma unroll
      for (int r = 0; r < RB; ++r)
        if (r < nr)
          z[r * G + j] = xp[((size_t)(s0 + r) * T + t) * G + j] + tot[r];
    }
    __syncthreads();
    for (int i = tid; i < nr * W; i += NT) {
      const int r = i / W, u = i - r * W;
      const float2 hc = lstm_unit(z + r * G, W, u, c[i]);
      h[i] = hc.x;
      c[i] = hc.y;
      const size_t o = ((size_t)t * B + s0) * W + i;
      h_all[o] = hc.x;
      if (c_all != nullptr) c_all[o] = hc.y;
    }
    __syncthreads();
  }
  for (int i = tid; i < nr * W; i += NT) {
    hT[(size_t)s0 * W + i] = h[i];
    cT[(size_t)s0 * W + i] = c[i];
  }
}

extern "C" size_t lstm_scan_smem_bytes(int B, int W) {
  const int rb = rows_per_block(B);
  return (size_t)rb * (2 * W + 4 * W) * sizeof(float);
}

template <int RB>
static int launch(const float* xp, const float* h0, const float* c0,
                  const float* U, float* h_all, float* c_all, float* hT,
                  float* cT, int B, int T, int W, cudaStream_t stream) {
  const size_t smem = lstm_scan_smem_bytes(B, W);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_scan_kernel<RB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + RB - 1) / RB;
  lstm_scan_kernel<RB><<<grid, NT, smem, stream>>>(xp, h0, c0, U, h_all,
                                                   c_all, hT, cT, B, T, W);
  return (int)cudaGetLastError();
}

extern "C" int lstm_scan_launch(const float* xp, const float* h0,
                                const float* c0, const float* U,
                                float* h_all, float* c_all, float* hT,
                                float* cT, int B, int T, int W,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return dispatch_rows(B, [&](auto rb) {
    return launch<decltype(rb)::value>(xp, h0, c0, U, h_all, c_all, hT, cT,
                                       B, T, W, s);
  });
}
