// One LSTM layer's forward recurrence over a precomputed input
// projection, for Hopper (sm_90a).
//
// Replaces the TPU kernel ocrd_keraslm_tpu/ops/lstm_cell.py::
// _lstm_scan_pallas_raw (forward; f32 or bf16 recurrent weights).  For
// each stream b and step t:  z = x_proj[b, t] + q(h) @ U,  gates i, f,
// g, o (sigmoid, sigmoid, tanh, sigmoid),  c = f*c + i*g,
// h = o*tanh(c).  q rounds h to bf16 (nearest even) when U is bf16 and
// is the identity when U is f32; products and sums, gates and the carry
// are f32 either way.  Writes h_all and (when asked) c_all time-major
// (T, B, W), and the final (hT, cT).
//
// What bounds it on this card: the recurrence and the weight stream.
// Step t+1 needs step t's h, so a stream's T steps run in order; the
// only parallelism in a step is across the 4W gate columns and the
// streams.  An f32 U is W x 4W x 4 bytes (256 KiB at W=128), more than
// a block's 227 KiB of shared memory, so it is read again from L2 at
// every step: at a few streams a block spends most of a step waiting on
// those reads, at 8 streams on each column's chain of W FMAs, not on
// its 2*W*4W FLOPs per stream.  The bound of the
// whole call (each input read once, each output written once, or the
// FLOPs at the card's f32 peak) is far below what one block per few
// streams can reach; the kernel is latency-bound by design in this
// first version.
//
// What the design does about it:
//  * a loop over T inside the block replaces the TPU's sequential grid;
//    streams are independent, so each block takes RB <= 8 of them and
//    the grid covers B;
//  * each thread owns one gate column of U and keeps RB accumulators in
//    registers, so one weight read feeds RB FMAs; h and c live in
//    shared memory, read as broadcast float4s;
//  * a bf16 U takes the same path as an f32 one, read from L2 at every
//    step at half the bytes; the product stays on the CUDA cores (bf16
//    values promoted to f32: exact products, f32 sums) and reads h
//    rounded to bf16, kept in a fourth shared row beside h, c and z;
//  * each dot product is summed in blocks of 32 terms (lstm_common.cuh,
//    shared with score_scan.cu and lstm_bwd.cu): one chain of W FMAs
//    drifts from the plain version over thousands of steps.
// All arithmetic is f32 on CUDA cores: no TF32, no tensor cores.

#include "lstm_common.cuh"

#define NT 512  // threads per block

template <int RB, typename WT>
__global__ void __launch_bounds__(NT, 1)
    lstm_scan_kernel(const float* __restrict__ xp, const float* h0,
                     const float* c0, const WT* __restrict__ U, float* h_all,
                     float* c_all, float* hT, float* cT, int B, int T,
                     int W) {
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x, G = 4 * W;
  float* h = reinterpret_cast<float*>(smem4);  // (RB, W)
  float* c = h + RB * W;                       // (RB, W)
  float* z = c + RB * W;                       // (RB, G)
  // the rows the product reads: h itself (f32 U) or h rounded to bf16
  float* hq = is_bf16<WT>::value ? z + RB * G : h;
  const int s0 = blockIdx.x * RB;
  const int nr = min(RB, B - s0);
  for (int i = tid; i < RB * W; i += NT) {
    const int r = i / W;
    const float hv = r < nr ? h0[(size_t)s0 * W + i] : 0.0f;
    h[i] = hv;
    c[i] = r < nr ? c0[(size_t)s0 * W + i] : 0.0f;
    if (is_bf16<WT>::value)
      hq[i] = round_bf16(hv);
  }
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    for (int j = tid; j < G; j += NT) {
      float tot[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) tot[r] = 0.0f;
      dot_cols<RB, WT>(hq, W, W, U, G, j, tot);
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
      if (is_bf16<WT>::value)
        hq[i] = round_bf16(hc.x);
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

// bytes of the rows (h, c, z and, under a bf16 U, the rounded h)
extern "C" size_t lstm_scan_smem_bytes(int B, int W, int u_bf16) {
  return (size_t)rows_per_block(B) * (2 * W + 4 * W + (u_bf16 ? W : 0)) *
         sizeof(float);
}

template <int RB, typename WT>
static int launch(const float* xp, const float* h0, const float* c0,
                  const WT* U, float* h_all, float* c_all, float* hT,
                  float* cT, int B, int T, int W, cudaStream_t stream) {
  const size_t smem = lstm_scan_smem_bytes(B, W, is_bf16<WT>::value);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_scan_kernel<RB, WT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + RB - 1) / RB;
  lstm_scan_kernel<RB, WT><<<grid, NT, smem, stream>>>(
      xp, h0, c0, U, h_all, c_all, hT, cT, B, T, W);
  return (int)cudaGetLastError();
}

// U points to W*4W floats, or to W*4W bf16 values when u_bf16 is set
extern "C" int lstm_scan_launch(const float* xp, const float* h0,
                                const float* c0, const void* U,
                                float* h_all, float* c_all, float* hT,
                                float* cT, int B, int T, int W, int u_bf16,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return dispatch_rows(B, [&](auto rb) {
    constexpr int RB = decltype(rb)::value;
    if (u_bf16)
      return launch<RB, __nv_bfloat16>(
          xp, h0, c0, static_cast<const __nv_bfloat16*>(U), h_all, c_all, hT,
          cT, B, T, W, s);
    return launch<RB, float>(xp, h0, c0, static_cast<const float*>(U), h_all,
                             c_all, hT, cT, B, T, W, s);
  });
}
