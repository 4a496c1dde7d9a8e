// Teacher-forced scoring of one chunk, for Hopper (sm_90a).
//
// Replaces the TPU kernel ocrd_keraslm_tpu/ops/score_kernel.py::
// score_scan_pallas.  For each stream b and step t, in order: layer 0
// from the streamed input projection, z = xp1[b, t] + h_0 @ rec1;
// layers d >= 1 as z = h_{d-1} @ kcat[d-1] + h_d @ ucat[d-1] + bias[d-1];
// the gates i, f, g, o of each layer; the tied-softmax logits
// h_{D-1} @ embT masked at v_real; their logsumexp; and
//   prob[b, t] = exp(logit[y] - lse) * mask,   nll = (lse - logit[y]) * mask,
// with the per-stream NLL summed over the chunk and the (D, B, W) carry
// read at the start and written at the end.
//
// What bounds it on this card: the recurrence and the weight stream.
// Step t+1 needs all of step t, so a stream's T steps run in order.  At
// W=128, D=2 the weights a step reads are rec1 (256 KiB), kcat and ucat
// (512 KiB) and embT (64 KiB at Vp=128): more than a block's 227 KiB of
// shared memory, so every step streams them from L2 again, and a block
// holding a few streams waits on those reads far more than it computes.
// The kernel is latency-bound by design in this first version.
//
// What the design does about it:
//  * a loop over T inside the block replaces the TPU's sequential grid;
//    streams are independent, so each block takes RB <= 8 of them and
//    the grid covers B;
//  * each thread owns one gate (or vocabulary) column and keeps RB
//    accumulators in registers, so one weight read feeds RB FMAs; the
//    (D, RB, W) carry lives in shared memory for the whole chunk, and
//    no h_all or logits tensor reaches device memory;
//  * the logsumexp is one warp per stream; the target logit is an index
//    load (the TPU kernel's one-hot product is gone), and each stream's
//    NLL sum is kept in double by its warp's lane 0;
//  * each dot product is summed in blocks of 32 terms (as in
//    decode_lattice.cu), so the state carried over a 4096-step chunk
//    stays within the plain version's rounding.
// All arithmetic is f32 on CUDA cores: no TF32.

#include "lstm_common.cuh"

#define NT 512  // threads per block
#define BIGF 1.0e30f
static_assert(RBMAX <= NT / 32, "one warp per stream in the logsumexp");

struct Params {
  const float* xp1;   // (B, T, G) layer-0 input projection
  const int* y;       // (B, T) targets
  const float* mask;  // (B, T)
  const float* h0;    // (D, B, W)
  const float* c0;    // (D, B, W)
  const float* rec1;  // (W, G)
  const float* kcat;  // (Dw, W, G)
  const float* ucat;  // (Dw, W, G)
  const float* bias;  // (Dw, G)
  const float* embT;  // (W, Vp)
  float* probs;       // (B, T)
  float* nll;         // (B,)
  float* hT;          // (D, B, W)
  float* cT;          // (D, B, W)
  int B, T, D, W, Vp, v_real;
};

// New (h, c) of one layer's nr rows from their gate pre-activations z
// (row stride ZW).
__device__ __forceinline__ void gates(const float* z, int ZW, int W, int nr,
                                      float* h, float* c) {
  for (int i = threadIdx.x; i < nr * W; i += NT) {
    const int r = i / W, u = i - r * W;
    const float2 hc = lstm_unit(z + r * ZW, W, u, c[i]);
    h[i] = hc.x;
    c[i] = hc.y;
  }
}

template <int RB>
__global__ void __launch_bounds__(NT, 1) score_scan_kernel(Params p) {
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int W = p.W, D = p.D, G = 4 * W, T = p.T, B = p.B;
  const int ZW = G > p.Vp ? G : p.Vp;
  float* hs = reinterpret_cast<float*>(smem4);  // (D, RB, W)
  float* cs = hs + D * RB * W;                  // (D, RB, W)
  float* z = cs + D * RB * W;                   // (RB, ZW)
  const int s0 = blockIdx.x * RB;
  const int nr = min(RB, B - s0);
  for (int i = tid; i < D * RB * W; i += NT) {
    const int d = i / (RB * W), r = (i / W) % RB, u = i % W;
    const size_t o = ((size_t)d * B + s0 + r) * W + u;
    hs[i] = r < nr ? p.h0[o] : 0.0f;
    cs[i] = r < nr ? p.c0[o] : 0.0f;
  }
  double nacc = 0.0;  // lane 0 of warp r: stream s0 + r
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    // ---- layer 0: streamed input projection + h_0 @ rec1 ----
    for (int j = tid; j < G; j += NT) {
      float tot[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) tot[r] = 0.0f;
      dot_col<RB>(hs, W, p.rec1, G, j, tot);
#pragma unroll
      for (int r = 0; r < RB; ++r)
        if (r < nr)
          z[r * ZW + j] = p.xp1[((size_t)(s0 + r) * T + t) * G + j] + tot[r];
    }
    __syncthreads();
    gates(z, ZW, W, nr, hs, cs);
    __syncthreads();

    // ---- layers 1..D-1: h_{d-1} @ kcat + h_d @ ucat + bias ----
    for (int d = 1; d < D; ++d) {
      const float* hin = hs + (d - 1) * RB * W;
      float* hd = hs + d * RB * W;
      const float* kc = p.kcat + (size_t)(d - 1) * W * G;
      const float* uc = p.ucat + (size_t)(d - 1) * W * G;
      for (int j = tid; j < G; j += NT) {
        float ta[RB], tb[RB];
#pragma unroll
        for (int r = 0; r < RB; ++r) ta[r] = tb[r] = 0.0f;
        dot_col<RB>(hin, W, kc, G, j, ta);
        dot_col<RB>(hd, W, uc, G, j, tb);
        const float bj = __ldg(p.bias + (size_t)(d - 1) * G + j);
#pragma unroll
        for (int r = 0; r < RB; ++r)
          if (r < nr) z[r * ZW + j] = (ta[r] + tb[r]) + bj;
      }
      __syncthreads();
      gates(z, ZW, W, nr, hd, cs + d * RB * W);
      __syncthreads();
    }

    // ---- tied softmax: logits, logsumexp, target prob and NLL ----
    // only the v_real real columns: the padding never reaches the sums
    const float* htop = hs + (D - 1) * RB * W;
    for (int v = tid; v < p.v_real; v += NT) {
      float tot[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) tot[r] = 0.0f;
      dot_col<RB>(htop, W, p.embT, p.Vp, v, tot);
#pragma unroll
      for (int r = 0; r < RB; ++r)
        if (r < nr) z[r * ZW + v] = tot[r];
    }
    __syncthreads();
    if (warp < nr) {
      const float* lg = z + warp * ZW;
      float mx = -BIGF;
      for (int v = lane; v < p.v_real; v += 32) mx = fmaxf(mx, lg[v]);
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      float sum = 0.0f;
      for (int v = lane; v < p.v_real; v += 32) sum += expf(lg[v] - mx);
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const size_t o = (size_t)(s0 + warp) * T + t;
        const float lse = mx + logf(sum);
        const int yv = p.y[o];
        const float tgt = yv < p.v_real ? lg[yv] : -BIGF;
        const float m = p.mask[o];
        p.probs[o] = expf(tgt - lse) * m;
        nacc += (double)((lse - tgt) * m);
      }
    }
    __syncthreads();  // z is rewritten by the next step's layer 0
  }

  for (int i = tid; i < D * RB * W; i += NT) {
    const int d = i / (RB * W), r = (i / W) % RB, u = i % W;
    if (r < nr) {
      const size_t o = ((size_t)d * B + s0 + r) * W + u;
      p.hT[o] = hs[i];
      p.cT[o] = cs[i];
    }
  }
  if (warp < nr && lane == 0) p.nll[s0 + warp] = (float)nacc;
}

extern "C" size_t score_scan_smem_bytes(int B, int D, int W, int Vp) {
  const int rb = rows_per_block(B);
  const int ZW = 4 * W > Vp ? 4 * W : Vp;
  return ((size_t)2 * D * rb * W + (size_t)rb * ZW) * sizeof(float);
}

template <int RB>
static int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = score_scan_smem_bytes(p.B, p.D, p.W, p.Vp);
  cudaError_t err = cudaFuncSetAttribute(
      score_scan_kernel<RB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  score_scan_kernel<RB><<<(p.B + RB - 1) / RB, NT, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int score_scan_launch(
    const float* xp1, const int* y, const float* mask, const float* h0,
    const float* c0, const float* rec1, const float* kcat,
    const float* ucat, const float* bias, const float* embT, float* probs,
    float* nll, float* hT, float* cT, int B, int T, int D, int W, int Vp,
    int v_real, void* stream) {
  Params p{xp1, y,  mask, h0, c0, rec1, kcat, ucat, bias, embT, probs,
           nll, hT, cT,   B,  T,  D,    W,    Vp,   v_real};
  cudaStream_t s = (cudaStream_t)stream;
  return dispatch_rows(
      B, [&](auto rb) { return launch<decltype(rb)::value>(p, s); });
}
