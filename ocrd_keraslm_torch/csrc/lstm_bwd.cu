// One LSTM layer's backward recurrence (reverse time), for Hopper
// (sm_90a).
//
// Replaces the TPU kernel ocrd_keraslm_tpu/ops/lstm_cell.py::
// _lstm_bwd_pallas (body _lstm_bwd_kernel), the backward of
// _lstm_scan_pallas_raw.  All sequences are time-major (T, B, .) f32.
// For t = T-1 .. 0 and each stream b it recomputes the forward step's
// gates from the saved states,
//   z = x_proj[t] + q(h_prev[t]) @ U,   i, f, g, o = gates(z),
// (q rounds to bf16 when U is bf16, as the forward does, so the gates
// are the forward's), then
//   dh_tot = dh_out[t] + dh,            tc = tanh(c_cur[t]),
//   dc_tot = dc + dh_tot * o * (1 - tc^2),
//   dz = [dc_tot*g * i(1-i), dc_tot*c_prev[t] * f(1-f),
//         dc_tot*i * (1-g^2), dh_tot*tc * o(1-o)]      -> dx_proj[t],
//   dh = dz @ U^T  (recT, the weight's values as f32),  dc = dc_tot * f,
// and returns dh0, dc0 = (dh, dc) after t = 0 and
//   dU = sum over t and b of q(h_prev[t, b])^T dz[t, b].
//
// What bounds it on this card.  The chain (dh, dc) runs through all T
// steps of a stream in order, two products per step (W x 4W and
// 4W x W per stream), whose weights (256 KiB each in f32 at W=128)
// exceed a block's shared memory and stream from L2 every step: like
// the forward, the sequential kernel is bound by latency, not by the
// call's bytes or FLOPs.  dU is another matter: it is W x 4W f32 =
// 256 KiB, more than a block's shared memory and all of an SM's
// registers, so it cannot ride through the time loop as the TPU
// kernel's VMEM accumulator does; and the TPU grid ran the batch
// blocks one after another into that one accumulator, where blocks
// here run in parallel.
//
// What the design does about it:
//  * dU is not part of the recurrence: step t-1 reads nothing of it.
//    The sequential kernel (lstm_bwd_kernel: one block per RB <= 8
//    streams, a loop over T inside) computes only z, the gate
//    derivatives, dz and the (dh, dc) chain, and writes dz out (it is
//    dx_proj anyway);
//  * dU = q(h_prev)^T dz is then one product of (W, T*B) by (T*B, 4W)
//    over arrays in device memory, which all SMs share: lstm_du_partial
//    tiles it 64 x 64 and splits the T*B rows over blockIdx.z into
//    per-split partial sums in a scratch tensor, and lstm_du_reduce
//    adds the splits in a fixed order.  No float atomics: dU is the
//    same from run to run;
//  * every sum follows lstm_common.cuh's rule (blocks of 32 terms), and
//    the elementwise updates round each product and sum apart
//    (__fmul_rn, __fadd_rn), as the plain version does;
//  * a bf16 U is read as bf16 (half the bytes) and promoted exactly;
//    recT arrives as f32 as in the TPU kernel.
// All arithmetic is f32 on CUDA cores: no TF32, no tensor cores.

#include "lstm_common.cuh"

#define NT 512    // threads of the sequential kernel
#define TI 64     // dU tile: rows (units of h)
#define TJ 64     // dU tile: columns (gate columns)
#define DT 256    // threads of the dU kernels
#define SPLIT_ROWS 1024  // rows of T*B per split of the dU product
#define SPLIT_MAX 64

template <int RB, typename WT>
__global__ void __launch_bounds__(NT, 1)
    lstm_bwd_kernel(const float* __restrict__ xp,
                    const float* __restrict__ hprev,
                    const float* __restrict__ cprev,
                    const float* __restrict__ ccur,
                    const float* __restrict__ dhout,
                    const WT* __restrict__ U, const float* __restrict__ recT,
                    const float* dhT, const float* dcT, float* dxp,
                    float* dh0, float* dc0, int B, int T, int W) {
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x, G = 4 * W;
  float* hq = reinterpret_cast<float*>(smem4);  // (RB, W)
  float* dh = hq + RB * W;                      // (RB, W)
  float* dc = dh + RB * W;                      // (RB, W)
  float* z = dc + RB * W;                       // (RB, G)
  float* dz = z + RB * G;                       // (RB, G)
  float* part = dz + RB * G;                    // (4, RB, W)
  const int s0 = blockIdx.x * RB;
  const int nr = min(RB, B - s0);
  for (int i = tid; i < RB * W; i += NT) {
    const int r = i / W;
    hq[i] = 0.0f;
    dh[i] = r < nr ? dhT[(size_t)s0 * W + i] : 0.0f;
    dc[i] = r < nr ? dcT[(size_t)s0 * W + i] : 0.0f;
  }
  for (int i = tid; i < RB * G; i += NT) dz[i] = 0.0f;
  __syncthreads();
  for (int t = T - 1; t >= 0; --t) {
    const size_t row0 = (size_t)t * B + s0;
    for (int i = tid; i < nr * W; i += NT) {
      const float hv = hprev[row0 * W + i];
      hq[i] = is_bf16<WT>::value ? round_bf16(hv) : hv;
    }
    __syncthreads();
    // z as the forward computed it
    for (int j = tid; j < G; j += NT) {
      float tot[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) tot[r] = 0.0f;
      dot_cols<RB, WT>(hq, W, W, U, G, j, tot);
#pragma unroll
      for (int r = 0; r < RB; ++r)
        if (r < nr) z[r * G + j] = xp[(row0 + r) * G + j] + tot[r];
    }
    __syncthreads();
    // gate derivatives; dz to shared memory and to dx_proj
    for (int i = tid; i < nr * W; i += NT) {
      const int r = i / W, u = i - r * W;
      const float* zr = z + r * G;
      const float ig = sigm(zr[u]);
      const float fg = sigm(zr[W + u]);
      const float gg = tanhf(zr[2 * W + u]);
      const float og = sigm(zr[3 * W + u]);
      const float cp = cprev[row0 * W + i];
      const float tc = tanhf(ccur[row0 * W + i]);
      const float dht = __fadd_rn(dhout[row0 * W + i], dh[i]);
      const float d_o = __fmul_rn(dht, tc);
      const float dct = __fadd_rn(
          dc[i], __fmul_rn(__fmul_rn(dht, og),
                           __fsub_rn(1.0f, __fmul_rn(tc, tc))));
      const float d_i = __fmul_rn(dct, gg);
      const float d_f = __fmul_rn(dct, cp);
      const float d_g = __fmul_rn(dct, ig);
      const float zi = __fmul_rn(__fmul_rn(d_i, ig), __fsub_rn(1.0f, ig));
      const float zf = __fmul_rn(__fmul_rn(d_f, fg), __fsub_rn(1.0f, fg));
      const float zg = __fmul_rn(d_g, __fsub_rn(1.0f, __fmul_rn(gg, gg)));
      const float zo = __fmul_rn(__fmul_rn(d_o, og), __fsub_rn(1.0f, og));
      float* dzr = dz + r * G;
      dzr[u] = zi;
      dzr[W + u] = zf;
      dzr[2 * W + u] = zg;
      dzr[3 * W + u] = zo;
      float* out = dxp + (row0 + r) * G;
      out[u] = zi;
      out[W + u] = zf;
      out[2 * W + u] = zg;
      out[3 * W + u] = zo;
      dc[i] = __fmul_rn(dct, fg);
    }
    __syncthreads();
    // dh = dz @ recT: each thread sums one gate block's W terms of one
    // output column for all RB rows, then the four blocks are added
    for (int idx = tid; idx < 4 * W; idx += NT) {
      const int q = idx / W, u = idx - q * W;
      float tot[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) tot[r] = 0.0f;
      dot_cols<RB, float>(dz + q * W, G, W, recT + (size_t)q * W * W, W, u,
                          tot);
#pragma unroll
      for (int r = 0; r < RB; ++r) part[(q * RB + r) * W + u] = tot[r];
    }
    __syncthreads();
    for (int i = tid; i < nr * W; i += NT) {
      const int r = i / W, u = i - r * W;
      const float* p = part + r * W + u;
      dh[i] = __fadd_rn(
          __fadd_rn(__fadd_rn(p[0], p[RB * W]), p[2 * RB * W]),
          p[3 * RB * W]);
    }
    // dh[i] is read again by the thread that wrote it; the next step's
    // barriers order everything else
  }
  __syncthreads();
  for (int i = tid; i < nr * W; i += NT) {
    dh0[(size_t)s0 * W + i] = dh[i];
    dc0[(size_t)s0 * W + i] = dc[i];
  }
}

// part[s] = A[n0:n1]^T @ Dz[n0:n1] for split s of the N = T*B rows:
// A = hprev (N, W), rounded to bf16 when QUANT, Dz (N, G).  One block
// per (64 x 64 tile of dU, split); each thread a 4 x 4 patch; 32 rows
// at a time through shared memory, each 32 summed apart.
template <bool QUANT>
__global__ void __launch_bounds__(DT)
    lstm_du_partial(const float* __restrict__ A, const float* __restrict__ Dz,
                    float* part, int N, int W, int G, int split_rows) {
  __shared__ __align__(16) float As[KCH][TI];
  __shared__ __align__(16) float Bs[KCH][TJ];
  const int tid = threadIdx.x;
  const int i0 = blockIdx.x * TI, j0 = blockIdx.y * TJ;
  const int n0 = blockIdx.z * split_rows;
  const int n1 = min(N, n0 + split_rows);
  const int ty = tid / 16, tx = tid % 16;
  float tot[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) tot[a][b] = 0.0f;
  for (int n = n0; n < n1; n += KCH) {
    for (int e = tid; e < KCH * TI; e += DT) {
      const int k = e / TI, i = e - k * TI;
      float v = 0.0f;
      if (n + k < n1 && i0 + i < W) v = A[(size_t)(n + k) * W + i0 + i];
      As[k][i] = QUANT ? round_bf16(v) : v;
    }
    for (int e = tid; e < KCH * TJ; e += DT) {
      const int k = e / TJ, j = e - k * TJ;
      float v = 0.0f;
      if (n + k < n1 && j0 + j < G) v = Dz[(size_t)(n + k) * G + j0 + j];
      Bs[k][j] = v;
    }
    __syncthreads();
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;
#pragma unroll 8
    for (int k = 0; k < KCH; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float a4[4] = {av.x, av.y, av.z, av.w};
      const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(a4[a], b4[b], acc[a][b]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) tot[a][b] += acc[a][b];
    __syncthreads();
  }
  float* out = part + (size_t)blockIdx.z * W * G;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty * 4 + a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = j0 + tx * 4 + b;
      if (i < W && j < G) out[(size_t)i * G + j] = tot[a][b];
    }
  }
}

// dU = part[0] + part[1] + ... in that order
__global__ void __launch_bounds__(DT)
    lstm_du_reduce(const float* __restrict__ part, float* dU, int n,
                   int splits) {
  const int idx = blockIdx.x * DT + threadIdx.x;
  if (idx >= n) return;
  float s = part[idx];
  for (int k = 1; k < splits; ++k) s = __fadd_rn(s, part[(size_t)k * n + idx]);
  dU[idx] = s;
}

// splits of the T*B rows of the dU product (the scratch tensor holds
// this many (W, 4W) partial sums)
extern "C" int lstm_bwd_splits(int B, int T) {
  const long n = (long)B * T;
  long s = (n + SPLIT_ROWS - 1) / SPLIT_ROWS;
  if (s < 1) s = 1;
  if (s > SPLIT_MAX) s = SPLIT_MAX;
  return (int)s;
}

extern "C" size_t lstm_bwd_smem_bytes(int B, int W) {
  const int rb = rows_per_block(B);
  return (size_t)rb * (3 * W + 2 * 4 * W + 4 * W) * sizeof(float);
}

template <int RB, typename WT>
static int launch(const float* xp, const float* hprev, const float* cprev,
                  const float* ccur, const float* dhout, const WT* U,
                  const float* recT, const float* dhT, const float* dcT,
                  float* dxp, float* dU, float* dh0, float* dc0, float* part,
                  int B, int T, int W, cudaStream_t stream) {
  const size_t smem = lstm_bwd_smem_bytes(B, W);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_bwd_kernel<RB, WT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  lstm_bwd_kernel<RB, WT><<<(B + RB - 1) / RB, NT, smem, stream>>>(
      xp, hprev, cprev, ccur, dhout, U, recT, dhT, dcT, dxp, dh0, dc0, B, T,
      W);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int G = 4 * W, N = B * T;
  const int splits = lstm_bwd_splits(B, T);
  const int split_rows = (N + splits - 1) / splits;
  // a split's rows are whole blocks of 32, so that the sums do not
  // depend on where the splits fall
  const int rows = (split_rows + KCH - 1) / KCH * KCH;
  const dim3 grid((W + TI - 1) / TI, (G + TJ - 1) / TJ, splits);
  lstm_du_partial<is_bf16<WT>::value><<<grid, DT, 0, stream>>>(
      hprev, dxp, part, N, W, G, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lstm_du_reduce<<<(W * G + DT - 1) / DT, DT, 0, stream>>>(part, dU, W * G,
                                                           splits);
  return (int)cudaGetLastError();
}

// U points to W*4W floats, or to W*4W bf16 values when u_bf16 is set;
// part is scratch of lstm_bwd_splits(B, T) * W * 4W floats
extern "C" int lstm_bwd_launch(const float* xp, const float* hprev,
                               const float* cprev, const float* ccur,
                               const float* dhout, const void* U,
                               const float* recT, const float* dhT,
                               const float* dcT, float* dxp, float* dU,
                               float* dh0, float* dc0, float* part, int B,
                               int T, int W, int u_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return dispatch_rows(B, [&](auto rb) {
    constexpr int RB = decltype(rb)::value;
    if (u_bf16)
      return launch<RB, __nv_bfloat16>(
          xp, hprev, cprev, ccur, dhout,
          static_cast<const __nv_bfloat16*>(U), recT, dhT, dcT, dxp, dU, dh0,
          dc0, part, B, T, W, s);
    return launch<RB, float>(xp, hprev, cprev, ccur, dhout,
                             static_cast<const float*>(U), recT, dhT, dcT,
                             dxp, dU, dh0, dc0, part, B, T, W, s);
  });
}
