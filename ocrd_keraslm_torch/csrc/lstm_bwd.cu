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
// steps of a stream in order.  Its one product a step, dh = dz @ U^T
// (4W x W per stream), is far too small for the card: a step's time is
// the latency of its dependent chain (dz to every unit's four W-term
// sums, the gate derivatives, the new dz to every block), not bytes or
// FLOPs.  The z recompute is off the chain: every h_prev[t] is a saved
// forward state, so z for all T*B rows is one product, like dU.
//
// What the design does about it:
//  * lstm_bwd_z computes z = x_proj + q(h_prev) @ U for all T*B rows in
//    one tiled product that all SMs share (128 x 128 tiles, 8 x 8
//    outputs a thread), into dx_proj, before the chain of every layout
//    (the chain reads z there and overwrites it with dz), each sum in
//    dot_cols' order (a fresh 32-FMA chain a block of 32 terms, the
//    blocks added to 0 in order, then x_proj +): z is the forward's z,
//    bit for bit;
//  * the chain runs in the register layout of scan_common.cuh
//    (lstm_bwd_reg_kernel, where a column has 2, 4 or 8 blocks of 32
//    terms): a thread-block cluster of CL blocks per group of RB
//    streams; block k owns W/CL units; for each owned unit u, lane
//    (quarter pair, block kb) keeps the 32 weights U[u, qW + 32kb ..] of
//    two quarters q of U^T in registers for the whole launch; lane kb=0
//    adds each quarter's block sums in order (shuffles) and the four
//    quarters are added in q order, ((p0 + p1) + p2) + p3: the one-block
//    kernel's float.  The owner of unit u computes dz[u], dz[W+u],
//    dz[2W+u], dz[3W+u] from its dh[u], dc[u] (which never leaves the
//    lane), the precomputed z and the saved states of its stream, whose
//    loads are issued a step ahead, writes them to dx_proj and sends them
//    by st.async into every block of the cluster, completing on the
//    receiver's mbarrier: 4 floats per unit and stream a step, and no
//    block or cluster barrier in the T loop;
//  * at W = 512 (16 blocks of 32 terms a column, too many lanes for a
//    unit's group in a cluster's block) the chain runs in the grid
//    layout of scan_common.cuh (lstm_bwd_grid_kernel): groups of rb
//    streams on W/16 blocks each, one block an SM, every group resident
//    at once (a cooperative launch); a block keeps U^T's 2048 x 16
//    columns of its 16 units in registers (128 weights a thread), the
//    group's dz rows of a step cross its blocks through device memory
//    (dx_proj itself, behind the group's counter) and are staged in
//    chunks into shared memory, where each thread's 32-term chains
//    leave partial sums that one thread a (stream, unit) adds in block
//    and quarter order: the one-block kernel's float.  Each step moves
//    the group's dz rows from L2 once a block (32 MiB at B=128) instead
//    of U^T and U from L2 once a block and step (256 MiB);
//  * at W > 512 the chain runs in the wide layout of wide_common.cuh
//    (lstm_bwd_wide_kernel, at the end of this file): every step the
//    quarters' sums of dh over the whole card, then the gate
//    derivatives, each phase ended by one counter over all blocks; its
//    z and dU products are the kernels below under lstm_bwd_wide_*
//    names;
//  * other widths, and batches whose clusters would run in many waves
//    (ops/scan_layout.py chooses), run the first port's one-block
//    kernel, lstm_bwd_kernel: one block per RB <= 8 streams, the z of
//    lstm_bwd_z and dh from U^T read from L2 at every step;
//  * dU is not part of the recurrence: step t-1 reads nothing of it.
//    dU = q(h_prev)^T dz is one product of (W, T*B) by (T*B, 4W) over
//    arrays in device memory, which all SMs share: lstm_du_partial tiles
//    it 128 x 128 and splits the T*B rows over blockIdx.z into per-split
//    partial sums in a scratch tensor, and lstm_du_reduce adds the
//    splits in a fixed order.  No float atomics: dU is the same from run
//    to run (dU cannot ride through the time loop as the TPU kernel's
//    VMEM accumulator does: W x 4W f32 = 256 KiB exceeds a block's
//    shared memory and an SM's registers);
//  * every sum follows lstm_common.cuh's rule (blocks of 32 terms), and
//    the elementwise updates round each product and sum apart
//    (__fmul_rn, __fadd_rn), as the plain version does;
//  * a bf16 U is read as bf16 (half the bytes) and promoted exactly;
//    recT arrives as f32 as in the TPU kernel.
// Every layout gives the same bits.  All arithmetic is f32 on CUDA
// cores: no TF32, no tensor cores.

#include "scan_common.cuh"
#include "wide_common.cuh"

#define NT 512    // threads of the sequential kernel
#define DT 256    // threads of the dU reduction
#define SPLIT_ROWS 1024  // rows of T*B per split of the dU product
#define SPLIT_MAX 64

template <int RB>
__global__ void __launch_bounds__(NT, 1)
    lstm_bwd_kernel(const float* __restrict__ cprev,
                    const float* __restrict__ ccur,
                    const float* __restrict__ dhout,
                    const float* __restrict__ recT, const float* dhT,
                    const float* dcT, float* dxp, float* dh0, float* dc0,
                    int B, int T, int W) {
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x, G = 4 * W;
  // (RB, W) unused: the first port's plan kept, whose h row the z
  // recompute read before z moved into lstm_bwd_z
  float* dh = reinterpret_cast<float*>(smem4) + RB * W;  // (RB, W)
  float* dc = dh + RB * W;                      // (RB, W)
  float* z = dc + RB * W;                       // (RB, G)
  float* dz = z + RB * G;                       // (RB, G)
  float* part = dz + RB * G;                    // (4, RB, W)
  const int s0 = blockIdx.x * RB;
  const int nr = min(RB, B - s0);
  for (int i = tid; i < RB * W; i += NT) {
    const int r = i / W;
    dh[i] = r < nr ? dhT[(size_t)s0 * W + i] : 0.0f;
    dc[i] = r < nr ? dcT[(size_t)s0 * W + i] : 0.0f;
  }
  for (int i = tid; i < RB * G; i += NT) dz[i] = 0.0f;
  PHASE_INIT
  __syncthreads();
  for (int t = T - 1; t >= 0; --t) {
    const size_t row0 = (size_t)t * B + s0;
    // z as the forward computed it, from lstm_bwd_z
    for (int i = tid; i < nr * G; i += NT) z[i] = dxp[row0 * G + i];
    __syncthreads();
    PHASE(1)
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
    PHASE(2)
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
    PHASE(3)
    for (int i = tid; i < nr * W; i += NT) {
      const int r = i / W, u = i - r * W;
      const float* p = part + r * W + u;
      dh[i] = __fadd_rn(
          __fadd_rn(__fadd_rn(p[0], p[RB * W]), p[2 * RB * W]),
          p[3 * RB * W]);
    }
    PHASE(4)
    // dh[i] is read again by the thread that wrote it; the next step's
    // barriers order everything else
  }
  PHASE_FLUSH
  __syncthreads();
  for (int i = tid; i < nr * W; i += NT) {
    dh0[(size_t)s0 * W + i] = dh[i];
    dc0[(size_t)s0 * W + i] = dc[i];
  }
}

// ---- the two products off the chain: z and dU ----
//
// Both are C = A @ B with each sum in lstm_common.cuh's order: a fresh
// chain of FMAs a block of 32 terms, the blocks added to 0 in order.  A
// block of GTH threads computes a GT x GT tile of C, each thread 8 x 8
// outputs (rows ty*4 + a and 64 + ty*4 + a, columns tx*4 + b and 64 +
// tx*4 + b), from stages of GK terms staged in shared memory (A's rows
// transposed, term-major), two stages a 32-term block; the next stage's
// loads go into registers while the block runs the current one.  Terms
// past the sum's end are zeros: a chain that starts at +0 never holds
// -0, so they add nothing.
#define GT 128  // tile rows and columns
#define GK 16   // terms a stage
#define GTH 256 // threads a tile
#define GAP (GT + 4)  // a stage row of A, padded

// One product's operands: A(m, k) = A[m * lda + k], or A[k * lda + m]
// when AT (dU: A is h_prev, read down its rows), rounded to bf16 when
// QA; B(k, j) = B[k * ldb + j], f32 or bf16 (WT).
template <bool AT, bool QA, typename WT>
struct Blocked {
  const float* A;
  int lda;
  const WT* B;
  int ldb;
  int M, N;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi),
                     __high2float(hi));
}
__device__ __forceinline__ float4 round4(float4 v) {
  return make_float4(round_bf16(v.x), round_bf16(v.y), round_bf16(v.z),
                     round_bf16(v.w));
}

// tot = the tile's sums over terms [k0, k1) of rows m0.. and columns
// j0.. (tot[a][b]: row a < 4 ? ty*4 + a : 60 + ty*4 + a, likewise b)
template <bool AT, bool QA, typename WT>
__device__ __forceinline__ void blocked_tile(const Blocked<AT, QA, WT>& g,
                                             int m0, int j0, int k0, int k1,
                                             float (&tot)[8][8]) {
  __shared__ __align__(16) float As[2][GK][GAP];
  __shared__ __align__(16) float Bs[2][GK][GT];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float4 ra[2], rb[2];
  // stage s's loads: A, 128 x 16 (a float4 along k, or along m when AT)
  // and B, 16 x 128 (a float4 along j), 2 float4 each a thread
  auto load = [&](int s) {
    const int kb = k0 + s * GK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int f = tid + i * GTH;
      if (AT) {
        const int k = f / (GT / 4), m = 4 * (f % (GT / 4));
        ra[i] = kb + k < k1 && m0 + m < g.M
                    ? ld4(g.A + (size_t)(kb + k) * g.lda + m0 + m)
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      } else {
        const int m = f / (GK / 4), k = 4 * (f % (GK / 4));
        ra[i] = kb + k < k1 && m0 + m < g.M
                    ? ld4(g.A + (size_t)(m0 + m) * g.lda + kb + k)
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
      if (QA) ra[i] = round4(ra[i]);
      const int k = f / (GT / 4), j = 4 * (f % (GT / 4));
      rb[i] = kb + k < k1 && j0 + j < g.N
                  ? ld4(g.B + (size_t)(kb + k) * g.ldb + j0 + j)
                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int f = tid + i * GTH;
      if (AT) {
        const int k = f / (GT / 4), m = 4 * (f % (GT / 4));
        *reinterpret_cast<float4*>(&As[buf][k][m]) = ra[i];
      } else {
        const int m = f / (GK / 4), k = 4 * (f % (GK / 4));
        As[buf][k][m] = ra[i].x;
        As[buf][k + 1][m] = ra[i].y;
        As[buf][k + 2][m] = ra[i].z;
        As[buf][k + 3][m] = ra[i].w;
      }
      const int k = f / (GT / 4), j = 4 * (f % (GT / 4));
      *reinterpret_cast<float4*>(&Bs[buf][k][j]) = rb[i];
    }
  };
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) tot[a][b] = 0.0f;
  const int stages = (k1 - k0 + KCH - 1) / KCH * (KCH / GK);
  float acc[8][8];
  load(0);
  store(0);
  __syncthreads();
  for (int s = 0; s < stages; ++s) {
    if (s + 1 < stages) load(s + 1);
    if (s % 2 == 0) {
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) acc[a][b] = 0.0f;
    }
    const int buf = s & 1;
#pragma unroll
    for (int k = 0; k < GK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][k][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[buf][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][k][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[buf][k][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
    if (s % 2 == 1) {
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) tot[a][b] += acc[a][b];
    }
    if (s + 1 < stages) store((s + 1) & 1);
    __syncthreads();
  }
}

// the row and column of tot[a][b] in the tile
__device__ __forceinline__ int tile_row(int a) {
  return (a < 4 ? 0 : 60) + (threadIdx.x / 16) * 4 + a;
}
__device__ __forceinline__ int tile_col(int b) {
  return (b < 4 ? 0 : 60) + (threadIdx.x % 16) * 4 + b;
}

// z = x_proj + q(h_prev) @ U for all N = T*B rows, into Z (dx_proj):
// A = h_prev (N, W), rounded to bf16 when U is; a block a 128 x 128
// tile of Z, its sums in blocked_tile's order (dot_cols' float), then
// x_proj + the sum.
template <typename WT>
__device__ __forceinline__ void z_tile(const float* __restrict__ xp,
                                       const float* __restrict__ A,
                                       const WT* __restrict__ U, float* Z,
                                       int N, int W, int G) {
  const Blocked<false, is_bf16<WT>::value, WT> g{A, W, U, G, N, G};
  const int m0 = blockIdx.x * GT, j0 = blockIdx.y * GT;
  float tot[8][8];
  blocked_tile(g, m0, j0, 0, W, tot);
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int n = m0 + tile_row(a);
#pragma unroll
    for (int b = 0; b < 8; b += 4) {
      const int j = j0 + tile_col(b);
      if (n < N && j < G) {
        const float4 x = ld4(xp + (size_t)n * G + j);
        *reinterpret_cast<float4*>(Z + (size_t)n * G + j) =
            make_float4(x.x + tot[a][b], x.y + tot[a][b + 1],
                        x.z + tot[a][b + 2], x.w + tot[a][b + 3]);
      }
    }
  }
}
template <typename WT>
__global__ void __launch_bounds__(GTH)
    lstm_bwd_z(const float* __restrict__ xp, const float* __restrict__ A,
               const WT* __restrict__ U, float* Z, int N, int W, int G) {
  z_tile<WT>(xp, A, U, Z, N, W, G);
}
// the same product for a layer of the wide layout (its own name, so that
// a trace tells the wide layers' backward from the others')
template <typename WT>
__global__ void __launch_bounds__(GTH)
    lstm_bwd_wide_z(const float* __restrict__ xp, const float* __restrict__ A,
                    const WT* __restrict__ U, float* Z, int N, int W, int G) {
  z_tile<WT>(xp, A, U, Z, N, W, G);
}

// A quarter of a dz row in shared memory: the padded width, rounded so
// that a quarter starts 8 floats (mod 16) after the one before the one
// before: the float4 loads of a lane group's quarters 2gp + gg fall
// into distinct banks.
__host__ __device__ inline int quarter_width(int W) {
  const int wp = padded_width(W);
  return wp + (24 - wp % 16) % 16;
}

struct BwdArgs {
  const float* xp;     // (T, B, 4W)
  const float* hprev;  // (T, B, W)
  const float* cprev;  // (T, B, W)
  const float* ccur;   // (T, B, W)
  const float* dhout;  // (T, B, W)
  const void* U;       // (W, 4W) f32 or bf16
  const float* recT;   // (4W, W)
  const float* dhT;    // (B, W)
  const float* dcT;    // (B, W)
  float* dxp;          // (T, B, 4W): z from lstm_bwd_z, then dz
  float* dh0;          // (B, W)
  float* dc0;          // (B, W)
  unsigned* flags;     // the grid layout's group counters, zeroed
  int B, T, W, rb, rt;
};

// The unit's dh on lanes j < RT of its group (row j): lane (quarter
// pair gp, block kb) runs the 32-term chains of each row's dz quarters
// 2gp and 2gp+1 (x: the group's first row in the padded rows, quarters
// QP apart, rows ZP apart) with its weights; lane kb=0 of each pair adds
// the blocks in order; lane j adds row j's four quarters in q order.
template <int NKB, int RT>
__device__ __forceinline__ float bwd_dh(const float* x, int ZP, int QP,
                                        const RegRole& ro, int W,
                                        const float* wr) {
  constexpr int GS = 2 * NKB;
  float acc[2 * RT];
  const int n = min(KCH, W - ro.kb * KCH);
#pragma unroll
  for (int gg = 0; gg < 2; ++gg) {
    const float* xb = x + (ro.gate + gg) * QP + ro.kb * (KCH + 4);
    const float* wg = wr + gg * KCH;
#pragma unroll
    for (int r = 0; r < RT; ++r) acc[gg * RT + r] = 0.0f;
#pragma unroll
    for (int k = 0; k < KCH; k += 4) {
      if (k < n) {
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const float4 xv = *reinterpret_cast<const float4*>(xb + r * ZP + k);
          float v = acc[gg * RT + r];
          v = fmaf(xv.x, wg[k], v);
          v = fmaf(xv.y, wg[k + 1], v);
          v = fmaf(xv.z, wg[k + 2], v);
          v = fmaf(xv.w, wg[k + 3], v);
          acc[gg * RT + r] = v;
        }
      }
    }
  }
  kb_sum<NKB, 2 * RT, GS>(acc);
  float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float v =
          __shfl_sync(0xffffffffu, acc[(q & 1) * RT + r], NKB * (q >> 1), GS);
      if (ro.q == r) p[q] = v;
    }
  return __fadd_rn(__fadd_rn(__fadd_rn(p[0], p[1]), p[2]), p[3]);
}

// Send row j's dz of the unit's four gates (dz[] on lane j < RT of the
// group) into the padded rows buf (RB, 4, QP) of every block of the
// cluster, completing on each block's bar; the group's lanes share the
// 4 x CL stores of a row.
template <int NKB, int RT>
__device__ __forceinline__ void bwd_send(const float* dz, float* buf,
                                         uint64_t* bar, int QP,
                                         const RegRole& ro, int nr, int CL) {
  constexpr int GS = 2 * NKB;
  const unsigned a = smem_addr(buf) + 4u * (unsigned)hpad(ro.u);
  const unsigned b = smem_addr(bar);
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = __shfl_sync(0xffffffffu, dz[q], r, GS);
    const int row = ro.rg * RT + r;
    if (!ro.valid || row >= nr) continue;
    for (int e = ro.q; e < 4 * CL; e += GS) {
      const int q = e & 3, k = e >> 2;
      const float x = q == 0 ? v[0] : q == 1 ? v[1] : q == 2 ? v[2] : v[3];
      st_async(mapa(a + 4u * (unsigned)((row * 4 + q) * QP), k), x,
               mapa(b, k));
    }
  }
}

// The register layout of the chain (scan_common.cuh): rows (2, RB, 4,
// QP) of dz padded in shared memory, the buffer of step parity, and two
// mbarriers are all the block holds.  Lane (quarter pair gp, block kb)
// of unit u keeps U[u, qW + 32kb ..] of quarters q = 2gp, 2gp+1 in
// registers (64 weights); lane j < RT of the group runs
// row j's gate derivatives with dh, dc and the step's loads in its
// registers.  Step n = T-1-t sends dz of step t into buffer n & 1 (phase
// n >> 1 of its mbarrier); step n+1 waits for it there.
template <int NKB, int RT>
__global__ void __launch_bounds__(SCAN_NT, 1)
    lstm_bwd_reg_kernel(BwdArgs p) {
  extern __shared__ float4 smem4[];
  float* db = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = (int)cluster.num_blocks();
  const Geo g = make_geo(p.W, CL, (int)cluster.block_rank());
  const int W = p.W, B = p.B, T = p.T, G = 4 * W, RB = p.rb;
  const int QP = quarter_width(W), ZP = 4 * QP;
  const int s0 = (int)(blockIdx.x / CL) * RB, nr = min(RB, B - s0);
  uint64_t* bar = reinterpret_cast<uint64_t*>(db + 2 * RB * ZP);
  const RegRole ro =
      reg_role<NKB, 2>(g, RB / RT, reg_group_threads(W, RB, CL, RT, 2));
  const int row = ro.rg * RT + ro.q;
  const bool mine = ro.lg == 0 && ro.valid && ro.q < RT && row < nr;
  const size_t o = (size_t)(s0 + row) * W + ro.u;  // (B, W) element
  PHASE_INIT

  // U[u, q*W + i] for the lane's quarters q and 32 terms i, from U^T
  // as f32
  float wr[2 * KCH];
#pragma unroll
  for (int gg = 0; gg < 2; ++gg)
#pragma unroll
    for (int k = 0; k < KCH; ++k) {
      const int i = ro.kb * KCH + k;
      wr[gg * KCH + k] =
          ro.lg == 0 && ro.valid && i < W
              ? __ldg(p.recT + (size_t)((ro.gate + gg) * W + i) * W + ro.u)
              : 0.0f;
    }
  float dh = 0.0f, dc = 0.0f;
  // the loads of the next step: z of the unit's four gates, c_prev,
  // c_cur, dh_out
  float zn[4] = {0.0f, 0.0f, 0.0f, 0.0f}, cpn = 0.0f, ccn = 0.0f,
        dhn = 0.0f;
  if (mine) {
    dh = p.dhT[o];
    dc = p.dcT[o];
    if (T > 0) {
      const size_t e = (size_t)(T - 1) * B * W + o;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        zn[q] = p.dxp[((size_t)(T - 1) * B + s0 + row) * G + q * W + ro.u];
      cpn = p.cprev[e];
      ccn = p.ccur[e];
      dhn = p.dhout[e];
    }
  }
  for (int i = threadIdx.x; i < 2 * RB * ZP; i += SCAN_NT) db[i] = 0.0f;
  if (threadIdx.x == 0) {
    mbar_init(bar);
    mbar_init(bar + 1);
    mbar_init_fence();
  }
  cluster.sync();  // every block of the cluster runs and holds its rows

  if (ro.lg == 0) {
    for (int n = 0; n < T; ++n) {
      const int t = T - 1 - n, cur = n & 1;
      if (threadIdx.x == 0) mbar_expect(bar + cur, 16u * nr * W);
      // this step's gates and loads, off the chain
      const float ig = sigm(zn[0]);
      const float fg = sigm(zn[1]);
      const float gg = tanhf(zn[2]);
      const float og = sigm(zn[3]);
      const float cp = cpn, tc = tanhf(ccn), dho = dhn;
      if (mine && t > 0) {
        const size_t e = (size_t)(t - 1) * B * W + o;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          zn[q] = p.dxp[((size_t)(t - 1) * B + s0 + row) * G + q * W +
                        ro.u];
        cpn = __ldg(p.cprev + e);
        ccn = __ldg(p.ccur + e);
        dhn = __ldg(p.dhout + e);
      }
      PHASE(1)
      if (n > 0) {
        // every block's dz of step t+1
        mbar_wait(bar + (cur ^ 1), ((n - 1) >> 1) & 1);
        PHASE(2)
        dh = bwd_dh<NKB, RT>(db + ((cur ^ 1) * RB + ro.rg * RT) * ZP, ZP,
                             QP, ro, W, wr);
        PHASE(3)
      }
      float dz[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (mine) {
        const float dht = __fadd_rn(dho, dh);
        const float d_o = __fmul_rn(dht, tc);
        const float dct = __fadd_rn(
            dc, __fmul_rn(__fmul_rn(dht, og),
                          __fsub_rn(1.0f, __fmul_rn(tc, tc))));
        const float d_i = __fmul_rn(dct, gg);
        const float d_f = __fmul_rn(dct, cp);
        const float d_g = __fmul_rn(dct, ig);
        dz[0] = __fmul_rn(__fmul_rn(d_i, ig), __fsub_rn(1.0f, ig));
        dz[1] = __fmul_rn(__fmul_rn(d_f, fg), __fsub_rn(1.0f, fg));
        dz[2] = __fmul_rn(d_g, __fsub_rn(1.0f, __fmul_rn(gg, gg)));
        dz[3] = __fmul_rn(__fmul_rn(d_o, og), __fsub_rn(1.0f, og));
        dc = __fmul_rn(dct, fg);
      }
      bwd_send<NKB, RT>(dz, db + cur * RB * ZP, bar + cur, QP, ro, nr, CL);
      if (mine) {
        float* out = p.dxp + ((size_t)t * B + s0 + row) * G + ro.u;
#pragma unroll
        for (int q = 0; q < 4; ++q) out[q * W] = dz[q];
      }
      PHASE(4)
    }
    if (T > 0) {
      const int last = (T - 1) & 1;  // dz of step 0
      mbar_wait(bar + last, ((T - 1) >> 1) & 1);
      dh = bwd_dh<NKB, RT>(db + (last * RB + ro.rg * RT) * ZP, ZP, QP, ro,
                           W, wr);
    }
    if (mine) {
      p.dh0[o] = dh;
      p.dc0[o] = dc;
    }
  }
  PHASE_FLUSH
  cluster.sync();  // no block leaves while another may still write to it
}

// The grid layout of the chain (scan_common.cuh; W = 512): thread (warp
// w, lane l) of block k keeps U^T[qW + 32kb .. qW + 32kb + 32, u] for
// the quarter q = w/2, the 32-term block kb = l % 16 and the four units
// u = 16k + 4((w % 2) * 2 + l/16) + j in registers (128 weights, loaded
// as float4 rows of recT).  Iteration n = T-1-t: the group's dz rows of
// step t+1 (dx_proj, written by every block of the group in iteration
// n-1) are staged in chunks of rt streams; per stream a thread runs its
// four 32-term chains and stores them as partial sums; thread (r, eu)
// of the chunk adds each quarter's 16 in block order, then the four
// quarters as ((p0 + p1) + p2) + p3 (dh; dh_T at n = 0), and finishes
// the unit's gate derivatives with its dc (in shared memory): dz into
// dx_proj, the rows iteration n+1 reads.  What does not depend on dh
// (the gates from z, tanh(c_cur)) it computes into shared memory before
// the chunk's rows are waited for (before the group's counter for a
// step's first chunk), from loads issued a chunk ahead.  Iteration T
// computes dh0 alone.
#define GRID_PS (GRID_UPB + 4)  // a block's partial sums of one quarter's 32-term block
#define GRID_GV 8  // a (stream, unit)'s values of the gate derivatives, padded
// rows whose chains a thread runs at once (gen_beam_phases.py wide
// builds other values to time them)
#ifndef GRID_RU
#define GRID_RU 2
#endif

// the dh-independent values of one (stream, unit)'s gate derivatives:
// the gates, tanh(c_cur), c_prev and dh_out
struct GateVals {
  float ig, fg, gg, og, tc, cp, dho;
};

__global__ void __launch_bounds__(GRID_NT, 1)
    lstm_bwd_grid_kernel(BwdArgs p, const __grid_constant__ CUtensorMap tdz) {
  extern __shared__ float4 smem4[];
  const int W = p.W, G = 4 * W, B = p.B, T = p.T, RT = p.rt;
  const int cl = W / GRID_UPB, per = G / KCH;  // per: blocks of a row
  float* rows = grid_smem(smem4);  // (2, RT, 4W), swizzled
  float* part = rows + 2 * RT * G;  // (RT, 4, GRID_NKB, PS)
  float* gvs = part + RT * 4 * GRID_NKB * GRID_PS;  // (RT, 16, GV)
  float* dcs = gvs + RT * GRID_UPB * GRID_GV;  // (rb, GRID_UPB)
  // the staged buffers' mbarriers
  uint64_t* bar = reinterpret_cast<uint64_t*>(dcs + p.rb * GRID_UPB);
  const int grp = blockIdx.x / cl, u0 = (blockIdx.x % cl) * GRID_UPB;
  const int s0 = grp * p.rb, nr = min(p.rb, B - s0);
  unsigned* flag = p.flags + grp;
  // the products' role: quarter q, unit quad uq, 32-term block kb
  const int q = threadIdx.x >> 6;
  const int uq = ((threadIdx.x >> 5) & 1) * 2 + ((threadIdx.x >> 4) & 1);
  const int kb = threadIdx.x & 15;
  // the sums' role: row er of a chunk, unit eu
  const int er = threadIdx.x >> 4, eu = threadIdx.x & 15;
  float* gv = gvs + (er * GRID_UPB + eu) * GRID_GV;
  PHASE_INIT

  float wr[4 * KCH];
#pragma unroll
  for (int k = 0; k < KCH; ++k) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(
        p.recT + (size_t)(q * W + kb * KCH + k) * W + u0 + 4 * uq));
    wr[k] = v.x;
    wr[KCH + k] = v.y;
    wr[2 * KCH + k] = v.z;
    wr[3 * KCH + k] = v.w;
  }
  for (int i = threadIdx.x; i < nr * GRID_UPB; i += GRID_NT)
    dcs[i] = p.dcT[(size_t)(s0 + i / GRID_UPB) * W + u0 + i % GRID_UPB];
  // the loads of a chunk's gate derivatives (z of the four gates, c_prev,
  // c_cur, dh_out of step t), issued a chunk ahead: (step t, chunk c)
  float lz[4] = {0.0f, 0.0f, 0.0f, 0.0f}, lcp = 0.0f, lcc = 0.0f,
        ldh = 0.0f;
  auto load_vals = [&](int t, int c) {
    const int s = s0 + c * RT + er;
    if (t < 0 || er >= min(RT, nr - c * RT)) return;
#pragma unroll
    for (int g = 0; g < 4; ++g)
      lz[g] = __ldcg(p.dxp + ((size_t)t * B + s) * G + g * W + u0 + eu);
    const size_t e = ((size_t)t * B + s) * W + u0 + eu;
    lcp = __ldg(p.cprev + e);
    lcc = __ldg(p.ccur + e);
    ldh = __ldg(p.dhout + e);
  };
  auto store_vals = [&]() {
    *reinterpret_cast<float4*>(gv) =
        make_float4(sigm(lz[0]), sigm(lz[1]), tanhf(lz[2]), sigm(lz[3]));
    *reinterpret_cast<float4*>(gv + 4) =
        make_float4(tanhf(lcc), lcp, ldh, 0.0f);
  };
  load_vals(T - 1, 0);
  if (threadIdx.x == 0) {
    mbar_init(bar);
    mbar_init(bar + 1);
    mbar_init_fence();
  }
  __syncthreads();
  unsigned ph = 0;  // bit b: the parity of buffer b's next phase
  const int nch = (nr + RT - 1) / RT;
  const int sw = kb & 7;  // the swizzle of the lane's blocks
  for (int n = 0; n <= T; ++n) {
    const int t = T - 1 - n;  // the step whose gates run, while n < T
    // the group's dz rows of step t+1, from block row0 of tdz
    const int row0 = ((t + 1) * B + s0) * per;
    for (int c = 0; c < nch; ++c) {
      const int rc = min(RT, nr - c * RT);
      const bool mine = er < rc;
      if (mine && t >= 0) store_vals();
      // the next chunk's loads: this step's, else the next step's first
      if (c + 1 < nch)
        load_vals(t, c + 1);
      else
        load_vals(t - 1, 0);
      if (n > 0 && c == 0) {
        group_wait(flag, (unsigned)(cl * n));
        PHASE(1)
        grid_stage_rows(rows, &tdz, row0, per, rc, bar);
      }
      if (n > 0) {
        if (c + 1 < nch)
          grid_stage_rows(rows + ((c + 1) & 1) * RT * G, &tdz,
                          row0 + (c + 1) * RT * per, per,
                          min(RT, nr - (c + 1) * RT), bar + ((c + 1) & 1));
        mbar_wait(bar + (c & 1), (ph >> (c & 1)) & 1u);
        ph ^= 1u << (c & 1);
        __syncthreads();  // the sums of the chunk before are read
        PHASE(2)
        const float* xr =
            rows + (c & 1) * RT * G + (q * GRID_NKB + kb) * KCH;
        // RU rows at a time (more independent chains), then the rest
        auto rows_of = [&](auto ruc, int r) {
          constexpr int RU = decltype(ruc)::value;
          float acc[RU][4];
#pragma unroll
          for (int u = 0; u < RU; ++u)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[u][j] = 0.0f;
#pragma unroll
          for (int k = 0; k < KCH; k += 4) {
#pragma unroll
            for (int u = 0; u < RU; ++u) {
              const float4 xv = swz_ld4(xr + (r + u) * G, k / 4, sw);
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                float a = acc[u][j];
                a = fmaf(xv.x, wr[j * KCH + k], a);
                a = fmaf(xv.y, wr[j * KCH + k + 1], a);
                a = fmaf(xv.z, wr[j * KCH + k + 2], a);
                a = fmaf(xv.w, wr[j * KCH + k + 3], a);
                acc[u][j] = a;
              }
            }
          }
#pragma unroll
          for (int u = 0; u < RU; ++u)
            *reinterpret_cast<float4*>(
                part + (((r + u) * 4 + q) * GRID_NKB + kb) * GRID_PS +
                4 * uq) =
                make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
        };
        int r = 0;
        for (; r + GRID_RU <= rc; r += GRID_RU)
          rows_of(std::integral_constant<int, GRID_RU>{}, r);
        for (; r < rc; ++r) rows_of(std::integral_constant<int, 1>{}, r);
        __syncthreads();
        PHASE(3)
      }
      if (mine) {
        const int s = s0 + c * RT + er;
        const size_t o = (size_t)s * W + u0 + eu;  // (B, W) element
        float dh;
        if (n == 0) {
          dh = p.dhT[o];
        } else {
          float pq[4];
#pragma unroll
          for (int qq = 0; qq < 4; ++qq) {
            float tot = 0.0f;
            for (int b = 0; b < GRID_NKB; ++b)
              tot += part[((er * 4 + qq) * GRID_NKB + b) * GRID_PS + eu];
            pq[qq] = tot;
          }
          dh = __fadd_rn(__fadd_rn(__fadd_rn(pq[0], pq[1]), pq[2]), pq[3]);
        }
        float* dcp = dcs + (c * RT + er) * GRID_UPB + eu;
        if (n == T) {
          p.dh0[o] = dh;
          p.dc0[o] = *dcp;
        } else {
          const float4 v0 = *reinterpret_cast<const float4*>(gv);
          const float4 v1 = *reinterpret_cast<const float4*>(gv + 4);
          const float ig = v0.x, fg = v0.y, gg = v0.z, og = v0.w;
          const float tc = v1.x, cp = v1.y, dho = v1.z;
          const float dht = __fadd_rn(dho, dh);
          const float d_o = __fmul_rn(dht, tc);
          const float dct = __fadd_rn(
              *dcp, __fmul_rn(__fmul_rn(dht, og),
                              __fsub_rn(1.0f, __fmul_rn(tc, tc))));
          const float d_i = __fmul_rn(dct, gg);
          const float d_f = __fmul_rn(dct, cp);
          const float d_g = __fmul_rn(dct, ig);
          float* out = p.dxp + ((size_t)t * B + s) * G + u0 + eu;
          out[0] = __fmul_rn(__fmul_rn(d_i, ig), __fsub_rn(1.0f, ig));
          out[W] = __fmul_rn(__fmul_rn(d_f, fg), __fsub_rn(1.0f, fg));
          out[2 * W] = __fmul_rn(d_g, __fsub_rn(1.0f, __fmul_rn(gg, gg)));
          out[3 * W] = __fmul_rn(__fmul_rn(d_o, og), __fsub_rn(1.0f, og));
          *dcp = __fmul_rn(dct, fg);
        }
      }
      PHASE(4)
    }
    if (n < T) group_arrive(flag);
    PHASE(5)
  }
  PHASE_FLUSH
}

// part[s] = A[n0:n1]^T @ Dz[n0:n1] for split s of the N = T*B rows:
// A = hprev (N, W), rounded to bf16 when QUANT, Dz (N, G).  One block
// per (128 x 128 tile of dU, split), its sums over the split's rows in
// blocked_tile's order.
template <bool QUANT>
__device__ __forceinline__ void du_tile(const float* __restrict__ A,
                                        const float* __restrict__ Dz,
                                        float* part, int N, int W, int G,
                                        int split_rows) {
  const Blocked<true, QUANT, float> g{A, W, Dz, G, W, G};
  const int i0 = blockIdx.x * GT, j0 = blockIdx.y * GT;
  const int n0 = blockIdx.z * split_rows;
  float tot[8][8];
  blocked_tile(g, i0, j0, n0, min(N, n0 + split_rows), tot);
  float* out = part + (size_t)blockIdx.z * W * G;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int i = i0 + tile_row(a);
#pragma unroll
    for (int b = 0; b < 8; b += 4) {
      const int j = j0 + tile_col(b);
      if (i < W && j < G)
        *reinterpret_cast<float4*>(out + (size_t)i * G + j) = make_float4(
            tot[a][b], tot[a][b + 1], tot[a][b + 2], tot[a][b + 3]);
    }
  }
}
template <bool QUANT>
__global__ void __launch_bounds__(GTH)
    lstm_du_partial(const float* __restrict__ A, const float* __restrict__ Dz,
                    float* part, int N, int W, int G, int split_rows) {
  du_tile<QUANT>(A, Dz, part, N, W, G, split_rows);
}
template <bool QUANT>
__global__ void __launch_bounds__(GTH)
    lstm_bwd_wide_du_partial(const float* __restrict__ A,
                             const float* __restrict__ Dz, float* part, int N,
                             int W, int G, int split_rows) {
  du_tile<QUANT>(A, Dz, part, N, W, G, split_rows);
}

// dU = part[0] + part[1] + ... in that order
__device__ __forceinline__ void du_sum(const float* __restrict__ part,
                                       float* dU, int n, int splits) {
  const int idx = blockIdx.x * DT + threadIdx.x;
  if (idx >= n) return;
  float s = part[idx];
  for (int k = 1; k < splits; ++k) s = __fadd_rn(s, part[(size_t)k * n + idx]);
  dU[idx] = s;
}
__global__ void __launch_bounds__(DT)
    lstm_du_reduce(const float* __restrict__ part, float* dU, int n,
                   int splits) {
  du_sum(part, dU, n, splits);
}
__global__ void __launch_bounds__(DT)
    lstm_bwd_wide_du_reduce(const float* __restrict__ part, float* dU, int n,
                            int splits) {
  du_sum(part, dU, n, splits);
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

// Whether (rb, cl, rt) is a register layout of the chain
// (ops/scan_layout.py, kind 'bwd'): 2, 4 or 8 blocks of 32 terms a
// column, every block owning a unit, rt in 1, 2, 4 dividing rb, and a
// group of 2 x NKB lanes per unit and stream group in a block.
static inline bool bwd_layout_ok(int W, int rb, int cl, int rt) {
  const int nkb = (W + KCH - 1) / KCH;
  return W % 4 == 0 && (nkb == 2 || nkb == 4 || nkb == 8) &&
         (rb == 1 || rb == 2 || rb == 4 || rb == 8) &&
         (cl == 1 || cl == 2 || cl == 4 || cl == 8 || cl == 16) &&
         (W + cl - 1) / cl * (cl - 1) < W &&
         (rt == 1 || rt == 2 || rt == 4) && rb % rt == 0 &&
         reg_group_threads(W, rb, cl, rt, 2) <= SCAN_NT;
}

// the grid layout's streams a staged chunk at most (ops/scan_layout.py
// GRID_RT; gen_beam_phases.py wide builds other values to time them)
#ifndef GRID_RT
#define GRID_RT 8
#endif
// one thread a (stream, unit) of a chunk runs its sums and derivatives
static_assert(GRID_RT <= GRID_NT / GRID_UPB, "a chunk's streams > 16");

extern "C" size_t lstm_bwd_smem_bytes(int W, int rb, int rt, int mode);

// Whether (rb, cl, rt) is the grid layout of the chain for B streams
// (ops/scan_layout.py): W = 512, cl = W/16 blocks a group of 1 <= rb <= B
// streams, rt = grid_chunk_rows(rb, GRID_RT, the plan).
static inline bool bwd_grid_ok(int B, int W, int rb, int cl, int rt) {
  return grid_width_ok(W) && cl == W / GRID_UPB && rb >= 1 && rb <= B &&
         rt == grid_chunk_rows(rb, GRID_RT, [&](int r) {
           return lstm_bwd_smem_bytes(W, rb, r, MODE_GRID);
         });
}

// bytes of dynamic shared memory a block of the layout asks: the
// register layout's dz rows (2, rb, 4, QP) and two mbarriers; the grid
// layout's alignment, ring of dz rows (2, rt, 4W), partial sums (rt, 4, 16,
// GRID_PS), the gate derivatives' values (rt, 16, GRID_GV) and dc (rb,
// 16); or the one-block layout's rows (h, dh, dc,
// z, dz and the four partial sums)
extern "C" size_t lstm_bwd_smem_bytes(int W, int rb, int rt, int mode) {
  if (mode == MODE_GRID)  // 1024 bytes to align the rows, 2 mbarriers
    return 1024 + (size_t)4 * (2 * rt * 4 * W + rt * 4 * GRID_NKB * GRID_PS +
                               rt * GRID_UPB * GRID_GV + rb * GRID_UPB) +
           2 * 8;
  if (mode == MODE_REG)
    return (size_t)2 * rb * 4 * quarter_width(W) * 4 + 2 * 8;
  return (size_t)rb * (3 * W + 2 * 4 * W + 4 * W) * sizeof(float);
}

// dU's two kernels; `wide`: those of the wide layout's name
static int du_product(const BwdArgs& a, int u_bf16, float* dU, float* part,
                      cudaStream_t stream, bool wide = false) {
  const int G = 4 * a.W, N = a.B * a.T;
  const int splits = lstm_bwd_splits(a.B, a.T);
  const int split_rows = (N + splits - 1) / splits;
  // a split's rows are whole blocks of 32, so that the sums do not
  // depend on where the splits fall
  const int rows = (split_rows + KCH - 1) / KCH * KCH;
  const dim3 grid((a.W + GT - 1) / GT, (G + GT - 1) / GT, splits);
  auto partial = u_bf16 ? (wide ? lstm_bwd_wide_du_partial<true>
                                : lstm_du_partial<true>)
                        : (wide ? lstm_bwd_wide_du_partial<false>
                                : lstm_du_partial<false>);
  partial<<<grid, GTH, 0, stream>>>(a.hprev, a.dxp, part, N, a.W, G, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto reduce = wide ? lstm_bwd_wide_du_reduce : lstm_du_reduce;
  reduce<<<(a.W * G + DT - 1) / DT, DT, 0, stream>>>(part, dU, a.W * G,
                                                     splits);
  return (int)cudaGetLastError();
}

// z for all T*B rows into dx_proj, before every layout's chain; `wide`:
// the kernel of the wide layout's name
static int z_product(const BwdArgs& a, int u_bf16, cudaStream_t s,
                     bool wide = false) {
  const int G = 4 * a.W, N = a.B * a.T;
  if (N == 0) return 0;
  const dim3 grid((N + GT - 1) / GT, (G + GT - 1) / GT);
  if (u_bf16) {
    auto kern = wide ? lstm_bwd_wide_z<__nv_bfloat16>
                     : lstm_bwd_z<__nv_bfloat16>;
    kern<<<grid, GTH, 0, s>>>(a.xp, a.hprev,
                              static_cast<const __nv_bfloat16*>(a.U), a.dxp,
                              N, a.W, G);
  } else {
    auto kern = wide ? lstm_bwd_wide_z<float> : lstm_bwd_z<float>;
    kern<<<grid, GTH, 0, s>>>(a.xp, a.hprev, static_cast<const float*>(a.U),
                              a.dxp, N, a.W, G);
  }
  return (int)cudaGetLastError();
}

// the one-block layout's chain, the first port's launch
static int one_block(const BwdArgs& a, size_t smem, cudaStream_t stream) {
  return dispatch_rows(a.rb, [&](auto rbc) {
    constexpr int RB = decltype(rbc)::value;
    cudaError_t err = cudaFuncSetAttribute(
        lstm_bwd_kernel<RB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    lstm_bwd_kernel<RB><<<(a.B + RB - 1) / RB, NT, smem, stream>>>(
        a.cprev, a.ccur, a.dhout, a.recT, a.dhT, a.dcT, a.dxp, a.dh0, a.dc0,
        a.B, a.T, a.W);
    return (int)cudaGetLastError();
  });
}

// the grid layout's chain: its group counters zeroed, then the
// cooperative launch
static int grid_chain(const BwdArgs& a, int cl, size_t smem,
                      cudaStream_t stream) {
  const int groups = (a.B + a.rb - 1) / a.rb;
  const cudaError_t err =
      cudaMemsetAsync(a.flags, 0, groups * sizeof(unsigned), stream);
  if (err != cudaSuccess) return (int)err;
  // the tensor map of the dz rows the steps read (dx_proj; none without
  // steps)
  CUtensorMap tdz = {};
  const int e = a.T > 0 ? encode_rows(&tdz, a.dxp,
                                      (size_t)a.T * a.B * 4 * a.W / KCH,
                                      4 * a.W / KCH)
                        : 0;
  if (e != 0) return e;
  return grid_launch(lstm_bwd_grid_kernel, groups * cl, smem, stream, a,
                     tdz);
}

// f(integral_constant NKB, integral_constant RT) for RT in 1, 2, 4
template <typename F>
static int dispatch_bwd(int nkb, int rt, F&& f) {
  using std::integral_constant;
  auto by_rt = [&](auto nkbc) -> int {
    switch (rt) {
      case 1:
        return f(nkbc, integral_constant<int, 1>{});
      case 2:
        return f(nkbc, integral_constant<int, 2>{});
      case 4:
        return f(nkbc, integral_constant<int, 4>{});
      default:
        return (int)cudaErrorInvalidValue;
    }
  };
  switch (nkb) {
    case 2:
      return by_rt(integral_constant<int, 2>{});
    case 4:
      return by_rt(integral_constant<int, 4>{});
    case 8:
      return by_rt(integral_constant<int, 8>{});
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// the register layout's chain (or, with fits, how many of its clusters
// the card holds at once)
static int reg_chain_launch(const BwdArgs& a, int cl, int rt, size_t smem,
                            cudaStream_t stream, int* fits) {
  const int clusters = fits ? 1 : (a.B + a.rb - 1) / a.rb;
  return dispatch_bwd((a.W + KCH - 1) / KCH, rt, [&](auto nkbc, auto rtc) {
    constexpr int NKB = decltype(nkbc)::value, RT = decltype(rtc)::value;
    return cluster_launch(lstm_bwd_reg_kernel<NKB, RT>, a, cl, clusters,
                          smem, stream, fits);
  });
}

// Refuses (invalid value) a layout that is none of a register layout of
// bwd_layout_ok, the grid layout of bwd_grid_ok (with its counters) and
// the one-block layout (one_block_rows_ok streams, cl 1, rt rb), or
// whose smem differs from lstm_bwd_smem_bytes.
static bool checked(const BwdArgs& a, int cl, int rt, int mode, size_t smem,
                    bool fits) {
  bool ok = a.B >= 1 && a.W >= 4 && a.W % 4 == 0;
  if (mode == MODE_REG)
    ok = ok && bwd_layout_ok(a.W, a.rb, cl, rt);
  else if (mode == MODE_GRID)
    ok = ok && !fits && bwd_grid_ok(a.B, a.W, a.rb, cl, rt) &&
         a.flags != nullptr;
  else
    ok = ok && mode == MODE_ONE && !fits && one_block_rows_ok(a.B, a.rb) &&
         cl == 1 && rt == a.rb;
  return ok && smem == lstm_bwd_smem_bytes(a.W, a.rb, rt, mode);
}

// How many clusters of the register layout the card holds at once (0 if
// none).
extern "C" int lstm_bwd_max_clusters(int W, int rb, int cl, int rt,
                                     size_t smem) {
  BwdArgs a{};
  a.B = rb, a.W = W, a.rb = rb;
  int fits = 0;
  if (!checked(a, cl, rt, MODE_REG, smem, true)) return 0;
  return reg_chain_launch(a, cl, rt, smem, 0, &fits) == 0 ? fits : 0;
}

// U points to W*4W floats, or to W*4W bf16 values when u_bf16 is set;
// part is scratch of lstm_bwd_splits(B, T) * W * 4W floats; flags the
// grid layout's scratch of ceil(B / rb) counters (zeroed here), else
// unused; (rb, cl, rt, mode) is the layout (mode: MODE_ONE, MODE_REG or
// MODE_GRID) and smem its shared memory (ops/scan_layout.py, kind
// 'bwd'), which must equal lstm_bwd_smem_bytes.  Every layout's chain
// reads z from lstm_bwd_z, launched first.
extern "C" int lstm_bwd_launch(const float* xp, const float* hprev,
                               const float* cprev, const float* ccur,
                               const float* dhout, const void* U,
                               const float* recT, const float* dhT,
                               const float* dcT, float* dxp, float* dU,
                               float* dh0, float* dc0, float* part,
                               unsigned* flags, int B, int T, int W,
                               int u_bf16, int rb, int cl, int rt, int mode,
                               size_t smem, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const BwdArgs a{xp,  hprev, cprev, ccur, dhout, U, recT, dhT, dcT,
                  dxp, dh0,   dc0,   flags, B,    T, W,    rb,  rt};
  if (!checked(a, cl, rt, mode, smem, false))
    return (int)cudaErrorInvalidValue;
  int err = z_product(a, u_bf16, s);
  if (err != 0) return err;
  if (mode == MODE_ONE)
    err = one_block(a, smem, s);
  else if (mode == MODE_GRID)
    err = grid_chain(a, cl, smem, s);
  else
    err = reg_chain_launch(a, cl, rt, smem, s, nullptr);
  if (err != 0) return err;
  return du_product(a, u_bf16, dU, part, s);
}

// ---- the wide layout of the chain (wide_common.cuh; W > 512) ----
//
// dh = dz @ U^T sums 4W terms a unit: too long a sum for the product of
// wide_common.cuh to keep a block's sums local.  So an iteration has two
// phases, each ended by the launch's counter.  Phase A: block (q, s)
// (q = blockIdx.x / nq, s = blockIdx.x % nq, nq = ceil(W / 64)) sums
// quarter q of dh for units [64 s, 64 s + 64): P_q[b, u] = the W-term
// sum of dz[b, qW + i] U[u, qW + i], from U^T's columns packed by
// lstm_bwd_wide_pack as vp[block][i][unit], into the scratch pq (4, B,
// W).  Phase B: each thread takes (stream, unit) elements b W + u =
// its global index + k x the launch's threads (8 at most, dc in its
// registers), adds dh = ((P_0 + P_1) + P_2) + P_3 (dh_T at the first
// iteration) and runs the gate derivatives from z (lstm_bwd_z's, in
// dx_proj) and the saved states: dz into dx_proj, the rows the next
// iteration's phase A reads.  Iteration T's phase B writes dh0 and dc0.
// The quarters' sums and their order are the one-block kernel's.
__global__ void __launch_bounds__(WIDE_NT, 1)
    lstm_bwd_wide_kernel(BwdArgs p, const float* __restrict__ vp, float* pq,
                         const __grid_constant__ CUtensorMap tdz) {
  extern __shared__ float4 smem4[];
  const int W = p.W, G = 4 * W, B = p.B, T = p.T, nkb = wide_chunks(W);
  const int nq = (W + WIDE_NC - 1) / WIDE_NC;
  const int q = blockIdx.x / nq;
  const int u = (blockIdx.x % nq) * WIDE_NC + 4 * (threadIdx.x & 15);
  const int rg = threadIdx.x >> 4;
  const float* bp = vp + (size_t)blockIdx.x * nkb * KCH * WIDE_NC;
  const WideRing w = wide_ring(smem4, B);
  const int nthr = gridDim.x * WIDE_NT;
  const int gid = blockIdx.x * WIDE_NT + threadIdx.x, ne = B * W;
  float dc[WIDE_RPT];
#pragma unroll
  for (int k = 0; k < WIDE_RPT; ++k) {
    const int e = gid + k * nthr;
    dc[k] = e < ne ? p.dcT[e] : 0.0f;
  }
  unsigned it = 0, syncs = 0;
  for (int n = 0; n <= T; ++n) {
    const int t = T - 1 - n;  // the step whose derivatives run, n < T
    if (t >= 0)  // phase B's loads into L2 while phase A runs
#pragma unroll
      for (int k = 0; k < WIDE_RPT; ++k) {
        const int e = gid + k * nthr;
        if (e >= ne) continue;
        const int r = e / W, uu = e - r * W;
        const size_t o = (size_t)t * B * W + e;
        const float* z = p.dxp + ((size_t)t * B + r) * G + uu;
        asm volatile(
            "prefetch.global.L2 [%0];\n"
            "prefetch.global.L2 [%1];\n"
            "prefetch.global.L2 [%2];\n"
            "prefetch.global.L2 [%3];\n"
            "prefetch.global.L2 [%4];\n"
            "prefetch.global.L2 [%5];\n"
            "prefetch.global.L2 [%6];\n" ::"l"(z),
            "l"(z + W), "l"(z + 2 * W), "l"(z + 3 * W), "l"(p.cprev + o),
            "l"(p.ccur + o), "l"(p.dhout + o));
      }
    if (n > 0) {  // phase A: the quarter sums of dz of step t + 1
      float tot[WIDE_RPT][4];
      wide_product<false>(w, &tdz, q, (t + 1) * B, bp, nkb, it, tot);
      if (u < W)
#pragma unroll
        for (int i = 0; i < WIDE_RPT; ++i) {
          const int r = rg + 16 * i;
          if (r < B)
            *reinterpret_cast<float4*>(pq + ((size_t)q * B + r) * W + u) =
                make_float4(tot[i][0], tot[i][1], tot[i][2], tot[i][3]);
        }
      group_arrive(p.flags);
      group_wait(p.flags, (unsigned)gridDim.x * ++syncs);
    }
#pragma unroll
    for (int k = 0; k < WIDE_RPT; ++k) {  // phase B
      const int e = gid + k * nthr;
      if (e >= ne) continue;
      const int r = e / W, uu = e - r * W;
      float dh;
      if (n == 0) {
        dh = p.dhT[e];
      } else {
        const float* pr = pq + (size_t)r * W + uu;
        const size_t qs = (size_t)B * W;
        dh = __fadd_rn(__fadd_rn(__fadd_rn(__ldcg(pr), __ldcg(pr + qs)),
                                 __ldcg(pr + 2 * qs)),
                       __ldcg(pr + 3 * qs));
      }
      if (n == T) {
        p.dh0[e] = dh;
        p.dc0[e] = dc[k];
        continue;
      }
      float* zr = p.dxp + ((size_t)t * B + r) * G + uu;
      const size_t o = (size_t)t * B * W + e;
      const float ig = sigm(zr[0]);
      const float fg = sigm(zr[W]);
      const float gg = tanhf(zr[2 * W]);
      const float og = sigm(zr[3 * W]);
      const float cp = p.cprev[o];
      const float tc = tanhf(p.ccur[o]);
      const float dht = __fadd_rn(p.dhout[o], dh);
      const float d_o = __fmul_rn(dht, tc);
      const float dct = __fadd_rn(
          dc[k], __fmul_rn(__fmul_rn(dht, og),
                           __fsub_rn(1.0f, __fmul_rn(tc, tc))));
      const float d_i = __fmul_rn(dct, gg);
      const float d_f = __fmul_rn(dct, cp);
      const float d_g = __fmul_rn(dct, ig);
      zr[0] = __fmul_rn(__fmul_rn(d_i, ig), __fsub_rn(1.0f, ig));
      zr[W] = __fmul_rn(__fmul_rn(d_f, fg), __fsub_rn(1.0f, fg));
      zr[2 * W] = __fmul_rn(d_g, __fsub_rn(1.0f, __fmul_rn(gg, gg)));
      zr[3 * W] = __fmul_rn(__fmul_rn(d_o, og), __fsub_rn(1.0f, og));
      dc[k] = __fmul_rn(dct, fg);
    }
    if (n < T) {
      group_arrive(p.flags);
      group_wait(p.flags, (unsigned)gridDim.x * ++syncs);
    }
  }
}

// vp[q nq + s][i][c] = U^T[q W + i, 64 s + c] (recT, f32) for the wide
// chain's blocks, terms i < 32 * wide_chunks(W), 0 past W
__global__ void __launch_bounds__(256)
    lstm_bwd_wide_pack(const float* __restrict__ recT, float* vp, int W,
                       size_t n) {
  const size_t idx = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (idx >= n) return;
  const int nq = (W + WIDE_NC - 1) / WIDE_NC, kp = wide_chunks(W) * KCH;
  const int c = (int)(idx % WIDE_NC);
  const size_t rest = idx / WIDE_NC;
  const int i = (int)(rest % kp), b = (int)(rest / kp);
  const int q = b / nq, u = (b % nq) * WIDE_NC + c;
  vp[idx] = i < W && u < W ? __ldg(recT + (size_t)(q * W + i) * W + u) : 0.0f;
}

// Whether the wide chain takes B streams of width W: W > 512 and W % 4
// == 0, 1 <= B <= WIDE_RB, and its 4 ceil(W / 64) blocks at most `n_sm`.
static inline bool lstm_bwd_wide_ok(int B, int W, int n_sm) {
  return W > GRID_NKB * KCH && W % 4 == 0 && B >= 1 && B <= WIDE_RB &&
         4 * ((W + WIDE_NC - 1) / WIDE_NC) <= n_sm;
}

// lstm_bwd_launch in the wide layout: the z product, the pack of recT,
// the chain (vp: scratch of 4 ceil(W / 64) * 32 * wide_chunks(W) * 64
// floats; pq: scratch of 4 * B * W floats; flags one counter, zeroed
// here; smem WIDE_SMEM_BYTES) and dU, each kernel named
// lstm_bwd_wide_*; refuses (invalid value) a shape lstm_bwd_wide_ok
// does not take or another smem.
extern "C" int lstm_bwd_wide_launch(
    const float* xp, const float* hprev, const float* cprev,
    const float* ccur, const float* dhout, const void* U, const float* recT,
    const float* dhT, const float* dcT, float* dxp, float* dU, float* dh0,
    float* dc0, float* part, unsigned* flags, float* vp, float* pq, int B,
    int T, int W, int u_bf16, size_t smem, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (!lstm_bwd_wide_ok(B, W, n_sm) || flags == nullptr || vp == nullptr ||
      pq == nullptr || smem != WIDE_SMEM_BYTES)
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{xp,  hprev, cprev, ccur, dhout, U, recT, dhT, dcT,
                  dxp, dh0,   dc0,   flags, B,    T, W,    B,   1};
  int e = z_product(a, u_bf16, s, true);
  if (e != 0) return e;
  const int blocks = 4 * ((W + WIDE_NC - 1) / WIDE_NC);
  const size_t n = (size_t)blocks * wide_chunks(W) * KCH * WIDE_NC;
  lstm_bwd_wide_pack<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(recT, vp, W,
                                                                   n);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = cudaMemsetAsync(flags, 0, sizeof(unsigned), s);
  if (err != cudaSuccess) return (int)err;
  // the dz rows the phases A read: dx_proj as (T B, 4, W) (none without
  // steps)
  CUtensorMap tdz = {};
  if (T > 0) {
    e = encode_wide(&tdz, dxp, (size_t)T * B, 4, W, B);
    if (e != 0) return e;
  }
  e = grid_launch(lstm_bwd_wide_kernel, blocks, smem, s, a,
                  (const float*)vp, pq, tdz);
  if (e != 0) return e;
  return du_product(a, u_bf16, dU, part, s, true);
}
