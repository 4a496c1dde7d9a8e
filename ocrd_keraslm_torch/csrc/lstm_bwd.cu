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
//    one tiled product that all SMs share, into dx_proj (the chain reads
//    z there and overwrites it with dz), each sum in dot_cols' order (a
//    fresh 32-FMA chain a block of 32 terms, the blocks added to 0 in
//    order, then x_proj +): z is the forward's z, bit for bit;
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
//  * widths the register layout does not fit, and batches whose
//    clusters would run in many waves (ops/scan_layout.py chooses), run
//    the first port's one-block kernel, lstm_bwd_kernel, unchanged: one
//    block per RB <= 8 streams, z and both products of a step from
//    weights read from L2;
//  * dU is not part of the recurrence: step t-1 reads nothing of it.
//    dU = q(h_prev)^T dz is one product of (W, T*B) by (T*B, 4W) over
//    arrays in device memory, which all SMs share: lstm_du_partial tiles
//    it 64 x 64 and splits the T*B rows over blockIdx.z into per-split
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
// Both layouts give the same bits.  All arithmetic is f32 on CUDA cores:
// no TF32, no tensor cores.

#include "scan_common.cuh"

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

// z = x_proj + q(h_prev) @ U for all N = T*B rows, into Z (dx_proj):
// A = h_prev (N, W), rounded to bf16 when U is; one block per 64 x 64
// tile of Z, each thread a 4 x 4 patch; 32 terms at a time through
// shared memory, each 32 a fresh FMA chain in term order added to the
// patch's sums in block order (dot_cols' float; a zero term past W adds
// nothing, as a chain that starts at +0 never holds -0).
template <typename WT>
__global__ void __launch_bounds__(DT)
    lstm_bwd_z(const float* __restrict__ xp, const float* __restrict__ A,
               const WT* __restrict__ U, float* Z, int N, int W, int G) {
  __shared__ __align__(16) float As[KCH][TI + 4];
  __shared__ __align__(16) float Bs[KCH][TJ];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * TI, j0 = blockIdx.y * TJ;
  const int ty = tid / 16, tx = tid % 16;
  float tot[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) tot[a][b] = 0.0f;
  for (int k0 = 0; k0 < W; k0 += KCH) {
    for (int e = tid; e < KCH * TI; e += DT) {
      const int i = e / KCH, k = e - i * KCH;
      float v = 0.0f;
      if (n0 + i < N && k0 + k < W) v = A[(size_t)(n0 + i) * W + k0 + k];
      As[k][i] = is_bf16<WT>::value ? round_bf16(v) : v;
    }
    for (int e = tid; e < KCH * TJ; e += DT) {
      const int k = e / TJ, j = e - k * TJ;
      Bs[k][j] = k0 + k < W && j0 + j < G
                     ? ldw(U + (size_t)(k0 + k) * G + j0 + j)
                     : 0.0f;
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
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int n = n0 + ty * 4 + a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = j0 + tx * 4 + b;
      if (n < N && j < G)
        Z[(size_t)n * G + j] = xp[(size_t)n * G + j] + tot[a][b];
    }
  }
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
  int B, T, W, rb;
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

// bytes of dynamic shared memory a block of the layout asks: the
// register layout's dz rows (2, rb, 4, QP) and two mbarriers, or the
// one-block layout's rows (h, dh, dc, z, dz and the four partial sums)
extern "C" size_t lstm_bwd_smem_bytes(int W, int rb, int reg) {
  if (reg) return (size_t)2 * rb * 4 * quarter_width(W) * 4 + 2 * 8;
  return (size_t)rb * (3 * W + 2 * 4 * W + 4 * W) * sizeof(float);
}

static int du_product(const BwdArgs& a, int u_bf16, float* dU, float* part,
                      cudaStream_t stream) {
  const int G = 4 * a.W, N = a.B * a.T;
  const int splits = lstm_bwd_splits(a.B, a.T);
  const int split_rows = (N + splits - 1) / splits;
  // a split's rows are whole blocks of 32, so that the sums do not
  // depend on where the splits fall
  const int rows = (split_rows + KCH - 1) / KCH * KCH;
  const dim3 grid((a.W + TI - 1) / TI, (G + TJ - 1) / TJ, splits);
  if (u_bf16)
    lstm_du_partial<true><<<grid, DT, 0, stream>>>(a.hprev, a.dxp, part, N,
                                                   a.W, G, rows);
  else
    lstm_du_partial<false><<<grid, DT, 0, stream>>>(a.hprev, a.dxp, part, N,
                                                    a.W, G, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lstm_du_reduce<<<(a.W * G + DT - 1) / DT, DT, 0, stream>>>(part, dU,
                                                             a.W * G, splits);
  return (int)cudaGetLastError();
}

// the one-block layout's chain, the first port's launch
template <typename WT>
static int one_block(const BwdArgs& a, size_t smem, cudaStream_t stream) {
  return dispatch_rows(a.rb, [&](auto rbc) {
    constexpr int RB = decltype(rbc)::value;
    cudaError_t err = cudaFuncSetAttribute(
        lstm_bwd_kernel<RB, WT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    lstm_bwd_kernel<RB, WT><<<(a.B + RB - 1) / RB, NT, smem, stream>>>(
        a.xp, a.hprev, a.cprev, a.ccur, a.dhout,
        static_cast<const WT*>(a.U), a.recT, a.dhT, a.dcT, a.dxp, a.dh0,
        a.dc0, a.B, a.T, a.W);
    return (int)cudaGetLastError();
  });
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

// Refuses (invalid value) a layout that is neither a register layout of
// bwd_layout_ok nor the one-block layout (one_block_rows_ok streams, cl
// 1, rt rb), or whose smem differs from lstm_bwd_smem_bytes.
static bool checked(const BwdArgs& a, int cl, int rt, int reg, size_t smem,
                    bool fits) {
  return a.B >= 1 && a.W >= 4 && a.W % 4 == 0 &&
         (reg ? bwd_layout_ok(a.W, a.rb, cl, rt)
              : !fits && one_block_rows_ok(a.B, a.rb) && cl == 1 &&
                    rt == a.rb) &&
         smem == lstm_bwd_smem_bytes(a.W, a.rb, reg);
}

// How many clusters of the register layout the card holds at once (0 if
// none).
extern "C" int lstm_bwd_max_clusters(int W, int rb, int cl, int rt,
                                     size_t smem) {
  BwdArgs a{};
  a.B = rb, a.W = W, a.rb = rb;
  int fits = 0;
  if (!checked(a, cl, rt, 1, smem, true)) return 0;
  return reg_chain_launch(a, cl, rt, smem, 0, &fits) == 0 ? fits : 0;
}

// U points to W*4W floats, or to W*4W bf16 values when u_bf16 is set;
// part is scratch of lstm_bwd_splits(B, T) * W * 4W floats; (rb, cl, rt,
// reg) is the layout and smem its shared memory (ops/scan_layout.py,
// kind 'bwd'), which must equal lstm_bwd_smem_bytes
extern "C" int lstm_bwd_launch(const float* xp, const float* hprev,
                               const float* cprev, const float* ccur,
                               const float* dhout, const void* U,
                               const float* recT, const float* dhT,
                               const float* dcT, float* dxp, float* dU,
                               float* dh0, float* dc0, float* part, int B,
                               int T, int W, int u_bf16, int rb, int cl,
                               int rt, int reg, size_t smem, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const BwdArgs a{xp,  hprev, cprev, ccur, dhout, U, recT, dhT,
                  dcT, dxp,   dh0,   dc0,  B,     T, W,    rb};
  if (!checked(a, cl, rt, reg, smem, false)) return (int)cudaErrorInvalidValue;
  int err;
  if (!reg) {
    err = u_bf16 ? one_block<__nv_bfloat16>(a, smem, s)
                 : one_block<float>(a, smem, s);
  } else {
    const int G = 4 * W, N = B * T;
    if (N > 0) {
      const dim3 grid((N + TI - 1) / TI, (G + TJ - 1) / TJ);
      if (u_bf16)
        lstm_bwd_z<__nv_bfloat16><<<grid, DT, 0, s>>>(
            xp, hprev, static_cast<const __nv_bfloat16*>(U), dxp, N, W, G);
      else
        lstm_bwd_z<float><<<grid, DT, 0, s>>>(
            xp, hprev, static_cast<const float*>(U), dxp, N, W, G);
      err = (int)cudaGetLastError();
      if (err != 0) return err;
    }
    err = reg_chain_launch(a, cl, rt, smem, s, nullptr);
  }
  if (err != 0) return err;
  return du_product(a, u_bf16, dU, part, s);
}
