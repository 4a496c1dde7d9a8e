// The register layout of the two LSTM forward recurrences, lstm_scan.cu
// and score_scan.cu (host side: ops/scan_layout.py), and the exchange of
// h between the blocks of a cluster.
//
// A group of RB streams runs on one thread-block cluster of CL blocks.
// Block k owns the units [k*upb, k*upb + nu) (upb = ceil(W/CL)) and the
// four gate columns of each, updates their h and c, and sends the new h
// into every block of the cluster.  c never leaves its block.  Widths
// the layout does not fit run the one-block kernel of the first port,
// kept unchanged in each source.
//
// Bits: each column's dot product is the blocked sum of lstm_common.cuh
// (a fresh 32-FMA chain a block of KCH terms, the blocks added to 0 in
// order).  Here each block of a column runs on its own lane and the
// lanes' sums are added in block order: dot_cols' float, whatever CL,
// RB or RT.
#pragma once

#include "cluster_common.cuh"
#include "lstm_common.cuh"

#define SCAN_NT 512  // threads per block

// One block's share of the columns.
struct Geo {
  int W, G, upb, nc, nkb, u0, nu;
};

__host__ __device__ inline Geo make_geo(int W, int CL, int k) {
  Geo g;
  g.W = W;
  g.G = 4 * W;
  g.upb = (W + CL - 1) / CL;
  g.nc = 4 * g.upb;
  g.nkb = (W + KCH - 1) / KCH;
  g.u0 = k * g.upb;
  g.nu = W - g.u0 < g.upb ? (W - g.u0 > 0 ? W - g.u0 : 0) : g.upb;
  return g;
}

// The cluster launch of kern over `clusters` clusters of cl blocks, or,
// with `fits`, how many such clusters the card holds at once.
template <typename Kern, typename Args>
static int cluster_launch(Kern kern, const Args& args, int cl, int clusters,
                          size_t smem, cudaStream_t stream, int* fits) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && cl > 8)  // 16 blocks exceed the portable 8
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl * clusters);
  cfg.blockDim = dim3(SCAN_NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cl;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if (fits) return (int)cudaOccupancyMaxActiveClusters(fits, kern, &cfg);
  err = cudaLaunchKernelEx(&cfg, kern, args);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// ---- the register layout ----
//
// Where a block's columns times 32-term blocks fit its threads (2, 4 or
// 8 blocks of 32 terms a column), each thread keeps the 32 weights of one column's block (of
// GPL gate columns of one unit) in registers for the whole scan, and no
// weight is read again.  Lanes form groups of GS = 4/GPL*NKB, one group
// per (layer group lg, row group rg, unit ul): lane q = kb + NKB*gp runs
// block kb of gate columns gp*GPL.. of unit u for RT rows, one load of h
// feeding GPL FMAs.  Lane kb=0 of each gate adds the NKB partial sums in
// block order (shuffles); lane j < RT of the group gathers row j's four
// gates and runs its gate update (c in its registers).  No block barrier
// and no partial sum in shared memory.  Each layer group starts at a warp
// boundary, so a warp's lanes take the same branches.

// streams one thread's chain takes at most: its registers hold them
// beside 64 weights, and more spill (ops/scan_layout.REG_RT_MAX)
#define REG_RT_MAX 2

// Threads one layer group of the register layout takes (a multiple of
// the warp), and whether (rb, cl, rt) is a layout that fits lg layer
// groups into a block: 2, 4 or 8 blocks of 32 terms a column, every
// block owning a unit, rt <= REG_RT_MAX and <= a unit's lanes.
__host__ __device__ inline int reg_group_threads(int W, int rb, int cl,
                                                 int rt, int gpl) {
  const int upb = (W + cl - 1) / cl, nkb = (W + KCH - 1) / KCH;
  return ((rb / rt) * upb * (4 / gpl) * nkb + 31) & ~31;
}
static inline bool reg_layout_ok(int W, int lg, int rb, int cl, int rt,
                                 int gpl) {
  const int nkb = (W + KCH - 1) / KCH;
  return W % 4 == 0 && (nkb == 2 || nkb == 4 || nkb == 8) &&
         (rb == 1 || rb == 2 || rb == 4 || rb == 8) &&
         (cl == 1 || cl == 2 || cl == 4 || cl == 8 || cl == 16) &&
         (W + cl - 1) / cl * (cl - 1) < W && rt >= 1 && rb % rt == 0 &&
         rt <= REG_RT_MAX && rt <= 4 / gpl * nkb &&
         lg * reg_group_threads(W, rb, cl, rt, gpl) <= SCAN_NT;
}

struct RegRole {
  int lg, rg, ul, q, kb, gate, u;  // gate: the lane's first gate column
  bool valid;  // a unit of this block (else a lane that runs along)
};

template <int NKB, int GPL>
__device__ __forceinline__ RegRole reg_role(const Geo& g, int nrg,
                                            int lgs) {
  constexpr int GS = 4 / GPL * NKB;
  const int per = nrg * g.upb * GS;
  RegRole r;
  r.lg = threadIdx.x / lgs;
  int e = threadIdx.x - r.lg * lgs;
  r.valid = e < per;
  if (!r.valid) e %= GS;  // a whole group past the units: runs along
  r.q = e % GS;
  const int su = e / GS;
  r.ul = su % g.upb;
  r.rg = su / g.upb;
  r.kb = r.q % NKB;
  r.gate = r.q / NKB * GPL;
  r.u = g.u0 + r.ul;
  r.valid = r.valid && r.ul < g.nu;
  return r;
}

// The 32 weights of the role's block of each of its GPL gate columns of
// a global (W, G) weight, as f32 (0 past W or for a lane that runs
// along): wr[gg * KCH + k].
template <int GPL, typename WT>
__device__ __forceinline__ void load_wreg(float* wr, const WT* w,
                                          const Geo& g, const RegRole& r) {
#pragma unroll
  for (int gg = 0; gg < GPL; ++gg)
#pragma unroll
    for (int k = 0; k < KCH; ++k) {
      const int i = r.kb * KCH + k;
      wr[gg * KCH + k] =
          r.valid && i < g.W
              ? ldw(w + (size_t)i * g.G + (r.gate + gg) * g.W + r.u)
              : 0.0f;
    }
}

// acc[gg * RT + r] = block kb's chain of x row r (padded rows of stride
// WP) with gate gg's weights: a fresh chain of FMAs in term order
// (dot_cols' block); one load of x feeds the GPL chains.
template <int RT, int GPL>
__device__ __forceinline__ void reg_chain(const float* x, int WP, int kb,
                                          int W, const float* wr,
                                          float* acc) {
  const float* xb = x + kb * (KCH + 4);
  const int n = min(KCH, W - kb * KCH);
#pragma unroll
  for (int i = 0; i < GPL * RT; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int k = 0; k < KCH; k += 4) {
    if (k < n) {
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float4 xv = *reinterpret_cast<const float4*>(xb + r * WP + k);
#pragma unroll
        for (int gg = 0; gg < GPL; ++gg) {
          const float* wg = wr + gg * KCH + k;
          float a = acc[gg * RT + r];
          a = fmaf(xv.x, wg[0], a);
          a = fmaf(xv.y, wg[1], a);
          a = fmaf(xv.z, wg[2], a);
          a = fmaf(xv.w, wg[3], a);
          acc[gg * RT + r] = a;
        }
      }
    }
  }
}

// The unit's gate updates, one row a lane: lane j < RT of the group
// gathers row j's z of the four gates (each in acc[(gate % GPL) * RT +
// j] of its kb=0 lane), adds xg (its row's input projection of the four
// gates, when given), and updates c and hf (row j's c and f32 h, in its
// registers); returns h (rounded to bf16 when q) on lanes j < RT, 0
// elsewhere.
template <int NKB, int RT, int GPL>
__device__ __forceinline__ float reg_gate(const float* z, const float* xg,
                                          float& c, float& hf, bool q,
                                          int lane) {
  constexpr int GS = 4 / GPL * NKB;
  float zr[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int gate = 0; gate < 4; ++gate) {
      const float v = __shfl_sync(0xffffffffu, z[(gate % GPL) * RT + r],
                                  NKB * (gate / GPL), GS);
      if (lane == r) zr[gate] = v;
    }
  if (lane >= RT) return 0.0f;
  if (xg != nullptr)
#pragma unroll
    for (int gate = 0; gate < 4; ++gate) zr[gate] = xg[gate] + zr[gate];
  const float2 hc = lstm_gate(zr[0], zr[1], zr[2], zr[3], c);
  hf = hc.x;
  c = hc.y;
  return q ? round_bf16(hc.x) : hc.x;
}

// ---- the exchange of h without a cluster barrier ----
//
// Each new h value goes to every block of the cluster by st.async, which
// completes its 4 bytes on the destination block's mbarrier; a block
// waits on its own mbarrier until the step's rows (nr x W values) have
// all arrived.  One mbarrier per buffer of the step parity (and layer);
// its phase k is step 2k or 2k+1, armed by thread 0 with the expected
// bytes.  A block sends step t+2's h into a buffer only after it has
// received every block's h of step t+1, which each block sends only
// after its warps have read that buffer's step-t rows; so no write
// overtakes a read, provided every working warp waits for all of the
// step's layers before the next step.

// Send h of the group's rows rg*RT + r < nr (on lane r), unit u, into the
// padded rows buf of every block of the cluster, completing on each
// block's bar (lane q sends to blocks q, q + GS, ...).
template <int NKB, int RT, int GPL>
__device__ __forceinline__ void reg_send(float h, float* buf, uint64_t* bar,
                                         int WP, const RegRole& ro, int nr,
                                         int CL) {
  constexpr int GS = 4 / GPL * NKB;
  const unsigned a = smem_addr(buf) + 4u * (unsigned)hpad(ro.u);
  const unsigned b = smem_addr(bar);
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const float v = __shfl_sync(0xffffffffu, h, r, GS);
    const int row = ro.rg * RT + r;
    if (!ro.valid || row >= nr) continue;
    for (int k = ro.q; k < CL; k += GS)
      st_async(mapa(a + 4u * (unsigned)(row * WP), k), v, mapa(b, k));
  }
}

// Fill buf (2, rb, WP) with the padded rows of h0 (rows < nr of the
// group's streams, rounded to bf16 when q) and zeros.
__device__ __forceinline__ void reg_fill_rows(float* buf, const float* h0,
                                              int s0, int nr, int rb, int W,
                                              int WP, bool q) {
  for (int i = threadIdx.x; i < 2 * rb * WP; i += SCAN_NT) {
    const int r = i / WP, e = i - r * WP;
    const int u = e / (KCH + 4) * KCH + e % (KCH + 4);
    float v = 0.0f;
    if (r < nr && e % (KCH + 4) < KCH && u < W) {
      v = h0[(size_t)(s0 + r) * W + u];
      if (q) v = round_bf16(v);
    }
    buf[i] = v;
  }
}

// f(integral_constant NKB, integral_constant RT) for the register layout
static_assert(REG_RT_MAX == 2, "dispatch_nkb_rt instantiates RT 1 and 2");
template <typename F>
static int dispatch_nkb_rt(int nkb, int rt, F&& f) {
  using std::integral_constant;
  auto by_rt = [&](auto nkbc) -> int {
    switch (rt) {
      case 1:
        return f(nkbc, integral_constant<int, 1>{});
      case 2:
        return f(nkbc, integral_constant<int, 2>{});
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
