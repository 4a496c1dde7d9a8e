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

#include <cuda.h>

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

// ---- the grid layout (W = 512) ----
//
// A group of rb streams runs on cl = W/16 blocks of GRID_NT threads, one
// block an SM, all of the launch's groups resident at once (a
// cooperative launch, which fails rather than queue a group's blocks one
// after another).  Block k of a group owns the units [16k, 16k + 16); a
// thread keeps 128 weights in registers for the whole launch: the 32
// terms of one 32-term block of four columns (lstm_scan.cu: the four
// gates of one unit; lstm_bwd.cu: one quarter of U^T for four units), so
// the block holds its 64 columns x W terms (128 KiB of f32) on chip.
// The rows a step reads (h, or dz) cross the group's blocks through
// device memory (L2): each block writes its units of the step's output
// rows, arrives on the group's counter, and the step after waits for
// every block's arrival, then copies the rows it needs (a TMA copy a
// stream's row, completing on the buffer's mbarrier) in chunks of rt
// streams into a ring of two buffers in shared memory, the next chunk in
// flight while the block runs the one before.
// Each thread's 32-term chains go into shared memory as partial sums; a
// thread a (stream, unit) adds a column's 16 blocks in block order from
// 0 and runs the unit's update: dot_cols' float, as in every layout.

// the layouts, as the launch functions take them
#define MODE_ONE 0   // the one-block layout
#define MODE_REG 1   // the register layout
#define MODE_GRID 2  // the grid layout

#define GRID_NT 256   // threads a block
#define GRID_UPB 16   // units a block
#define GRID_NKB 16   // 32-term blocks of a W-term sum

// whether the grid layout takes width W: 16 blocks of 32 terms, so that
// a half-warp's lanes are the 16 blocks of one sum
__host__ __device__ inline bool grid_width_ok(int W) {
  return W == GRID_NKB * KCH;
}

#define GRID_SMEM_MAX 232448  // dynamic shared memory a block may ask

// The grid layout's streams a staged chunk: min(rb, rt_max), halved
// while a block's plan (smem(rt) bytes) exceeds what a block may ask
// (ops/scan_layout.py grid_layout_for).
template <typename Plan>
static inline int grid_chunk_rows(int rb, int rt_max, Plan smem) {
  int rt = rb < rt_max ? rb : rt_max;
  while (rt > 1 && smem(rt) > GRID_SMEM_MAX) rt /= 2;
  return rt;
}

// ---- staging by the Tensor Memory Accelerator ----
//
// The rows a step reads, viewed as a 2-D tensor of 32-float (128-byte)
// blocks, (blocks, 32): one TMA copy brings a stream's row (a box of its
// blocks) into shared memory, swizzled by 128 bytes: 16-byte chunk j of
// block i lands at i*128 + (j ^ (i % 8))*16 from a 1024-byte aligned
// start, so the float4 loads of a half-warp's 16 blocks (lanes kb, and i
// % 8 = kb % 8) fall into distinct banks, as padding the rows would.

// the float4 of terms 4j .. 4j+3 of a staged 32-term block `blk` whose
// block index is i (mod 8: sw)
__device__ __forceinline__ float4 swz_ld4(const float* blk, int j, int sw) {
  return *reinterpret_cast<const float4*>(blk + 4 * (j ^ sw));
}

// the dynamic shared memory from its first 1024-byte boundary (the plans
// ask 1024 bytes more)
__device__ __forceinline__ float* grid_smem(float4* base) {
  const unsigned a = smem_addr(base);
  return reinterpret_cast<float*>(base) + ((1024u - (a & 1023u)) & 1023u) / 4;
}

// Stage rc stream rows (row r: the box at block row0 + r * per of tm,
// per blocks) into buf (row r at buf + r * per * 32), completing on bar:
// thread 0 arms bar for the rows' bytes, thread r < rc issues row r's
// copy.  Every thread of the block calls this, after a barrier that
// ends every read of buf.
__device__ __forceinline__ void grid_stage_rows(float* buf,
                                                const CUtensorMap* tm,
                                                int row0, int per, int rc,
                                                uint64_t* bar) {
  if (threadIdx.x == 0) mbar_expect(bar, 128u * per * rc);
  if (threadIdx.x < rc) {
    // order the block's reads of buf and the rows' writes by other
    // blocks (generic proxy, acquired through the group's counter)
    // before the copy (async proxy)
    asm volatile("fence.proxy.async;\n" ::: "memory");
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
            smem_addr(buf + threadIdx.x * per * KCH)),
        "l"(reinterpret_cast<uint64_t>(tm)), "r"(0),
        "r"(row0 + (int)threadIdx.x * per), "r"(smem_addr(bar))
        : "memory");
  }
}

// The tensor map of `n_blocks` 32-float blocks at base (16-byte
// aligned), boxes of `per` blocks, 128-byte swizzle, encoded by the
// driver's cuTensorMapEncodeTiled (found through the runtime, so the
// library needs no link to the driver); returns a CUDA error code.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);
// The driver's cuTensorMapEncodeTiled in *encode; returns a CUDA error
// code.
static inline int encode_tiled(EncodeTiled* encode) {
  static EncodeTiled found_fn = nullptr;
  if (found_fn == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return (int)cudaErrorNotSupported;
    found_fn = reinterpret_cast<EncodeTiled>(fn);
  }
  *encode = found_fn;
  return 0;
}
static inline int encode_rows(CUtensorMap* tm, const float* base,
                              size_t n_blocks, int per) {
  EncodeTiled encode;
  const int e = encode_tiled(&encode);
  if (e != 0) return e;
  const cuuint64_t dims[2] = {KCH, n_blocks > 0 ? n_blocks : 1};
  const cuuint64_t strides[1] = {KCH * sizeof(float)};
  const cuuint32_t box[2] = {KCH, (cuuint32_t)per};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(
      tm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The cooperative launch of kern(args...) over `blocks` blocks of
// GRID_NT threads (every block resident at once, or the launch fails).
template <typename Kern, typename... Args>
static int grid_launch(Kern kern, int blocks, size_t smem,
                       cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  void* params[] = {(void*)&args...};
  err = cudaLaunchCooperativeKernel((const void*)kern, dim3(blocks),
                                    dim3(GRID_NT), params, smem, stream);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
