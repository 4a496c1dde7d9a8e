// The wide layout of the LSTM forward scan (lstm_scan.cu) and of the
// backward's chain (lstm_bwd.cu), for widths no other layout takes (W >
// 512; host side: ops/scan_layout.py wide_layout_for).
//
// What bounds a step there.  At W = 1840, U is W x 4W x 4 bytes = 54 MB:
// more than the registers and shared memory of every SM together can
// hold beside the rows, and more than the 50 MB L2.  A step's product
// for 128 streams is 2 x 128 x W x 4W = 3.47 GFLOP, 52 us at the f32
// peak, against 16 us to stream U from HBM: the step is bound by the
// CUDA cores, and it needs the whole card, with one dependency across
// every block a step.
//
// What the design does about it.  One block an SM (a cooperative
// launch), WIDE_NT threads.  Each step is a product of every stream's
// row (A: B x K, K = W terms) with the block's 64 packed columns of U
// (B: K x 64), tiled over the block's threads: thread (rg, cq) sums rows
// rg, rg + 16, ..., rg + 112 and the four columns 4cq .. 4cq + 3, 32
// sums in registers.  A and B come into shared memory in chunks of 32
// terms by TMA (A: a tensor map of the rows in device memory, one box of
// 32 terms x B rows with a 128-byte swizzle, terms past W read as zero;
// B: one bulk copy of the packed columns, zero past W), through a ring
// of WIDE_ST stages whose mbarriers complete on the copies' bytes; each
// 32-term chunk is a fresh FMA chain per sum, added to the sum's total
// in chunk order: dot_cols' float (lstm_common.cuh).  The rows a step
// writes cross the blocks through device memory, behind the launch's
// one counter (cluster_common.cuh group_arrive / group_wait over all
// blocks).  U is packed once a launch by a kernel of its own, so that a
// block's columns of a 32-term chunk are one contiguous copy.
#pragma once

#include "scan_common.cuh"

#define WIDE_NT 256   // threads a block: 16 row groups x 16 column quads
#define WIDE_NC 64    // columns a block: 16 quads of 4
#define WIDE_RB 128   // streams at most: 16 row groups of 8
#define WIDE_RPT 8    // rows a thread
#define WIDE_ST 8     // stages of the ring

// bytes of one stage: room for the A box of WIDE_RB rows of 128 bytes
// (every thread reads its 8 rows, those past B too, whose values it
// drops), then the B chunk (32 x 64)
#define WIDE_A_BYTES (WIDE_RB * 128)
#define WIDE_STAGE_BYTES (WIDE_A_BYTES + KCH * WIDE_NC * 4)
// dynamic shared memory of a block, whatever B: 1024 bytes to align the
// ring, the ring and its mbarriers (ops/scan_layout.py WIDE_SMEM)
#define WIDE_SMEM_BYTES (1024 + WIDE_ST * WIDE_STAGE_BYTES + WIDE_ST * 8)
static_assert(WIDE_NT == GRID_NT, "grid_launch runs GRID_NT threads");
// 32-term chunks of a W-term sum, the last one padded with zeros
__host__ __device__ inline int wide_chunks(int W) {
  return (W + KCH - 1) / KCH;
}

// The tensor map of a (rows, n4, cols) f32 array at base (cols
// contiguous, a row of n4 x cols floats): boxes of 32 columns x 1 x
// box_rows rows, 128-byte swizzle, columns past cols read as zeros;
// returns a CUDA error code.
static inline int encode_wide(CUtensorMap* tm, const float* base,
                              size_t rows, int n4, int cols, int box_rows) {
  EncodeTiled encode;
  const int e = encode_tiled(&encode);
  if (e != 0) return e;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)n4,
                              rows > 0 ? rows : 1};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * sizeof(float),
                                 (cuuint64_t)n4 * cols * sizeof(float)};
  const cuuint32_t box[3] = {KCH, 1, (cuuint32_t)box_rows};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(
      tm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(base), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The ring of one block: stage s at ring + s * WIDE_STAGE_BYTES (A box,
// then the B chunk), its mbarrier bar[s]; B rows a box.
struct WideRing {
  char* ring;
  uint64_t* bar;
  int B;
};

__device__ __forceinline__ WideRing wide_ring(float4* smem, int B) {
  WideRing w;
  w.ring = reinterpret_cast<char*>(grid_smem(smem));
  w.B = B;
  w.bar = reinterpret_cast<uint64_t*>(w.ring + WIDE_ST * WIDE_STAGE_BYTES);
  if (threadIdx.x == 0) {
    for (int s = 0; s < WIDE_ST; ++s) mbar_init(w.bar + s);
    mbar_init_fence();
  }
  __syncthreads();
  return w;
}

// Thread 0: chunk kb of a step into stage s: the A box at (32 kb, q,
// row0) of tm and the packed columns' 32 x 64 floats at bsrc.
__device__ __forceinline__ void wide_issue(const WideRing& w, int s,
                                           const CUtensorMap* tm, int kb,
                                           int q, int row0,
                                           const float* bsrc) {
  char* st = w.ring + s * WIDE_STAGE_BYTES;
  const unsigned bar = smem_addr(w.bar + s);
  mbar_expect(w.bar + s, 128u * w.B + KCH * WIDE_NC * 4);
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          smem_addr(st)),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(kb * KCH), "r"(q), "r"(row0),
      "r"(bar)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(st + WIDE_A_BYTES)),
      "l"(bsrc + (size_t)kb * KCH * WIDE_NC), "r"(KCH * WIDE_NC * 4),
      "r"(bar)
      : "memory");
}

// One step's product of the block: tot[i][j] = the sum over the W terms
// (nkb chunks) of row rg + 16 i of the A operand (rows row0 .. row0 + B
// of tm at (., q, .)) and packed column 4 cq + j of bp (nkb x 32 rows of
// 64), each chunk a fresh FMA chain in term order added to tot in chunk
// order; rows rounded to bf16 first when Q.  `it` counts the chunks the
// block has consumed (the ring's position and phase).  Every thread of
// the block calls this; thread 0 fills the ring.
template <bool Q>
__device__ __forceinline__ void wide_product(const WideRing& w,
                                             const CUtensorMap* tm, int q,
                                             int row0, const float* bp,
                                             int nkb, unsigned& it,
                                             float (&tot)[WIDE_RPT][4]) {
  const int cq = threadIdx.x & 15, rg = threadIdx.x >> 4;
  const int sw = rg & 7;  // the swizzle of the thread's rows
  if (threadIdx.x == 0) {
    // order the block's reads of the ring and the rows' writes by other
    // blocks (generic proxy, acquired through the counter) before the
    // copies (async proxy)
    asm volatile("fence.proxy.async;\n" ::: "memory");
    for (int j = 0; j < WIDE_ST && j < nkb; ++j)
      wide_issue(w, (it + j) % WIDE_ST, tm, j, q, row0, bp);
  }
#pragma unroll
  for (int i = 0; i < WIDE_RPT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) tot[i][j] = 0.0f;
  for (int kb = 0; kb < nkb; ++kb, ++it) {
    const int s = it % WIDE_ST;
    mbar_wait(w.bar + s, (it / WIDE_ST) & 1u);
    const char* st = w.ring + s * WIDE_STAGE_BYTES;
    const float* as = reinterpret_cast<const float*>(st);
    const float4* bs = reinterpret_cast<const float4*>(st + WIDE_A_BYTES);
    float acc[WIDE_RPT][4];
#pragma unroll
    for (int i = 0; i < WIDE_RPT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll
    for (int k4 = 0; k4 < KCH / 4; ++k4) {
      float4 a[WIDE_RPT];
#pragma unroll
      for (int i = 0; i < WIDE_RPT; ++i) {
        a[i] = swz_ld4(as + (rg + 16 * i) * KCH, k4, sw);
        if (Q)
          a[i] = make_float4(round_bf16(a[i].x), round_bf16(a[i].y),
                             round_bf16(a[i].z), round_bf16(a[i].w));
      }
      float4 b[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) b[k] = bs[(4 * k4 + k) * 16 + cq];
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int i = 0; i < WIDE_RPT; ++i) {
          const float x = k == 0   ? a[i].x
                          : k == 1 ? a[i].y
                          : k == 2 ? a[i].z
                                   : a[i].w;
          acc[i][0] = fmaf(x, b[k].x, acc[i][0]);
          acc[i][1] = fmaf(x, b[k].y, acc[i][1]);
          acc[i][2] = fmaf(x, b[k].z, acc[i][2]);
          acc[i][3] = fmaf(x, b[k].w, acc[i][3]);
        }
    }
#pragma unroll
    for (int i = 0; i < WIDE_RPT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) tot[i][j] += acc[i][j];
    __syncthreads();  // every thread is done with stage s
    if (threadIdx.x == 0 && kb + WIDE_ST < nkb)
      wide_issue(w, s, tm, kb + WIDE_ST, q, row0, bp);
  }
}
