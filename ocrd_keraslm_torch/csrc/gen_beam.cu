// Generation beam search for Hopper (sm_90a): every step of one or more
// streams (prompts) in one launch.
//
// Replaces the TPU kernel ocrd_keraslm_tpu/ops/gen_kernel.py::
// _gen_pallas_raw (_make_gen_kernel).  Same semantics, per step and
// stream: the D-layer LSTM over the K fringe rows [xemb | h.. | c..], the
// tied-softmax logsumexp over the v_real real columns, each row's exact
// top TOPK logits (equal logits: smaller char id first), candidate cost
// cost + max(lse - logit, 0), dead (BIG) below log_thresh or under a dead
// parent, the char-0 candidate removed by shifting the row's tail left;
// then the exact K smallest of the K*TOPK candidates by (cost, row-major
// index), emitted in row-major order, each slot's record (char, source
// row, cost) and its next state [emb[char] | h, c of the source row].
//
// What bounds it on this card: the f32 gate products.  A step of the
// german model (D=2, W=128, K=256) is 2*K*(D*2W*4W + W*v_real) = 1.39e8
// FLOP, 2.1 us at the card's 67 TFLOP/s, but the steps are sequential and
// a step is too small to spread over all 132 SMs with a grid-wide barrier.
// One SM alone would need >= 272 us a step.
//
// What the design does about it:
//  * one thread-block cluster per stream, persistent over the T steps, of
//    16 blocks (K/16 fringe rows each) where the card holds a 16-block
//    cluster for every stream of the launch, else of 8 (the wrapper
//    decides from the card's cluster occupancy: 16-block clusters run a
//    step faster, 8-block ones fit the card twice as often);
//  * block c owns fringe rows [c*R, (c+1)*R) in shared memory; a thread
//    computes a tile of 8 rows x 4 gate columns (16-byte weight loads
//    from L2 feed 32 FMAs, shared memory delivers 8 x values per column),
//    each dot product summed in blocks of 32 terms (KCH, lstm_common.cuh)
//    as the other kernels of the port do;
//  * a row's top TOPK logits by rank counting within one warp;
//  * after one cluster barrier every block copies all K*TOPK candidates
//    from the cluster's shared memory (distributed shared memory), one
//    warp finds the K-th smallest cost by bisection on the float bits
//    (costs are >= 0, so their bits order as the floats do), and the
//    block fills its own R output slots: the record, the cost, and the
//    next state, gathered from the source row's block through
//    distributed shared memory into the fringe buffer in device memory
//    (double-buffered, L2-resident; each block reads back only its own
//    rows);
//  * a second cluster barrier ends the step, so no block overwrites rows
//    or candidates another block still reads;
//  * N streams are N clusters of one launch.
// All arithmetic is f32 on CUDA cores; the gate update rounds as the
// plain version does (lstm_common.cuh).

#include <cooperative_groups.h>

#include "lstm_common.cuh"

namespace cg = cooperative_groups;

#define NT 512           // threads per block
#define NW (NT / 32)     // warps per block
#define MAX_TOPK 32      // candidates per row: one lane each
#define BIGF 3.0e38f

struct Params {
  const float* emb;     // (Vp, W)
  const float* embT;    // (W, Vp)
  const float* wcat;    // (D, 2W, 4W)
  const float* bias;    // (D, 4W)
  const float* state0;  // (N, K, S)
  const float* cost0;   // (N, K)
  float* rec;           // (N, T, 3, K)
  float* scratch;       // (2, N, K, S)
  int N, T, K, D, W, Vp, v_real, topk;
  float log_thresh;
};

// Shared memory plan of a block with room for RB >= R rows; offsets in
// 4-byte words, every array 16-byte aligned.
struct Plan {
  int xs, zb, cost, ccost, cchar, allc, allch, less, eq, lpfx, epfx,
      srow, scol, misc, total;
};

__host__ __device__ static inline int align4(int n) { return (n + 3) & ~3; }

__host__ __device__ static inline Plan make_plan(int RB, int K, int D, int W,
                                                 int Vp, int topk) {
  const int S = (2 * D + 1) * W;
  const int G = 4 * W > Vp ? 4 * W : Vp;
  Plan p;
  int o = 0;
  p.xs = o;    o += align4(RB * S);          // own rows, in place
  p.zb = o;    o += align4(RB * G);          // gates, then logits
  p.cost = o;  o += align4(RB);              // own slots' costs
  p.ccost = o; o += align4(RB * topk);       // own rows' candidates
  p.cchar = o; o += align4(RB * topk);
  p.allc = o;  o += align4(K * topk);        // every row's candidates
  p.allch = o; o += align4(K * topk);
  p.less = o;  o += align4(K);               // per-row counts and their
  p.eq = o;    o += align4(K);               // exclusive prefix sums
  p.lpfx = o;  o += align4(K);
  p.epfx = o;  o += align4(K);
  p.srow = o;  o += align4(RB);              // each own slot's source
  p.scol = o;  o += align4(RB);
  p.misc = o;  o += 4;
  p.total = o;
  return p;
}

// rows per block rounded up to the templates' row counts
static inline int rows_cap(int R) { return R <= 8 ? 8 : (R <= 16 ? 16 : 32); }

// out[r * ncols + j] = sum_i x[r * xs + i] * w[i * ncols + j] (+ b[j])
// for the RB rows of x and the columns j < jcols.  A thread takes a tile
// of TR rows by TC columns: per 4 terms it reads TC-wide weight rows
// (one 16-byte load each, coalesced over the warp) and TR 16-byte x rows
// from shared memory (the same for the whole warp: a broadcast), so
// shared memory delivers TR, not RB, x values per FMA column.  Each sum
// runs in blocks of KCH terms, in the order of dot_cols
// (lstm_common.cuh), so the values equal the column-per-thread product.
#define TC 4
template <int RB, int TR>
__device__ void tile_cols(const float* __restrict__ x, int xs, int n,
                          const float* __restrict__ w, int ncols, int jcols,
                          const float* __restrict__ b, float* out) {
  const int ngroups = (jcols + TC - 1) / TC;
  for (int t = threadIdx.x; t < ngroups * (RB / TR); t += NT) {
    const int j = (t % ngroups) * TC, r0 = (t / ngroups) * TR;
    float tot[TR][TC];
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int c = 0; c < TC; ++c) tot[r][c] = 0.0f;
    for (int i0 = 0; i0 < n; i0 += KCH) {
      float acc[TR][TC];
#pragma unroll
      for (int r = 0; r < TR; ++r)
#pragma unroll
        for (int c = 0; c < TC; ++c) acc[r][c] = 0.0f;
      const int i1 = min(i0 + KCH, n);
      for (int i = i0; i < i1; i += 4) {
        float4 wv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          wv[q] = __ldg(reinterpret_cast<const float4*>(
              w + (size_t)(i + q) * ncols + j));
#pragma unroll
        for (int r = 0; r < TR; ++r) {
          const float4 xv =
              *reinterpret_cast<const float4*>(x + (r0 + r) * xs + i);
          const float xq[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[r][0] = fmaf(xq[q], wv[q].x, acc[r][0]);
            acc[r][1] = fmaf(xq[q], wv[q].y, acc[r][1]);
            acc[r][2] = fmaf(xq[q], wv[q].z, acc[r][2]);
            acc[r][3] = fmaf(xq[q], wv[q].w, acc[r][3]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < TR; ++r)
#pragma unroll
        for (int c = 0; c < TC; ++c) tot[r][c] += acc[r][c];
    }
#pragma unroll
    for (int c = 0; c < TC; ++c) {
      if (j + c >= jcols) break;
      const float bc = b ? __ldg(b + j + c) : 0.0f;
#pragma unroll
      for (int r = 0; r < TR; ++r)
        out[(r0 + r) * ncols + j + c] = tot[r][c] + bc;
    }
  }
}

// One LSTM stack step of the block's RB rows in xs (in place: xs keeps
// xemb and gets the new h and c), then the logits of the top layer's h
// over the v_real real columns into zb (row stride Vp).
template <int RB>
__device__ void rows_step(const Params& p, int R, float* xs, float* zb) {
  const int W = p.W, D = p.D, S = (2 * D + 1) * W, G = 4 * W;
  for (int d = 0; d < D; ++d) {
    tile_cols<RB, 8>(xs + d * W, S, 2 * W, p.wcat + (size_t)d * 2 * W * G,
                     G, G, p.bias + d * G, zb);
    __syncthreads();
    for (int idx = threadIdx.x; idx < R * W; idx += NT) {
      const int r = idx / W, u = idx - (idx / W) * W;
      float* row = xs + r * S;
      const float2 hc = lstm_unit(zb + r * G, W, u, row[(1 + D + d) * W + u]);
      row[(1 + d) * W + u] = hc.x;
      row[(1 + D + d) * W + u] = hc.y;
    }
    __syncthreads();
  }
  // few columns: tiles of 2 rows, so that more threads share the work
  tile_cols<RB, 2>(xs + D * W, S, W, p.embT, p.Vp, p.v_real, nullptr, zb);
  __syncthreads();
}

// Row r's candidates (one warp): logsumexp, the exact top TOPK logits,
// costs and masks, the char-0 shift.  A logit's place in the top list is
// its rank in the order (logit descending, char id ascending): the
// number of logits before it in that order.
__device__ void row_candidates(const Params& p, const float* lg, float cost,
                               float* ccost, int* cchar) {
  const int lane = threadIdx.x & 31;
  const int TOPK = p.topk;
  float mx = -INFINITY;
  for (int v = lane; v < p.v_real; v += 32) mx = fmaxf(mx, lg[v]);
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  float sum = 0.0f;
  for (int v = lane; v < p.v_real; v += 32) sum += expf(lg[v] - mx);
  for (int o = 16; o > 0; o >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
  const float lse = mx + logf(sum);
  for (int v = lane; v < p.v_real; v += 32) {
    const float x = lg[v];
    int rank = 0;
    for (int u = 0; u < p.v_real; ++u) {
      const float y = lg[u];
      rank += (y > x) || (y == x && u < v);
    }
    if (rank < TOPK) {  // the row's candidate arrays hold the list first
      ccost[rank] = x;
      cchar[rank] = v;
    }
  }
  __syncwarp();
  float val = 0.0f;
  int idx = 0;
  if (lane < TOPK) {
    val = ccost[lane];
    idx = cchar[lane];
  }
  __syncwarp();
  float cand = BIGF;
  if (lane < TOPK) {
    cand = __fadd_rn(cost, fmaxf(__fsub_rn(lse, val), 0.0f));
    if (__fsub_rn(val, lse) < p.log_thresh) cand = BIGF;
    if (cost >= BIGF * 0.5f) cand = BIGF;
  }
  const unsigned zero = __ballot_sync(0xffffffffu, lane < TOPK && idx == 0);
  const int pos0 = zero ? __ffs(zero) - 1 : TOPK;
  const float next_c = __shfl_down_sync(0xffffffffu, cand, 1);
  const int next_i = __shfl_down_sync(0xffffffffu, idx, 1);
  if (lane >= pos0) {
    cand = lane == TOPK - 1 ? BIGF : next_c;
    idx = lane == TOPK - 1 ? 0 : next_i;
  }
  if (lane < TOPK) {
    ccost[lane] = fminf(cand, BIGF);
    cchar[lane] = idx;
  }
}

template <int RB>
__global__ void __launch_bounds__(NT, 1) gen_beam_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = p.K, TOPK = p.topk, KT = K * TOPK, W = p.W;
  const int CLn = (int)cluster.num_blocks();
  const int S = (2 * p.D + 1) * W, R = K / CLn;
  const int c = (int)cluster.block_rank();
  const int n = blockIdx.x / CLn;
  const int r0 = c * R;
  const Plan pl = make_plan(RB, K, p.D, W, p.Vp, TOPK);
  float* xs = sm + pl.xs;
  float* zb = sm + pl.zb;
  float* cost = sm + pl.cost;
  float* ccost = sm + pl.ccost;
  int* cchar = reinterpret_cast<int*>(sm + pl.cchar);
  float* allc = sm + pl.allc;
  int* allch = reinterpret_cast<int*>(sm + pl.allch);
  int* less = reinterpret_cast<int*>(sm + pl.less);
  int* eq = reinterpret_cast<int*>(sm + pl.eq);
  int* lpfx = reinterpret_cast<int*>(sm + pl.lpfx);
  int* epfx = reinterpret_cast<int*>(sm + pl.epfx);
  int* srow = reinterpret_cast<int*>(sm + pl.srow);
  int* scol = reinterpret_cast<int*>(sm + pl.scol);
  int* misc = reinterpret_cast<int*>(sm + pl.misc);
  const size_t fringe = (size_t)K * S;  // one stream's fringe state
  const size_t buf = (size_t)p.N * fringe;

  // pad rows (R..RB-1) stay zero: the row loops read them, nothing
  // writes them
  for (int i = tid; i < RB * S; i += NT) xs[i] = 0.0f;
  for (int i = tid; i < R; i += NT) cost[i] = p.cost0[(size_t)n * K + r0 + i];
  __syncthreads();

  for (int t = 0; t < p.T; ++t) {
    const float* in = (t == 0 ? p.state0 : p.scratch + ((t - 1) & 1) * buf) +
                      n * fringe + (size_t)r0 * S;
    float* out = p.scratch + (t & 1) * buf + n * fringe + (size_t)r0 * S;
    const float4* in4 = reinterpret_cast<const float4*>(in);
    float4* xs4 = reinterpret_cast<float4*>(xs);
    for (int i = tid; i < R * S / 4; i += NT) xs4[i] = in4[i];
    __syncthreads();

    // ---- the block's rows: LSTM stack, logits, candidates ----
    rows_step<RB>(p, R, xs, zb);
    for (int r = warp; r < R; r += NW)
      row_candidates(p, zb + r * p.Vp, cost[r], ccost + r * TOPK,
                     cchar + r * TOPK);
    cluster.sync();  // every block's candidates are ready

    // ---- all K*TOPK candidates, from the cluster's shared memory ----
    for (int i = tid; i < KT; i += NT) {
      const int b = i / (R * TOPK), o = i - b * R * TOPK;
      allc[i] = cluster.map_shared_rank(ccost, b)[o];
      allch[i] = cluster.map_shared_rank(cchar, b)[o];
    }
    __syncthreads();

    // ---- the K-th smallest cost: bisection on the float bits, in one
    // warp (no block barriers), between the smallest candidate and the
    // largest of the rows' first candidates (K candidates lie at or
    // below it) ----
    if (warp == 0) {
      unsigned lo = 0xffffffffu, hi = 0u;
      for (int i = lane; i < KT; i += 32)
        lo = min(lo, __float_as_uint(allc[i]));
      for (int r = lane; r < K; r += 32)
        hi = max(hi, __float_as_uint(allc[r * TOPK]));
      lo = __reduce_min_sync(0xffffffffu, lo);
      hi = __reduce_max_sync(0xffffffffu, hi);
      while (lo < hi) {
        const unsigned mid = lo + ((hi - lo) >> 1);
        unsigned cnt = 0u;
        for (int i = lane; i < KT; i += 32)
          cnt += __float_as_uint(allc[i]) <= mid;
        if (__reduce_add_sync(0xffffffffu, cnt) >= (unsigned)K)
          hi = mid;
        else
          lo = mid + 1;
      }
      if (lane == 0) misc[1] = (int)lo;
    }
    __syncthreads();
    const unsigned thr = (unsigned)misc[1];

    // ---- per-row counts below and at the threshold, their prefixes ----
    for (int r = tid; r < K; r += NT) {
      int nl = 0, ne = 0;
      for (int k = 0; k < TOPK; ++k) {
        const unsigned u = __float_as_uint(allc[r * TOPK + k]);
        nl += u < thr;
        ne += u == thr;
      }
      less[r] = nl;
      eq[r] = ne;
    }
    __syncthreads();
    if (warp == 0) {  // exclusive scans over the K rows, one warp
      const int per = (K + 31) / 32, lo_r = lane * per;
      const int hi_r = min(lo_r + per, K);
      int sl = 0, se = 0;
      for (int r = lo_r; r < hi_r; ++r) {
        sl += less[r];
        se += eq[r];
      }
      int il = sl, ie = se;  // inclusive scans of the lane sums
      for (int o = 1; o < 32; o <<= 1) {
        const int ul = __shfl_up_sync(0xffffffffu, il, o);
        const int ue = __shfl_up_sync(0xffffffffu, ie, o);
        if (lane >= o) {
          il += ul;
          ie += ue;
        }
      }
      int al = il - sl, ae = ie - se;
      for (int r = lo_r; r < hi_r; ++r) {
        lpfx[r] = al;
        epfx[r] = ae;
        al += less[r];
        ae += eq[r];
      }
      if (lane == 31) misc[0] = il;  // candidates below the threshold
    }
    __syncthreads();

    // ---- compaction: selected candidates in row-major order; slot s
    // is the s-th selected; this block fills slots [r0, r0 + R) ----
    const int need = K - misc[0];  // taken from those at the threshold
    for (int r = tid; r < K; r += NT) {
      int slot = lpfx[r] + min(epfx[r], need), seen_eq = 0;
      for (int k = 0; k < TOPK && slot < r0 + R; ++k) {
        const unsigned u = __float_as_uint(allc[r * TOPK + k]);
        const bool at = u == thr;
        const bool sel = u < thr || (at && epfx[r] + seen_eq < need);
        seen_eq += at;
        if (sel) {
          if (slot >= r0) {
            srow[slot - r0] = r;
            scol[slot - r0] = k;
          }
          ++slot;
        }
      }
    }
    __syncthreads();

    // ---- own slots: record, cost, next state ----
    float* rec = p.rec + ((size_t)n * p.T + t) * 3 * K;
    for (int i = tid; i < R; i += NT) {
      const int f = srow[i] * TOPK + scol[i];
      rec[r0 + i] = (float)allch[f];
      rec[K + r0 + i] = (float)srow[i];
      rec[2 * K + r0 + i] = allc[f];
      cost[i] = allc[f];
    }
    float4* out4 = reinterpret_cast<float4*>(out);
    for (int q = tid; q < R * S / 4; q += NT) {
      const int i = q / (S / 4), e = (q - i * (S / 4)) * 4;
      const int r = srow[i];
      float4 v;
      if (e < W) {
        const int ch = allch[srow[i] * TOPK + scol[i]];
        v = __ldg(reinterpret_cast<const float4*>(p.emb + (size_t)ch * W + e));
      } else {
        const float* src = cluster.map_shared_rank(xs, r / R);
        v = *reinterpret_cast<const float4*>(src + (r % R) * S + e);
      }
      out4[q] = v;
    }
    cluster.sync();  // rows and candidates may be overwritten now
  }
}

static cudaLaunchConfig_t config(int cl, int N, size_t smem,
                                 cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl * N);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cl;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Launch (or, with `fits`, count how many clusters of cl blocks the card
// holds at once into *fits) for blocks of RB rows.
template <int RB>
static int launch_cl(int cl, const Params& p, size_t smem,
                     cudaStream_t stream, int* fits) {
  cudaError_t err = cudaFuncSetAttribute(
      gen_beam_kernel<RB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err == cudaSuccess && cl > 8)  // 16 blocks exceed the portable 8
    err = cudaFuncSetAttribute(gen_beam_kernel<RB>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = config(cl, p.N, smem, stream, &attr);
  if (fits) return (int)cudaOccupancyMaxActiveClusters(fits,
                                                        gen_beam_kernel<RB>,
                                                        &cfg);
  err = cudaLaunchKernelEx(&cfg, gen_beam_kernel<RB>, p);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

static int launch_rb(int cl, const Params& p, cudaStream_t stream,
                     int* fits) {
  if (p.K % cl || p.K / cl > 32 || p.topk < 1 || p.topk > MAX_TOPK ||
      p.v_real > p.Vp || p.W % 4 || p.Vp % 4)
    return (int)cudaErrorInvalidValue;
  const int R = p.K / cl, RB = rows_cap(R);
  const size_t smem =
      (size_t)make_plan(RB, p.K, p.D, p.W, p.Vp, p.topk).total * 4;
  switch (RB) {
    case 8:
      return launch_cl<8>(cl, p, smem, stream, fits);
    case 16:
      return launch_cl<16>(cl, p, smem, stream, fits);
    default:
      return launch_cl<32>(cl, p, smem, stream, fits);
  }
}

extern "C" size_t gen_beam_smem_bytes(int K, int cl, int D, int W, int Vp,
                                      int topk) {
  return (size_t)make_plan(rows_cap(K / cl), K, D, W, Vp, topk).total * 4;
}

// How many clusters of cl blocks fit the card at once (0 if none).
extern "C" int gen_beam_max_clusters(int cl, int K, int D, int W, int Vp,
                                     int topk) {
  Params p{};
  p.N = 1, p.K = K, p.D = D, p.W = W, p.Vp = Vp, p.v_real = Vp;
  p.topk = topk;
  int fits = 0;
  return launch_rb(cl, p, 0, &fits) == 0 ? fits : 0;
}

extern "C" int gen_beam_launch(const float* emb, const float* embT,
                               const float* wcat, const float* bias,
                               const float* state0, const float* cost0,
                               float* rec, float* scratch, int cl, int N,
                               int T, int K, int D, int W, int Vp,
                               int v_real, int topk, float log_thresh,
                               void* stream) {
  if (cl != 8 && cl != 16) return (int)cudaErrorInvalidValue;
  Params p{emb, embT, wcat, bias, state0, cost0, rec, scratch, N, T,
           K,   D,    W,    Vp,   v_real, topk,  log_thresh};
  return launch_rb(cl, p, (cudaStream_t)stream, nullptr);
}
