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
// What bounds it on this card: the f32 gate products of a step, and the
// steps are sequential.  A step of the german model (D=2, W=128, K=256,
// v_real=70) is K*(D*2W*4W + W*v_real) = 6.94e7 FMAs: 2.1 us at the whole
// card's 67 TFLOP/s.  One thread-block cluster holds at most 16 SMs; on 16
// SMs of 128 FMA/clk a step is >= 33.9k cycles, 17-20 us.  So a launch of
// few streams spreads a stream's rows over G clusters (row groups), and
// the step's candidates cross the clusters through L2 behind a counter.
// A block's gate products then shrink with G, and what bounds a step is
// what they leave: the part every block repeats whatever G (the selection
// of the K best of all K*TOPK candidates, the counter's round trip) and
// the clusters the card holds at once (an H100 SXM holds 15 of 8 blocks,
// 7 of 16: one german stream takes 8 groups of 8 blocks, 64 SMs, ~27 us a
// step, its gate products ~29% of it and the selection ~22%).
//
// Two layouts, persistent over the T steps, N streams in one launch; the
// wrapper chooses (ops/gen_kernel.choose: a cost model of a step times the
// waves of clusters):
//
//  * the unit layout (gen_beam_units_kernel), for D <= 2: a stream's K
//    rows in G row groups of K/G rows, one cluster each (G = 1: one
//    cluster a stream; G > 1 only where all N*G clusters are resident at
//    once, a cooperative launch).  The cluster is RH row halves of its
//    group by CL/RH unit groups; block (rh, ug) owns W/(CL/RH)
//    units and their gate columns of every layer, whose weights stay in
//    registers for all T steps: no weight is read from L2 inside the step
//    loop.  The rows' activations stream instead: each layer runs over the
//    half's rows in tiles copied by cp.async from L2 buffers of h and c
//    (every block writes its units' new h and c there; a cluster barrier
//    after each layer), 2W + W/(CL/RH) floats a row against the first
//    design's whole wcat a block and tile pass.  The beam's reorder is the
//    tiles' gather by source row, from any group.  Each block computes its
//    own K/(G*CL) rows' logits (embT's real columns in shared memory) and
//    candidates; every block then holds every candidate of the stream
//    (G = 1: copied through distributed shared memory after a cluster
//    barrier; G > 1: written to an L2 buffer by step parity, one arrival a
//    block on the stream's counter, read back after the wait) and finds
//    the K-th smallest with the whole block (a radix select of 8 bits a
//    pass on shared-memory histograms), then the slots of every row.
//    D + 1 cluster barriers a step (G > 1: D and the counter);
//  * the rows layout (gen_beam_kernel, the first design, one cluster a
//    stream, for shapes the unit layout does not take and where the cost
//    model rates it faster):
//    block c owns fringe rows [c*R, (c+1)*R) in shared memory; a thread
//    computes a tile of 8 rows x 4 gate columns (16-byte weight loads from
//    L2 feed 32 FMAs), a row's top TOPK by rank counting within one warp;
//    after a cluster barrier every block copies all K*TOPK candidates
//    through distributed shared memory, one warp finds the K-th smallest
//    cost by bisection on the float bits (costs are >= 0, so their bits
//    order as the floats do), and the block fills its own R output slots,
//    the next state gathered from the source row's block into a fringe
//    buffer in device memory (double-buffered, L2-resident); a second
//    cluster barrier ends the step.
// Every dot product is summed in blocks of 32 terms (KCH,
// lstm_common.cuh), the blocks added to 0 in order, and the logits in the
// same order in both layouts; so both give the same records bit for bit.
// All arithmetic is f32 on CUDA cores; the gate update rounds as the
// plain version does (lstm_common.cuh).

#include <cooperative_groups.h>

#include "cluster_common.cuh"
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

// ---- the unit layout ----
//
// A stream's K rows split into G row groups of KG = K/G rows, one cluster
// of CL blocks each (template GROUPS: G > 1; the G = 1 kernel is the
// one-cluster design unchanged).  A cluster is RH row halves (1 or 2) of
// its group by CU = CL/RH unit groups.  Block (rh, ug) owns the units
// [ug*upb, (ug+1)*upb) (upb = W/CU) and their four gate columns of every
// layer (NC = 4*upb columns), for the KH = KG/RH rows of its half.
// Roles: thread q < NROLE = NC/2*NKB2 of each thread group takes the
// column pair (q % (NC/2), q % (NC/2) + NC/2) and the 32-term block
// kb = q / (NC/2) of the columns' 2W terms [x | h];
// its 64 weights of that block, of every layer, sit in its registers for
// the whole search (read from wcat once, before the first step; 256
// threads a block leave 255 registers a thread).  A warp's lanes hold
// column pairs of one 32-term block (of two where NC/2 < 32), so one
// float4 of x, the same for the lanes of a block, feeds eight FMAs in
// every lane.  The NRG = UNT/NROLE thread groups split the rows of a
// tile.
//
// A layer runs over the block's rows in tiles of TR: the tile's [x | h]
// rows (2W floats each, 32-term blocks padded by 4 floats) and the own
// units' old c (three tiles' worth: tile i+1's arrive while tile i-1's
// gate updates read theirs) are copied from L2 into shared memory by
// cp.async while the tile before is computed; each thread's block sums go
// to shared memory (two tiles' worth), and one thread a (row, unit) adds
// the NKB2 block sums in block order (dot_cols' float), adds the bias and
// runs the gate update for the tile before, beside the products of the
// tile; half the warps do that before their products, half after.  The new h and c go to
// L2 buffers of the stream, hbuf and cbuf (2, D, K, W) by step parity,
// which the blocks read after a cluster barrier: h for the layer above and
// the own rows' logits, h and c gathered by source row for the next step
// (the beam's reorder).  The logits' weights (embT's real columns) sit in
// shared memory.
//
// The host computes the geometry and the shared-memory plan once and
// passes them with the launch (kernel parameters cost no registers).
#define UNT 256    // threads per block of the unit layout
#define UNW (UNT / 32)
#define URT 4      // rows one thread's chains take at once
#define UMAX_VCH 4 // 32-column chunks of a row's logits a lane holds

struct UGeo {
  int RH, CU, upb, NC, NKB2, NROLE, NRG, XP, PS, VR4;
};

__host__ __device__ inline UGeo make_ugeo(int W, int CL, int RH,
                                          int v_real) {
  UGeo g;
  g.RH = RH;
  g.CU = CL / RH;
  g.upb = W / g.CU;
  g.NC = 4 * g.upb;
  g.NKB2 = 2 * W / KCH;
  g.NROLE = g.NC / 2 * g.NKB2;
  g.NRG = UNT / g.NROLE;
  g.XP = 2 * W + 4 * g.NKB2 + 4;  // padded [x | h] row, +4: rows apart in banks
  g.PS = g.NC + g.upb;  // a block sum row: a warp's rows apart in banks
  g.VR4 = align4(v_real);  // embT's real columns in shared memory
  return g;
}

// the own rows a block computes logits and candidates of: R = K/(G*CL),
// rounded up to 8, 16 or 32 in the plan (the first design's row caps)
__host__ __device__ inline int own_rows_cap(int R) {
  return R <= 8 ? 8 : (R <= 16 ? 16 : 32);
}

// Shared memory plan of the unit layout; offsets in 4-byte words, every
// array 16-byte aligned.  xin holds the two staged tiles, then the own
// rows' top-layer h; cin three tiles' old c; part two tiles' block sums,
// then the own rows' logits.
struct UPlan {
  int xin, cin, part, bias, embs, cost, ccost, cchar, allc, allch, less, eq,
      lpfx, epfx, srow, scol, schar, hist, misc, total;
};

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

__host__ __device__ inline UPlan make_uplan(int K, int D, int W, int Vp,
                                            int v_real, int topk, int CL,
                                            int RH, int TR, int G) {
  const UGeo g = make_ugeo(W, CL, RH, v_real);
  const int RB = own_rows_cap(K / G / CL);
  UPlan p;
  int o = 0;
  p.xin = o;   o += align4(imax(2 * TR * g.XP, RB * W));
  p.cin = o;   o += align4(3 * TR * g.upb);      // the own units' old c
  p.part = o;  o += align4(imax(2 * g.NKB2 * TR * g.PS, RB * Vp));
  p.bias = o;  o += align4(D * g.NC);
  p.embs = o;  o += W * g.VR4;                  // embT's real columns
  p.cost = o;  o += align4(RB);                 // own rows' costs
  p.ccost = o; o += align4(RB * topk);          // own rows' candidates
  p.cchar = o; o += align4(RB * topk);
  p.allc = o;  o += align4(K * topk);           // every row's candidates
  p.allch = o; o += align4(K * topk);
  p.less = o;  o += align4(K);
  p.eq = o;    o += align4(K);
  p.lpfx = o;  o += align4(K);
  p.epfx = o;  o += align4(K);
  p.srow = o;  o += align4(K);                  // every slot's source row,
  p.scol = o;  o += align4(K);                  // candidate and char
  p.schar = o; o += align4(K);
  p.hist = o;  o += 256;                        // the radix select's counts
  p.misc = o;  o += 4;
  p.total = o;
  return p;
}

// Whether the unit layout takes the shape: K in G (1-16) row groups of
// KG = K/G rows, CL in 4, 8, 16 blocks of RH (1, 2) row halves by CL/RH
// unit groups, each W/(CL/RH) units, a multiple of 4 (16-byte copies of
// c), D <= 2 (a thread's weights of every layer in registers), 2W in
// 32-term blocks, the roles in UNT threads, tiles of TR rows (16 or 32)
// that split into URT-row chains, KG/RH a multiple of TR, KG a multiple
// of CL with at most 32 own rows a block, v_real <= 128 (a row's logits
// in UMAX_VCH registers a lane).
__host__ __device__ inline bool units_ok(int K, int D, int W, int CL, int RH,
                                         int TR, int v_real, int G) {
  if (G < 1 || G > 16 || K % G) return false;
  const int KG = K / G;
  if (!(CL == 4 || CL == 8 || CL == 16) || !(RH == 1 || RH == 2) ||
      D < 1 || D > 2 || W < CL / RH || W % (CL / RH) ||
      (W / (CL / RH)) % 4 || W % 16 || !(TR == 16 || TR == 32) ||
      KG % (RH * TR) || KG % CL || KG / CL > 32 || v_real > 32 * UMAX_VCH)
    return false;
  const UGeo g = make_ugeo(W, CL, RH, v_real);
  return g.NROLE <= UNT && g.NRG * (TR / g.NRG) == TR &&
         (TR / g.NRG) % URT == 0;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

struct UParams {
  float* hbuf;   // (N, 2, D, K, W): every row's h of a step, by parity
  float* cbuf;   // (N, 2, D, K, W): every row's c of a step, by parity
  float* fin;    // (N, K, S): the fringe after the last step, or null
  int TR;        // rows per staged tile
  UGeo g;        // the block's geometry and plan, from the host
  UPlan pl;
  // row groups (GROUPS only): clusters a stream, the candidates' L2
  // buffers (2, N, K*topk) by step parity, one counter a stream (zeroed)
  int G;
  float* xcost;
  int* xchar;
  unsigned* flags;
};

// Stage rows [s0, s0 + TR) of layer d's [x | h] into the padded tile xt
// and the own units' old c into ct: x = state0's xemb (t = 0), emb[char]
// (layer 0) or the layer below's new h (hcur); h and c = state0's (t = 0)
// or the source row's (hprv, cprv).  UNT/TR threads a row, each its row's
// sources once.  One cp.async group.
template <int D>
__device__ __forceinline__ void stage_tile(const Params& p, int n, int t,
                                           int d, int s0, int TR, int XP,
                                           int u0, int upb,
                                           const float* hcur,
                                           const float* hprv,
                                           const float* cprv,
                                           const int* srow, const int* schar,
                                           float* xt, float* ct) {
  const int W = p.W, K = p.K, S = (2 * D + 1) * W, tpr = UNT / TR;
  const int r = threadIdx.x / tpr, s = s0 + r, q = threadIdx.x - r * tpr;
  const float *xs, *hs, *cs;
  if (d > 0)
    xs = hcur + ((size_t)(d - 1) * K + s) * W;
  else if (t == 0)
    xs = p.state0 + ((size_t)n * K + s) * S;
  else
    xs = p.emb + (size_t)schar[s] * W;
  if (t == 0) {
    hs = p.state0 + ((size_t)n * K + s) * S + (1 + d) * W;
    cs = p.state0 + ((size_t)n * K + s) * S + (1 + D + d) * W;
  } else {
    const size_t src = (size_t)d * K + srow[s];
    hs = hprv + src * W;
    cs = cprv + src * W;
  }
  float* dst = xt + r * XP;
  for (int e = q * 4; e < 2 * W; e += 4 * tpr)
    cp_async16(dst + hpad(e), e < W ? xs + e : hs + (e - W));
  for (int e = q * 4; e < upb; e += 4 * tpr)
    cp_async16(ct + r * upb + e, cs + u0 + e);
  cp_async_commit();
}

// A thread's block chains for rows [j0, j1) of a staged tile: xb is its
// 32-term block of row 0 (rows XP apart), w its 32 weights of each of its
// two columns; out[j * PS] and out[j * PS + half] get row j's chains: a
// fresh chain of FMAs in term order (dot_cols' block), URT rows at once,
// one broadcast float4 of x feeding eight FMAs.
__device__ __forceinline__ void unit_products(const float* xb, int XP,
                                              const float (&w)[2][KCH],
                                              int j0, int j1, float* out,
                                              int PS, int half) {
  for (int j = j0; j < j1; j += URT) {
    float acc[2][URT];
#pragma unroll
    for (int r = 0; r < URT; ++r) acc[0][r] = acc[1][r] = 0.0f;
#pragma unroll
    for (int k = 0; k < KCH; k += 4) {
#pragma unroll
      for (int r = 0; r < URT; ++r) {
        const float4 xv =
            *reinterpret_cast<const float4*>(xb + (j + r) * XP + k);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float a = acc[c][r];
          a = fmaf(xv.x, w[c][k], a);
          a = fmaf(xv.y, w[c][k + 1], a);
          a = fmaf(xv.z, w[c][k + 2], a);
          a = fmaf(xv.w, w[c][k + 3], a);
          acc[c][r] = a;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < URT; ++r) {
      out[(j + r) * PS] = acc[0][r];
      out[(j + r) * PS + half] = acc[1][r];
    }
  }
}

// out[r * Vp + j] = row r of xh (R rows of W) times embT's column j < v_real
// (embs: (W, VR4) in shared memory), summed in blocks of KCH terms added to
// 0 in order, + 0 (tile_cols' values); a thread two rows and 4 columns,
// each weight float4 read once for both rows.
__device__ __forceinline__ void unit_logits(const float* xh, int R, int W,
                                            const float* embs, int VR4,
                                            int v_real, int Vp, float* out) {
  const int ngr = VR4 / 4, npr = (R + 1) / 2;
  for (int it = threadIdx.x; it < npr * ngr; it += UNT) {
    const int rp = it / ngr, j = (it - rp * ngr) * 4;
    const int ra = 2 * rp, rb = min(ra + 1, R - 1);
    float tot[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
    for (int i0 = 0; i0 < W; i0 += KCH) {
      float acc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
      const int i1 = min(i0 + KCH, W);
#pragma unroll 2
      for (int i = i0; i < i1; i += 4) {
        const float4 xa = *reinterpret_cast<const float4*>(xh + ra * W + i);
        const float4 xb = *reinterpret_cast<const float4*>(xh + rb * W + i);
        const float xq[2][4] = {{xa.x, xa.y, xa.z, xa.w},
                                {xb.x, xb.y, xb.z, xb.w}};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 wv =
              *reinterpret_cast<const float4*>(embs + (i + q) * VR4 + j);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            acc[h][0] = fmaf(xq[h][q], wv.x, acc[h][0]);
            acc[h][1] = fmaf(xq[h][q], wv.y, acc[h][1]);
            acc[h][2] = fmaf(xq[h][q], wv.z, acc[h][2]);
            acc[h][3] = fmaf(xq[h][q], wv.w, acc[h][3]);
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 4; ++c) tot[h][c] += acc[h][c];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (j + c < v_real && (h == 0 || ra + 1 < R))
          out[(ra + h) * Vp + j + c] = tot[h][c] + 0.0f;
  }
}

// row_candidates with the row's logits in registers, NCH 32-column chunks
// a lane, and the ranks counted against every logit passed by shuffles
// (no branches, no loads): the same values.
template <int NCH>
__device__ void row_candidates_reg(const Params& p, const float* lg,
                                   float cost, float* ccost, int* cchar) {
  const int lane = threadIdx.x & 31;
  const int TOPK = p.topk, vr = p.v_real;
  float x[NCH];
  int rank[NCH];
  float mx = -INFINITY;
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int v = lane + 32 * c;
    x[c] = v < vr ? lg[v] : -INFINITY;  // past v_real: ranks no logit
    if (v < vr) mx = fmaxf(mx, x[c]);
    rank[c] = 0;
  }
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  float sum = 0.0f;
#pragma unroll
  for (int c = 0; c < NCH; ++c)
    if (lane + 32 * c < vr) sum += expf(x[c] - mx);
  for (int o = 16; o > 0; o >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
  const float lse = mx + logf(sum);
#pragma unroll
  for (int cu = 0; cu < NCH; ++cu)
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float y = __shfl_sync(0xffffffffu, x[cu], j);
#pragma unroll
      for (int c = 0; c < NCH; ++c)
        rank[c] += (int)((y > x[c]) |
                         ((y == x[c]) & (32 * cu + j < lane + 32 * c)));
    }
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    if (lane + 32 * c < vr && rank[c] < TOPK) {
      ccost[rank[c]] = x[c];
      cchar[rank[c]] = lane + 32 * c;
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

// the own rows' candidates, a warp a row
template <int NCH>
__device__ __forceinline__ void own_candidates(const Params& p, int R,
                                               const float* lg,
                                               const float* cost,
                                               float* ccost, int* cchar) {
  for (int r = threadIdx.x >> 5; r < R; r += UNW)
    row_candidates_reg<NCH>(p, lg + r * p.Vp, cost[r], ccost + r * p.topk,
                            cchar + r * p.topk);
}

template <int D, bool GROUPS>
__global__ void __launch_bounds__(UNT, 1)
    gen_beam_units_kernel(Params p, const __grid_constant__ UParams up) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = p.K, TOPK = p.topk, KT = K * TOPK, W = p.W;
  const int S = (2 * D + 1) * W, G4 = 4 * W, TR = up.TR;
  const int CLn = (int)cluster.num_blocks(), kc = (int)cluster.block_rank();
  // stream n, its row group's first row g0 (GROUPS: cluster blockIdx.x/CLn
  // is row group g0/KG of stream n)
  const int n = GROUPS ? blockIdx.x / CLn / up.G : blockIdx.x / CLn;
  const int KG = GROUPS ? K / up.G : K;
  const int g0 = GROUPS ? (blockIdx.x / CLn - n * up.G) * KG : 0;
  // block (rh, ug): the units of group ug, the rows of half rh
  const int upb = up.g.upb, NC = up.g.NC, u0 = (kc % up.g.CU) * upb;
  const int KH = KG / up.g.RH, h0 = g0 + (kc / up.g.CU) * KH;
  const int R = KG / CLn, r0 = g0 + kc * R;
#define USM(f) (sm + up.pl.f)
#define USMI(f) reinterpret_cast<int*>(sm + up.pl.f)
  float* hbase = up.hbuf + (size_t)n * 2 * D * K * W;
  float* cbase = up.cbuf + (size_t)n * 2 * D * K * W;

  // the thread's role and its weights, of every layer, in registers
  const int q = tid % up.g.NROLE, rg = tid / up.g.NROLE;
  const bool worker = rg < up.g.NRG;
  const int half = NC / 2, kb = q / half, col = q % half;
  float wr[D][2][KCH];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int cc = col + c * half;
    const int gcol = (cc / upb) * W + u0 + cc % upb;
#pragma unroll
    for (int d = 0; d < D; ++d)
#pragma unroll
      for (int k = 0; k < KCH; ++k) {
        const size_t i = ((size_t)d * 2 * W + kb * KCH + k) * G4 + gcol;
        wr[d][c][k] = worker ? p.wcat[i] : 0.0f;
      }
  }
  for (int i = tid; i < D * NC; i += UNT) {
    const int d = i / NC, c = i - d * NC;
    USM(bias)[i] = p.bias[d * G4 + (c / upb) * W + u0 + c % upb];
  }
  for (int i = tid; i < W * up.g.VR4; i += UNT) {
    const int r = i / up.g.VR4;
    USM(embs)[i] = p.embT[(size_t)r * p.Vp + i - r * up.g.VR4];
  }
  for (int s = tid; s < K; s += UNT) USMI(srow)[s] = s;
  for (int i = tid; i < R; i += UNT)
    USM(cost)[i] = p.cost0[(size_t)n * K + r0 + i];
  __syncthreads();
  PHASE_INIT

  // half the warps run a tile's gate updates before its products
  const bool sums_first = warp & 1;
  for (int t = 0; t < p.T; ++t) {
    const int cur = t & 1;
    float* hcur = hbase + (size_t)cur * D * K * W;
    const float* hprv = hbase + (size_t)(cur ^ 1) * D * K * W;
    float* ccur = cbase + (size_t)cur * D * K * W;
    const float* cprv = cbase + (size_t)(cur ^ 1) * D * K * W;

    // ---- the LSTM stack over the half's rows, the own units ----
#pragma unroll
    for (int d = 0; d < D; ++d) {
      // one block barrier a tile: tile i's products (part[i & 1]) run
      // beside tile i-1's block sums and gate updates (part[(i-1) & 1])
      const int ntiles = KH / TR, nps = up.g.NKB2 * TR * up.g.PS;
      stage_tile<D>(p, n, t, d, h0, TR, up.g.XP, u0, upb, hcur, hprv, cprv,
                    USMI(srow), USMI(schar), USM(xin), USM(cin));
      for (int tile = 0; tile <= ntiles; ++tile) {
        cp_async_wait_all();
        __syncthreads();  // tile is in; tile-1's products, tile-2's sums done
        if (tile + 1 < ntiles)
          stage_tile<D>(p, n, t, d, h0 + (tile + 1) * TR, TR, up.g.XP, u0,
                        upb, hcur, hprv, cprv, USMI(srow), USMI(schar),
                        USM(xin) + ((tile + 1) & 1) * TR * up.g.XP,
                        USM(cin) + ((tile + 1) % 3) * TR * upb);
        PHASE(0)
        for (int job = 0; job < 2; ++job) {  // products, gate updates
          if (job == (int)sums_first) {
            if (worker && tile < ntiles) {
              const int rpt = TR / up.g.NRG;
              unit_products(
                  USM(xin) + (tile & 1) * TR * up.g.XP + kb * (KCH + 4),
                  up.g.XP, wr[d], rg * rpt, (rg + 1) * rpt,
                  USM(part) + (tile & 1) * nps + kb * TR * up.g.PS + col,
                  up.g.PS, half);
            }
            PHASE(1)
          } else if (tile > 0) {
            // tile-1's block sums in block order, bias, gate update: one
            // thread a (row, own unit)
            const int pt = tile - 1;
            for (int i = tid; i < TR * upb; i += UNT) {
              const int r = i / upb, uu = i - r * upb, s = h0 + pt * TR + r;
              const float* pr =
                  USM(part) + (pt & 1) * nps + r * up.g.PS + uu;
              float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 8
              for (int b = 0; b < up.g.NKB2; ++b)
#pragma unroll
                for (int gate = 0; gate < 4; ++gate)
                  z[gate] += pr[b * TR * up.g.PS + gate * upb];
              const float* bs = USM(bias) + d * NC + uu;
              const float2 hc = lstm_gate(
                  z[0] + bs[0], z[1] + bs[upb], z[2] + bs[2 * upb],
                  z[3] + bs[3 * upb],
                  USM(cin)[(pt % 3) * TR * upb + r * upb + uu]);
              const size_t o = ((size_t)d * K + s) * W + u0 + uu;
              ccur[o] = hc.y;
              hcur[o] = hc.x;
            }
            PHASE(2)
          }
        }
      }
      cluster.sync();  // every unit's new h and c of layer d are out
      PHASE(3)
    }

    // ---- the own rows' logits and candidates ----
    {
      const int wq = W / 4;
      float* xh = USM(xin);
      for (int i = tid; i < R * wq; i += UNT) {
        const int r = i / wq, e = (i - r * wq) * 4;
        *reinterpret_cast<float4*>(xh + r * W + e) =
            __ldcg(reinterpret_cast<const float4*>(
                hcur + ((size_t)(D - 1) * K + r0 + r) * W + e));
      }
      __syncthreads();
      unit_logits(xh, R, W, USM(embs), up.g.VR4, p.v_real, p.Vp, USM(part));
      __syncthreads();
    }
    PHASE(4)
    switch ((p.v_real + 31) / 32) {
      case 1:
        own_candidates<1>(p, R, USM(part), USM(cost), USM(ccost),
                          USMI(cchar));
        break;
      case 2:
        own_candidates<2>(p, R, USM(part), USM(cost), USM(ccost),
                          USMI(cchar));
        break;
      case 3:
        own_candidates<3>(p, R, USM(part), USM(cost), USM(ccost),
                          USMI(cchar));
        break;
      default:
        own_candidates<4>(p, R, USM(part), USM(cost), USM(ccost),
                          USMI(cchar));
    }
    PHASE(5)
    if constexpr (GROUPS) {
      // ---- the own rows' candidates to L2 (by step parity), one arrival
      // a block on the stream's counter, then all K*TOPK from L2 ----
      const size_t xo = ((size_t)(t & 1) * p.N + n) * KT;
      float* xc = up.xcost + xo;
      int* xh = up.xchar + xo;
      __syncthreads();
      for (int i = tid; i < R * TOPK; i += UNT) {
        xc[r0 * TOPK + i] = USM(ccost)[i];
        xh[r0 * TOPK + i] = USMI(cchar)[i];
      }
      group_arrive(up.flags + n);
      group_wait(up.flags + n, (unsigned)(up.G * CLn) * (unsigned)(t + 1));
      PHASE(8)
      float4* allc4 = reinterpret_cast<float4*>(USM(allc));
      int4* allch4 = reinterpret_cast<int4*>(USMI(allch));
      for (int i = tid; i < KT / 4; i += UNT) {
        allc4[i] = __ldcg(reinterpret_cast<const float4*>(xc) + i);
        allch4[i] = __ldcg(reinterpret_cast<const int4*>(xh) + i);
      }
      __syncthreads();
    } else {
      cluster.sync();  // every block's candidates are ready

      // ---- all K*TOPK candidates, from the cluster's shared memory ----
      {
        // four remote loads of each array in flight a thread
        float* allc = USM(allc);
        int* allch = USMI(allch);
        for (int i0 = tid; i0 < KT; i0 += 4 * UNT) {
          float c4[4];
          int h4[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int i = min(i0 + j * UNT, KT - 1);
            const int b = i / (R * TOPK), o = i - b * R * TOPK;
            c4[j] = cluster.map_shared_rank(USM(ccost), b)[o];
            h4[j] = cluster.map_shared_rank(USMI(cchar), b)[o];
          }
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (i0 + j * UNT < KT) {
              allc[i0 + j * UNT] = c4[j];
              allch[i0 + j * UNT] = h4[j];
            }
        }
      }
      __syncthreads();
    }
    PHASE(6)

    // ---- the K-th smallest cost: a radix select on the float bits
    // (costs are >= 0, so their bits order as the floats do), 8 bits a
    // pass from the top, the whole block counting into a histogram ----
    const float* allc = USM(allc);
    int* hist = USMI(hist);
    int* misc = USMI(misc);
    unsigned prefix = 0u, pmask = 0u;
    int kk = K;  // rank of the K-th smallest among those under prefix
    for (int shift = 24; shift >= 0; shift -= 8) {
      for (int i = tid; i < 256; i += UNT) hist[i] = 0;
      __syncthreads();
      for (int i = tid; i < KT; i += UNT) {
        const unsigned v = __float_as_uint(allc[i]);
        if ((v & pmask) == prefix) atomicAdd(hist + ((v >> shift) & 255u), 1);
      }
      __syncthreads();
      if (warp == 0) {
        int h[8], sum = 0;
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          h[b] = hist[lane * 8 + b];
          sum += h[b];
        }
        int incl = sum;
        for (int o = 1; o < 32; o <<= 1) {
          const int v = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += v;
        }
        int before = incl - sum;
        if (before < kk && kk <= incl) {
          for (int b = 0; b < 8; ++b) {
            if (kk <= before + h[b]) {
              misc[2] = lane * 8 + b;
              misc[3] = kk - before;
              break;
            }
            before += h[b];
          }
        }
      }
      __syncthreads();
      prefix |= (unsigned)misc[2] << shift;
      pmask |= 0xffu << shift;
      kk = misc[3];
    }
    const unsigned thr = prefix;

    // ---- per-row counts below and at the threshold, their prefixes ----
    int* less = USMI(less);
    int* eq = USMI(eq);
    int* lpfx = USMI(lpfx);
    int* epfx = USMI(epfx);
    for (int r = tid; r < K; r += UNT) {
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
      int il = sl, ie = se;
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

    // ---- compaction: selected candidates in row-major order; slot s is
    // the s-th selected; every block fills every slot ----
    {
      int* srow = USMI(srow);
      int* scol = USMI(scol);
      const int need = K - misc[0];
      for (int r = tid; r < K; r += UNT) {
        int slot = lpfx[r] + min(epfx[r], need), seen_eq = 0;
        for (int k = 0; k < TOPK && slot < K; ++k) {
          const unsigned u = __float_as_uint(allc[r * TOPK + k]);
          const bool at = u == thr;
          const bool sel = u < thr || (at && epfx[r] + seen_eq < need);
          seen_eq += at;
          if (sel) {
            srow[slot] = r;
            scol[slot] = k;
            ++slot;
          }
        }
      }
      __syncthreads();

      // ---- every slot's char; the own slots' records and costs ----
      const int* allch = USMI(allch);
      int* schar = USMI(schar);
      float* rec = p.rec + ((size_t)n * p.T + t) * 3 * K;
      for (int s = tid; s < K; s += UNT) {
        const int f = srow[s] * TOPK + scol[s];
        schar[s] = allch[f];
        if (s >= r0 && s < r0 + R) {
          rec[s] = (float)allch[f];
          rec[K + s] = (float)srow[s];
          rec[2 * K + s] = allc[f];
          USM(cost)[s - r0] = allc[f];
        }
      }
      __syncthreads();
    }
    PHASE(7)
  }
  PHASE_FLUSH

  // ---- the fringe after the last step: [emb[char] | h, c of the source
  // row], the own units of every slot ----
  if (up.fin != nullptr) {
    const int last = (p.T - 1) & 1;
    const float* hl = hbase + (size_t)last * D * K * W;
    const float* cl = cbase + (size_t)last * D * K * W;
    for (int i = tid; i < KH * upb; i += UNT) {
      const int s = h0 + i / upb, uu = i % upb, src = USMI(srow)[s];
      float* row = up.fin + ((size_t)n * K + s) * S + u0 + uu;
      row[0] = p.emb[(size_t)USMI(schar)[s] * W + u0 + uu];
      for (int d = 0; d < D; ++d) {
        const size_t o = ((size_t)d * K + src) * W + u0 + uu;
        row[(1 + d) * W] = __ldcg(hl + o);
        row[(1 + D + d) * W] = __ldcg(cl + o);
      }
    }
  }
#undef USM
#undef USMI
  cluster.sync();  // no block leaves while another may still read it
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

// ---- the unit layout's host side ----

template <int D, bool GROUPS>
static int ulaunch_t(int cl, int g, const Params& p, const UParams& u,
                     size_t smem, cudaStream_t stream, int* fits) {
  auto kern = gen_beam_units_kernel<D, GROUPS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && cl > 8)  // 16 blocks exceed the portable 8
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg = config(cl, p.N * g, smem, stream, attr);
  cfg.blockDim = dim3(UNT);
  if (fits) {
    if (GROUPS) {  // the row groups need a cooperative launch
      int dev = 0, coop = 0;
      err = cudaGetDevice(&dev);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                     dev);
      if (err != cudaSuccess) return (int)err;
      if (!coop) return (int)cudaErrorNotSupported;
    }
    return (int)cudaOccupancyMaxActiveClusters(fits, kern, &cfg);
  }
  if (GROUPS) {  // every cluster of every stream resident at once
    attr[1].id = cudaLaunchAttributeCooperative;
    attr[1].val.cooperative = 1;
    cfg.numAttrs = 2;
  }
  err = cudaLaunchKernelEx(&cfg, kern, p, u);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// Launch (or, with `fits`, count how many clusters of cl blocks the card
// holds at once into *fits) in the unit layout with tiles of tr rows, a
// stream's rows in g row groups; refuses a shape units_ok does not take.
static int ulaunch(int cl, int rh, int tr, int g, const Params& p,
                   UParams u, cudaStream_t stream, int* fits) {
  if (!units_ok(p.K, p.D, p.W, cl, rh, tr, p.v_real, g) || p.topk < 1 ||
      p.topk > MAX_TOPK || p.v_real > p.Vp || p.Vp % 4)
    return (int)cudaErrorInvalidValue;
  u.TR = tr;
  u.g = make_ugeo(p.W, cl, rh, p.v_real);
  u.pl = make_uplan(p.K, p.D, p.W, p.Vp, p.v_real, p.topk, cl, rh, tr, g);
  u.G = g;
  const size_t smem = (size_t)u.pl.total * 4;
  if (g > 1) {
    if (p.D == 1) return ulaunch_t<1, true>(cl, g, p, u, smem, stream, fits);
    return ulaunch_t<2, true>(cl, g, p, u, smem, stream, fits);
  }
  if (p.D == 1) return ulaunch_t<1, false>(cl, 1, p, u, smem, stream, fits);
  return ulaunch_t<2, false>(cl, 1, p, u, smem, stream, fits);
}

extern "C" size_t gen_beam_units_smem_bytes(int K, int cl, int rh, int tr,
                                            int g, int D, int W, int Vp,
                                            int v_real, int topk) {
  return (size_t)make_uplan(K, D, W, Vp, v_real, topk, cl, rh, tr, g).total *
         4;
}

// How many clusters of cl blocks of the unit layout the card holds at
// once (0 where the layout does not take the shape or it does not fit;
// with g > 1 row groups also where the card takes no cooperative launch).
extern "C" int gen_beam_units_max_clusters(int cl, int rh, int tr, int g,
                                           int K, int D, int W, int Vp,
                                           int v_real, int topk) {
  Params p{};
  p.N = 1, p.K = K, p.D = D, p.W = W, p.Vp = Vp, p.v_real = v_real;
  p.topk = topk;
  int fits = 0;
  return ulaunch(cl, rh, tr, g, p, UParams{}, 0, &fits) == 0 ? fits : 0;
}

// hbuf, cbuf: (N, 2, D, K, W) scratch; fin: (N, K, S) or null; with g > 1
// row groups xcost, xchar: (2, N, K*topk) scratch and flags: N counters,
// zeroed (unused at g = 1)
extern "C" int gen_beam_units_launch(const float* emb, const float* embT,
                                     const float* wcat, const float* bias,
                                     const float* state0, const float* cost0,
                                     float* rec, float* hbuf, float* cbuf,
                                     float* fin, float* xcost, int* xchar,
                                     unsigned* flags, int cl, int rh, int tr,
                                     int g, int N, int T, int K, int D, int W,
                                     int Vp, int v_real, int topk,
                                     float log_thresh, void* stream) {
  Params p{emb, embT, wcat, bias, state0, cost0, rec, nullptr, N, T,
           K,   D,    W,    Vp,   v_real, topk,  log_thresh};
  UParams u{};
  u.hbuf = hbuf;
  u.cbuf = cbuf;
  u.fin = fin;
  u.xcost = xcost;
  u.xchar = xchar;
  u.flags = flags;
  return ulaunch(cl, rh, tr, g, p, u, (cudaStream_t)stream, nullptr);
}
