// Device code shared by the lattice decode kernels (decode_lattice.cu,
// one document a launch, and decode_lattice_batch.cu, one document a
// cluster or block): the LSTM stack with the tied softmax over a chunk of
// rows, the per-edge beam step and the shared-memory plan, in two
// layouts: decode_edges_cluster, one document on a thread-block cluster
// (below), and decode_edges, one document on one block, the first port's
// code, kept unchanged for the shapes the cluster layout does not take.
// Both kernels run them on their documents, and both layouts give the
// same bits, so a document's records and final beam do not depend on
// which kernel or layout decoded it.
//
// The edge loop: for each real edge t < n_real every beam row
// [xemb | h_0..h_{D-1} | c_0..c_{D-1}] expands into A candidates
// (r = k*A + a), runs up to steps[t] masked char steps of the D-layer
// LSTM plus the tied-softmax -log2 p, and the exact top K by (total
// cost, candidate index) becomes the next beam.  Pad edges t >= n_real
// are written in closed form as identity.
//
//  * the beam (K x S f32) lives in shared memory across edges, the K*A
//    candidate rows in a global scratch slice of the document (L2-
//    resident);
//  * rows are processed in chunks of RB <= 32 held in shared memory; each
//    thread owns one gate column and keeps RB accumulators in registers,
//    so every weight read from L2 feeds RB FMAs; the dot products are
//    summed in blocks of 32 terms, so the kernel's rounding error stays
//    at the plain version's and the state carried over ~10^3 edges
//    meets the plain version within the f32 tolerances;
//  * char step 0 of every edge runs on the K parent rows only: all A
//    candidates of a parent share the parent's state there, only the
//    picked logit differs (4x less work, identical arithmetic per row);
//  * later steps run only on candidate rows whose mask is set at that
//    step (a masked row keeps its state and adds nothing to its cost);
//  * the one-hot "gathers" of the TPU kernels are index loads; top-K is
//    one thread per candidate counting its predecessors in the exact
//    (cost, index) order.
// With f32 weights all arithmetic is f32 on CUDA cores: no TF32, no bf16.
//
// bf16 weights (the opt-in bf16 decode mode; the TPU kernels'
// decode_lattice_pallas and decode_lattice_pallas_batch given bf16 emb,
// embT and wcat): every device function below is a template on the
// weights' type WT, and the f32 instantiation is the code above as it
// was.  Under WT = __nv_bfloat16 each matmul operand ([input | h_d] of a
// layer, the top h of the logits) is rounded to bf16 (nearest even),
// every product of two bf16 values is exact in f32, and the sums stay
// f32: the TPU's preferred_element_type=f32 product on bf16 inputs.  The
// carried state (xemb rows are bf16 embedding values widened), the
// biases, the gates, the softmax and all cost arithmetic stay f32.  Its
// bound is that of the f32 kernel's operations at the tensor cores'
// bf16 rate, 989 TFLOP/s (1.92e10 FLOP a page of 617 edges: 0.0194 ms);
// what the design does about the products is said above
// decode_edges_cluster.  One shared-memory plan serves both types.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "cluster_common.cuh"

#define NT 512        // threads per block
#define RBMAX 32      // rows per chunk
#define LANE 128      // width of the single-document cost carry vector
#define BIGF 1.0e30f
#define INV_LN2F 1.4426950408889634f

// What every document of a launch shares.
struct Decode {
  const float* emb;    // (Vp, W)
  const float* embT;   // (W, Vp)
  const float* wcat;   // (D, 2W, 4W)
  const float* bias;   // (D, 4W)
  const int* steps;    // (E,) char steps per edge
  int E, n_real, A, L, K, D, W, Vp, v_real;
  int rb;              // rows per chunk: 8, 16 or RBMAX
  float lw, lw1;
  // the same three weights in bf16 (the bf16 decode mode; the f32
  // pointers above are null then, and these null under f32 weights)
  const __nv_bfloat16* emb16;
  const __nv_bfloat16* embT16;
  const __nv_bfloat16* wcat16;
};

// The weights of type WT of a launch.
template <typename WT>
struct Weights {
  const WT *emb, *embT, *wcat;
};
template <typename WT>
__device__ __forceinline__ Weights<WT> weights_of(const Decode& p) {
  if constexpr (std::is_same<WT, float>::value)
    return {p.emb, p.embT, p.wcat};
  else
    return {p.emb16, p.embT16, p.wcat16};
}

// A weight as f32 (a bf16 value widened exactly).
__device__ __forceinline__ float ldw(const float* w) { return __ldg(w); }
__device__ __forceinline__ float ldw(const __nv_bfloat16* w) {
  return __bfloat162float(__ldg(w));
}
// Four weights from w + 4 i4 (16 or 8 bytes, aligned) as f32.
__device__ __forceinline__ float4 ldw4(const float* w, int i4) {
  return __ldg(reinterpret_cast<const float4*>(w) + i4);
}
__device__ __forceinline__ float4 ldw4(const __nv_bfloat16* w, int i4) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(w) + i4);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
// An f32 matmul operand under weights of type WT: as it is (f32), or
// rounded to bf16 (nearest even) and widened back.
template <typename WT>
__device__ __forceinline__ float opnd(float v) {
  if constexpr (std::is_same<WT, float>::value)
    return v;
  else
    return __bfloat162float(__float2bfloat16_rn(v));
}
template <typename WT>
__device__ __forceinline__ float4 opnd4(float4 v) {
  return make_float4(opnd<WT>(v.x), opnd<WT>(v.y), opnd<WT>(v.z),
                     opnd<WT>(v.w));
}

// One document's slice of the launch's arrays.
struct Doc {
  const int* chars;    // edge 0's (A, L) chars
  const float* mask;   // edge 0's (A, L) mask
  const float* conf;   // edge 0's (A, L) conf bits
  size_t alt_stride;   // elements from one edge's (A, L) to the next's
  const float* valid;  // edge 0's (A,) validity
  size_t valid_stride;
  const float* state0; // (K, S) initial beam
  const float* cost0;  // (K,) initial costs
  float* rec;          // edge 0's records: bp at rec[k], alt at
                       // rec[field + k], cost at rec[2 * field + k]
  size_t rec_stride, rec_field;
  float* stateE;       // (K*A, S) scratch
};

__device__ __forceinline__ float sigm(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// xs[r*S + (d*W .. d*W + 2W)] is [input | h_d] for layer d when layers
// < d have already written their new h in place.  One thread per
// output column, RB row accumulators in registers.  The dot product is
// summed in blocks of KCH terms whose partial sums collect in `out`:
// one chain of 2W = 256 FMAs into a register loses more precision than
// the plain version's product, and the beam state carries that error
// from edge to edge.
// Under bf16 weights (WT) the one-block layout rounds each operand value
// as it loads it and widens each weight: the same f32 FMAs over bf16
// values, a simple path for the shapes the cluster layout does not take.
#define KCH 32
template <int RB, typename WT>
__device__ void matmul_rows(const float* __restrict__ x, int S,
                            int kdim, const WT* __restrict__ w,
                            int ncols, const float* __restrict__ b,
                            float* out) {
  for (int j = threadIdx.x; j < ncols; j += NT) {
    for (int i0 = 0; i0 < kdim; i0 += KCH) {
      float acc[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) acc[r] = 0.0f;
      const int i1 = min(i0 + KCH, kdim);
      for (int i = i0; i < i1; i += 4) {
        const float w0 = ldw(w + (size_t)(i + 0) * ncols + j);
        const float w1 = ldw(w + (size_t)(i + 1) * ncols + j);
        const float w2 = ldw(w + (size_t)(i + 2) * ncols + j);
        const float w3 = ldw(w + (size_t)(i + 3) * ncols + j);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float4 xv = opnd4<WT>(
              *reinterpret_cast<const float4*>(x + r * S + i));
          float a = acc[r];
          a = fmaf(xv.x, w0, a);
          a = fmaf(xv.y, w1, a);
          a = fmaf(xv.z, w2, a);
          a = fmaf(xv.w, w3, a);
          acc[r] = a;
        }
      }
#pragma unroll
      for (int r = 0; r < RB; ++r)
        out[r * ncols + j] = i0 == 0 ? acc[r] : out[r * ncols + j] + acc[r];
    }
    const float bj = b ? __ldg(b + j) : 0.0f;
#pragma unroll
    for (int r = 0; r < RB; ++r) out[r * ncols + j] += bj;
  }
}

// One char step of the LSTM stack and the tied softmax over the RB rows
// in xs (in place: xs keeps xemb, gets the new h and c).  Leaves the
// logits in zb (row stride Vp) and the per-row logsumexp in lse.
template <int RB, typename WT>
__device__ void chunk_step(const Decode& p, float* xs, float* zb,
                           float* lse) {
  const int W = p.W, D = p.D, S = (2 * D + 1) * W, G = 4 * W;
  const Weights<WT> wt = weights_of<WT>(p);
  for (int d = 0; d < D; ++d) {
    matmul_rows<RB>(xs + d * W, S, 2 * W, wt.wcat + (size_t)d * 2 * W * G,
                    G, p.bias + d * G, zb);
    __syncthreads();
    for (int idx = threadIdx.x; idx < RB * W; idx += NT) {
      const int r = idx / W, u = idx - (idx / W) * W;
      const float* z = zb + r * G;
      const float ig = sigm(z[u]);
      const float fg = sigm(z[W + u]);
      const float gg = tanhf(z[2 * W + u]);
      const float og = sigm(z[3 * W + u]);
      float* row = xs + r * S;
      const float c2 = fg * row[(1 + D + d) * W + u] + ig * gg;
      row[(1 + D + d) * W + u] = c2;
      row[(1 + d) * W + u] = og * tanhf(c2);
    }
    __syncthreads();
  }
  matmul_rows<RB>(xs + D * W, S, W, wt.embT, p.Vp, nullptr, zb);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < RB; r += NT / 32) {
    const float* lg = zb + r * p.Vp;
    float mx = -INFINITY;
    for (int v = lane; v < p.v_real; v += 32) mx = fmaxf(mx, lg[v]);
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.0f;
    for (int v = lane; v < p.v_real; v += 32) sum += expf(lg[v] - mx);
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) lse[r] = mx + logf(sum);
  }
  __syncthreads();
}

template <typename WT>
__device__ void run_chunk(const Decode& p, int nrows, float* xs, float* zb,
                          float* lse) {
  if (nrows <= 8)
    chunk_step<8, WT>(p, xs, zb, lse);
  else if (nrows <= 16)
    chunk_step<16, WT>(p, xs, zb, lse);
  else
    chunk_step<32, WT>(p, xs, zb, lse);
}

static size_t decode_smem_floats(int A, int L, int K, int D, int W, int Vp,
                                 int rb) {
  const int S = (2 * D + 1) * W;
  const int ZW = 4 * W > Vp ? 4 * W : Vp;
  const int KA = K * A;
  // beam, chunk rows, gates/logits, then the small per-edge arrays
  return (size_t)K * S + (size_t)rb * S + (size_t)rb * ZW +
         K + 2 * KA + rb + 2 * A * L + A +  // floats
         K + KA + A * L + 4;                   // ints
}

// Rows per chunk: the largest of RBMAX, 16, 8 whose shared memory fits
// the block's opt-in limit (K=32 with L=64 needs the smaller chunks).
// Both kernels choose it alike from (A, L, K, D, W, Vp).
static int decode_chunk_rows(int A, int L, int K, int D, int W, int Vp) {
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  int rb = RBMAX;
  while (rb > 8 &&
         decode_smem_floats(A, L, K, D, W, Vp, rb) * 4 > (size_t)limit)
    rb /= 2;
  return rb;
}

// The block's shared memory, carved in decode_smem_floats's order.
struct Smem {
  float *beam, *xs, *zb, *costf, *acc, *total, *lse, *emask, *econf,
      *evalid;
  int *sel, *live, *echar, *nlive;
};

__device__ Smem carve_smem(const Decode& p, float* base) {
  const int A = p.A, L = p.L, K = p.K, KA = K * A, W = p.W;
  const int S = (2 * p.D + 1) * W;
  const int ZW = 4 * W > p.Vp ? 4 * W : p.Vp;
  Smem s;
  s.beam = base;
  s.xs = s.beam + K * S;
  s.zb = s.xs + p.rb * S;
  s.costf = s.zb + p.rb * ZW;
  s.acc = s.costf + K;
  s.total = s.acc + KA;
  s.lse = s.total + KA;
  s.emask = s.lse + p.rb;
  s.econf = s.emask + A * L;
  s.evalid = s.econf + A * L;
  s.sel = reinterpret_cast<int*>(s.evalid + A);
  s.live = s.sel + K;
  s.echar = s.live + KA;
  s.nlive = s.echar + A * L;
  return s;
}

// Decode every edge of document `d`; the final beam and its costs stay
// in sm.beam and sm.costf (the caller writes them out after a barrier).
template <typename WT>
__device__ void decode_edges(const Decode& p, const Doc& d, const Smem& sm) {
  const Weights<WT> wt = weights_of<WT>(p);
  const int tid = threadIdx.x;
  const int A = p.A, L = p.L, K = p.K, KA = K * p.A, W = p.W;
  const int S = (2 * p.D + 1) * W;
  const int rb = p.rb;
  float* beam = sm.beam;
  float* xs = sm.xs;
  float* zb = sm.zb;
  float* costf = sm.costf;
  float* acc = sm.acc;
  float* total = sm.total;
  float* lse = sm.lse;
  float* emask = sm.emask;
  float* econf = sm.econf;
  float* evalid = sm.evalid;
  int* sel = sm.sel;
  int* live = sm.live;
  int* echar = sm.echar;
  int* nlive = sm.nlive;
  const size_t F = d.rec_field;

  for (int i = tid; i < K * S; i += NT) beam[i] = d.state0[i];
  for (int i = tid; i < rb * S; i += NT) xs[i] = 0.0f;
  for (int k = tid; k < K; k += NT) costf[k] = d.cost0[k];
  __syncthreads();

  for (int t = 0; t < p.E; ++t) {
    float* rec = d.rec + (size_t)t * d.rec_stride;
    if (t >= p.n_real) {
      for (int k = tid; k < K; k += NT) {
        rec[k] = (float)k;
        rec[F + k] = 0.0f;
        rec[2 * F + k] = costf[k];
      }
      continue;
    }
    const size_t eo = (size_t)t * d.alt_stride;
    for (int i = tid; i < A * L; i += NT) {
      echar[i] = d.chars[eo + i];
      emask[i] = d.mask[eo + i];
      econf[i] = d.conf[eo + i];
    }
    for (int a = tid; a < A; a += NT)
      evalid[a] = d.valid[(size_t)t * d.valid_stride + a];
    for (int r = tid; r < KA; r += NT) acc[r] = 0.0f;
    for (int k = tid; k < K; k += NT) sel[k] = k;
    const int nsteps = p.steps[t];
    __syncthreads();

    // ---- char step 0 on the K parent rows ----
    if (nsteps >= 1) {
      for (int k0 = 0; k0 < K; k0 += rb) {
        const int nrows = min(K - k0, rb);
        for (int i = tid; i < nrows * S; i += NT) xs[i] = beam[k0 * S + i];
        __syncthreads();
        run_chunk<WT>(p, nrows, xs, zb, lse);
        for (int i = tid; i < nrows * A; i += NT) {
          const int r = k0 * A + i, a = r % A, row = i / A;
          const float m = emask[a * L];
          if (m > 0.0f) {
            const float nll2 =
                (lse[row] - zb[row * p.Vp + echar[a * L]]) * INV_LN2F;
            acc[r] += m * (p.lw * nll2 + p.lw1 * econf[a * L]);
          }
        }
        for (int i = tid; i < nrows * A * S; i += NT) {
          const int rr = i / S, e = i - rr * S;
          const int r = k0 * A + rr, a = r % A, row = rr / A;
          float v;
          if (emask[a * L] > 0.0f)
            v = e < W ? ldw(wt.emb + (size_t)echar[a * L] * W + e)
                      : xs[row * S + e];
          else
            v = beam[(k0 + row) * S + e];
          d.stateE[(size_t)r * S + e] = v;
        }
        __syncthreads();
      }
    } else {
      for (int i = tid; i < KA * S; i += NT) {
        const int r = i / S;
        d.stateE[i] = beam[(r / A) * S + (i - r * S)];
      }
      __syncthreads();
    }

    // ---- char steps 1.. on the candidate rows that still have chars ----
    for (int s = 1; s < nsteps; ++s) {
      if (tid == 0) {
        int n = 0;
        for (int r = 0; r < KA; ++r)
          if (emask[(r % A) * L + s] > 0.0f) live[n++] = r;
        nlive[0] = n;
      }
      __syncthreads();
      const int n = nlive[0];
      for (int c0 = 0; c0 < n; c0 += rb) {
        const int nrows = min(n - c0, rb);
        for (int i = tid; i < nrows * S; i += NT) {
          const int row = i / S;
          xs[i] = d.stateE[(size_t)live[c0 + row] * S + (i - row * S)];
        }
        __syncthreads();
        run_chunk<WT>(p, nrows, xs, zb, lse);
        for (int row = tid; row < nrows; row += NT) {
          const int r = live[c0 + row], a = r % A;
          const float m = emask[a * L + s];
          const float nll2 =
              (lse[row] - zb[row * p.Vp + echar[a * L + s]]) * INV_LN2F;
          acc[r] += m * (p.lw * nll2 + p.lw1 * econf[a * L + s]);
        }
        for (int i = tid; i < nrows * S; i += NT) {
          const int row = i / S, e = i - row * S;
          const int r = live[c0 + row], a = r % A;
          d.stateE[(size_t)r * S + e] =
              e < W ? ldw(wt.emb + (size_t)echar[a * L + s] * W + e)
                    : xs[row * S + e];
        }
        __syncthreads();
      }
      __syncthreads();  // every thread has read nlive before it changes
    }

    // ---- exact top-K by (total, candidate index) ----
    for (int r = tid; r < KA; r += NT)
      total[r] = evalid[r % A] > 0.5f ? costf[r / A] + acc[r] : BIGF;
    __syncthreads();
    for (int r = tid; r < KA; r += NT) {
      const float tr = total[r];
      int rank = 0;
      for (int j = 0; j < KA; ++j) {
        const float tj = total[j];
        rank += (tj < tr) || (tj == tr && j < r);
      }
      if (rank < K) sel[rank] = r;
    }
    __syncthreads();
    for (int k = tid; k < K; k += NT) {
      const int r = sel[k];
      rec[k] = (float)(r / A);
      rec[F + k] = (float)(r % A);
      rec[2 * F + k] = total[r];
      costf[k] = total[r];
    }
    for (int i = tid; i < K * S; i += NT) {
      const int k = i / S;
      beam[i] = d.stateE[(size_t)sel[k] * S + (i - k * S)];
    }
    __syncthreads();
  }
  __syncthreads();
}

// ---- one document on a thread-block cluster ----
//
// What bounds decode_edges: the FMAs of a char step on one SM, every
// weight read from L2 for RB <= 32 rows.  Here a document runs on a
// cluster of CL blocks (one per SM):
//  * weights: block k owns the units [k*upb, (k+1)*upb) (upb = W/CL) and
//    keeps the four gate columns of each owned unit, for every layer, in
//    registers for the whole launch: lane (gate g, block kb) of a unit
//    holds the 32 weights wcat[d][32kb ..][gW + u] of each layer d (a
//    gate column of [input | h_d] has NKB = 2W/32 blocks of 32 terms;
//    blocks of CNT = 256 threads, so that 255 registers a thread hold
//    them);
//    lane kb=0 adds the blocks in order (shuffles), then the bias: the
//    one-block kernel's float;
//  * state, in one of two plans of shared memory, the template parameter
//    SH of the functions below (both keep the c of the own units only;
//    nothing of the state goes through device memory):
//    - rows (SH false): every block holds the [xemb | h_0 .. h_{D-1}]
//      rows of the beam and of the K*A candidates in full (padded rows);
//      the plan wherever it fits a block (K <= 16 at W=128);
//    - sharded (SH true; K=32 at W=128, where the rows plan asks
//      388,596 bytes a block): every block holds only its own units
//      of every row, as of c.  At the start of each chunk every block sends
//      its units of the chunk's rows into a buffer of every block
//      (st.async onto the receiver's mbarrier, two buffers, the next
//      chunk's rows sent before this chunk's wait, so that the exchange
//      overlaps the products), which the products read as the rows
//      plan reads its rows.  The new h, the chars' xemb, the moves of
//      rows to the candidates and the beam's reorder touch the own
//      units only;
//  * h: after each layer of a chunk's char step, the block sends its
//    units' new h into every block (st.async onto the receiver's
//    mbarrier, a ring of two buffers, as in scan_common.cuh), waits for
//    the rows of all units and (rows plan) copies them into its rows;
//  * the tied softmax splits the chunk's rows over the blocks (row r on
//    block r % CL; a logit's four 32-term blocks on four threads, added
//    in order; the real columns of embT in shared memory), each row's
//    logsumexp on one warp in the one-block kernel's shuffle order; the
//    owner adds the row's cost term to the candidate's cost and stores
//    it into every block (distributed shared memory), and a cluster
//    barrier ends each char step;
//  * the exact top K runs in every block alike, and the beam moves in
//    each block's own copy: no second exchange.
// The same values reach the same products in the same order in both
// plans, so both give the same bits.
// Char step 0 on the K parents, the masked rows, pad edges in closed
// form, the records and the state in/out contract are decode_edges'.
//
// Under bf16 weights the gate products go to the tensor cores.  A
// chunk's DC_RC = 16 rows are one m16 tile; the block's 4*upb gate
// columns (gate g, unit ul: column g*upb + ul) are upb/2 n8 tiles, and a
// gate column's 2W terms NKB blocks of 32 (two k16 steps each).  Warp w
// < upb/2 owns n8 tile w: its lanes keep the tile's B fragments of every
// layer and block in registers for the whole launch (bf16 pairs, 4 a
// block and layer: 64 registers at W=128, D=2), load the A fragments
// (the chunk's padded rows, each value rounded to bf16 once a layer) from
// shared memory and run mma.sync.m16n8k16 bf16 with f32 sums: each
// 32-term block from 0, the blocks added to 0 in block order, as the f32
// lanes do, then the bias in the gate update.  The products of a chunk
// move onto the tensor cores and its operand loads shrink from every
// lane's 8-row passes to one A fragment a warp and block; the exchange,
// the softmax split (its products stay on CUDA cores over bf16-rounded h
// and the bf16 embT values, in f32) and the top K stay as they are.  The
// plan of shared memory is the f32 one (embT's columns widened to f32).

#define CNT 256   // threads per block of the cluster layout: a lane's
                  // 64 weights (two layers) and its work fit 255 registers
#define DC_RC 16  // rows per chunk
#define DC_RT 8   // rows per pass of a lane's chains

// blocks of 32 terms in a gate column of [input | h] at width W
__host__ __device__ inline int dc_nkb(int W) { return 2 * W / KCH; }

// Whether the cluster layout takes (W, D, CL) and an edge's A x L
// chars: W in 32, 64, 128 (2, 4 or 8 blocks of 32 terms a gate column),
// D <= 2 (a lane's 32 weights a layer in registers), CL in 4, 8, 16, a
// row group (4 x NKB lanes per unit) in a block, and A x L <= CNT (a
// thread an edge's char).
static inline bool decode_cluster_ok(int W, int D, int CL, int AL) {
  if (AL > CNT || (W != 32 && W != 64 && W != 128)) return false;
  if (D < 1 || D > 2 || (CL != 4 && CL != 8 && CL != 16)) return false;
  return W / CL * 4 * dc_nkb(W) <= CNT;
}

// The cluster layout's shared memory of a block, in floats after its
// 8-byte mbarriers, in the rows plan or the sharded one
// (ops/decode_kernel.cluster_smem_bytes mirrors it).
static size_t decode_cluster_smem_floats(int A, int L, int K, int D, int W,
                                         int Vp, int vr, int CL,
                                         bool shard) {
  const int WP = padded_width(W), XP = (D + 1) * WP, upb = W / CL;
  const int KA = K * A, RL = (DC_RC + CL - 1) / CL;
  const size_t rows =
      shard ? (size_t)2 * DC_RC * XP +            // two chunks' rows
                  (size_t)(K + KA) * (D + 1) * upb +  // own units of rows,
                  (size_t)K * D * upb             // of new h
            : (size_t)(K + KA) * XP + (size_t)K * D * WP;  // rows, new h
  return 16 + 2 * DC_RC * WP + rows +             // the ring of h
         (size_t)(2 * K + KA) * D * upb +          // their own c
         DC_RC * 4 * upb + DC_RC * upb + D * DC_RC * upb +  // z, h, c
         RL * (W / KCH) * Vp + RL + D * 4 * upb +  // logits, lse, bias
         K + 2 * KA + 2 * A * L + A +              // floats
         (size_t)W * vr +                          // embT's real columns
         K + 2 * KA + A * L + 4;                   // ints
}

static size_t decode_cluster_smem_bytes(int A, int L, int K, int D, int W,
                                        int Vp, int vr, int CL, bool shard) {
  return (shard ? 32 : 16) +  // 2 mbarriers, 4 in the sharded plan
         4 * decode_cluster_smem_floats(A, L, K, D, W, Vp, vr, CL, shard);
}

struct CSmem {
  uint64_t* bar;  // the ring of exchange buffers (2), then the chunks'
                  // rows (2, sharded plan)
  // beamx, pnx, candx: the padded rows (the rows plan) or the own units
  // of them (the sharded plan, whose two chunks' padded rows follow the
  // ring: dc_chunks)
  float *hn, *beamx, *pnx, *candx, *beamc, *pnc, *candc, *zs, *hloc, *cn,
      *lgt, *lse, *bias, *costf, *acc, *total, *emask, *econf, *evalid,
      *embt;
  int *sel, *live, *csrc, *echar, *nlive;
};

// The sharded plan's two chunks' padded rows (2, DC_RC, XP), after the
// ring of h.
__device__ __forceinline__ float* dc_chunks(const CSmem& sm, int W) {
  return sm.hn + 2 * DC_RC * padded_width(W);
}

// The carve of plan SH: the mbarriers (2, and the chunks' rows' 2 in the
// sharded plan), the ring of h, then the rows of the beam, of the K*A
// candidates and of the parents' new h in beamx, candx and pnx: padded
// (rows plan), or after the two chunks' padded rows (dc_chunks) only the
// own units of them (sharded plan).
template <bool SH>
__device__ CSmem carve_cluster_smem(const Decode& p, void* base, int CL) {
  const int W = p.W, D = p.D, K = p.K, A = p.A, L = p.L, KA = K * A;
  const int WP = padded_width(W), XP = (D + 1) * WP, upb = W / CL;
  const int RL = (DC_RC + CL - 1) / CL;
  const int XR = SH ? (D + 1) * upb : XP;  // a row of beamx and candx
  CSmem s;
  s.bar = reinterpret_cast<uint64_t*>(base);
  // the ring (2, DC_RC, WP) 16 floats on, so that a lane's input (ring)
  // and recurrent (row) blocks of layer 1 tend to fall into distinct banks
  s.hn = reinterpret_cast<float*>(s.bar + (SH ? 4 : 2)) + 16;
  s.beamx = s.hn + 2 * DC_RC * WP + (SH ? 2 * DC_RC * XP : 0);  // (K, XR)
  s.candx = s.beamx + K * XR;                        // (KA, XR)
  s.pnx = s.candx + KA * XR;                         // (K, D, WP or upb)
  s.beamc = s.pnx + K * D * (SH ? upb : WP);         // (K, D, upb)
  s.pnc = s.beamc + K * D * upb;                     // (K, D, upb)
  s.candc = s.pnc + K * D * upb;                     // (KA, D, upb)
  s.zs = s.candc + KA * D * upb;                     // (DC_RC, 4, upb)
  s.hloc = s.zs + DC_RC * 4 * upb;                   // (DC_RC, upb)
  s.cn = s.hloc + DC_RC * upb;                       // (D, DC_RC, upb)
  s.lgt = s.cn + D * DC_RC * upb;                    // (RL, W/32, Vp)
  s.lse = s.lgt + RL * (W / KCH) * p.Vp;
  s.bias = s.lse + RL;                               // (D, 4, upb)
  s.costf = s.bias + D * 4 * upb;
  s.acc = s.costf + K;
  s.total = s.acc + KA;
  s.emask = s.total + KA;
  s.econf = s.emask + A * L;
  s.evalid = s.econf + A * L;
  s.embt = s.evalid + A;  // (W, v_real)
  s.sel = reinterpret_cast<int*>(s.embt + W * p.v_real);
  s.live = s.sel + K;
  s.csrc = s.live + KA;
  s.echar = s.csrc + KA;
  s.nlive = s.echar + A * L;
  return s;
}

// Where a candidate's state is: its parent's old row (beam), its
// parent's row after step 0 (the new h in pnx, xemb the char taken) or
// a row of its own (candx).
#define SRC_OLD 0
#define SRC_NEW 1
#define SRC_OWN 2

// Candidates list[0..n) get rows of their own (and the c of the own
// units), from where they are now.
template <int W, int D, int UPB, typename WT>
__device__ __forceinline__ void own_rows(const Decode& p, const CSmem& sm,
                                         const int* list, int n) {
  const Weights<WT> wt = weights_of<WT>(p);
  constexpr int WP = W + 4 * (W / KCH), XP4 = (D + 1) * WP / 4;
  constexpr int WP4 = WP / 4, BP4 = (KCH + 4) / 4;  // float4s a block
  const int A = p.A, L = p.L;
  for (int i = threadIdx.x; i < n * XP4; i += CNT) {
    const int j = i / XP4, e = i - j * XP4;
    const int r = list[j], src = sm.csrc[r], par = r / A;
    if (src == SRC_OWN) continue;
    const int seg = e / WP4, q = e - seg * WP4;
    float4 v;
    if (src == SRC_OLD)
      v = reinterpret_cast<const float4*>(sm.beamx + par * (D + 1) * WP)[e];
    else if (seg > 0)
      v = reinterpret_cast<const float4*>(sm.pnx +
                                          (par * D + seg - 1) * WP)[q];
    else if (q % BP4 == BP4 - 1)
      continue;  // a pad
    else
      v = ldw4(wt.emb + (size_t)sm.echar[(r % A) * L] * W + q / BP4 * KCH,
               q % BP4);
    reinterpret_cast<float4*>(sm.candx + r * (D + 1) * WP)[e] = v;
  }
  for (int i = threadIdx.x; i < n * D * UPB; i += CNT) {
    const int j = i / (D * UPB), e = i - j * D * UPB;
    const int r = list[j], src = sm.csrc[r], par = r / A;
    if (src != SRC_OWN)
      sm.candc[r * D * UPB + e] =
          (src == SRC_OLD ? sm.beamc : sm.pnc)[par * D * UPB + e];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += CNT) sm.csrc[list[j]] = SRC_OWN;
}

// own_rows in the sharded plan: candidates list[0..n) get the own units
// u0.. of rows of their own (and of c), from where they are now.
template <int W, int D, int UPB, typename WT>
__device__ __forceinline__ void own_units(const Decode& p, const CSmem& sm,
                                          const int* list, int n, int u0) {
  const Weights<WT> wt = weights_of<WT>(p);
  constexpr int XU = (D + 1) * UPB;  // own units of a row
  const int A = p.A, L = p.L;
  for (int i = threadIdx.x; i < n * XU; i += CNT) {
    const int j = i / XU, e = i - j * XU;
    const int r = list[j], src = sm.csrc[r], par = r / A;
    if (src == SRC_OWN) continue;
    const int seg = e / UPB, ul = e - seg * UPB;
    float v;
    if (src == SRC_OLD)
      v = sm.beamx[par * XU + e];
    else if (seg > 0)
      v = sm.pnx[(par * D + seg - 1) * UPB + ul];
    else
      v = ldw(wt.emb + (size_t)sm.echar[(r % A) * L] * W + u0 + ul);
    sm.candx[r * XU + e] = v;
  }
  for (int i = threadIdx.x; i < n * D * UPB; i += CNT) {
    const int j = i / (D * UPB), e = i - j * D * UPB;
    const int r = list[j], src = sm.csrc[r], par = r / A;
    if (src != SRC_OWN)
      sm.candc[r * D * UPB + e] =
          (src == SRC_OLD ? sm.beamc : sm.pnc)[par * D * UPB + e];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += CNT) sm.csrc[list[j]] = SRC_OWN;
}

// sm.live[0..n) = the candidates whose alternative has a char at step s,
// in order (warp 0; n into sm.nlive[0])
__device__ __forceinline__ void live_rows(const Decode& p, const CSmem& sm,
                                          int s) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x, KA = p.K * p.A;
  int n = 0;
  for (int r0 = 0; r0 < KA; r0 += 32) {
    const int r = r0 + lane;
    const bool on = r < KA && sm.emask[(r % p.A) * p.L + s] > 0.0f;
    const unsigned ball = __ballot_sync(0xffffffffu, on);
    if (on) sm.live[n + __popc(ball & ((1u << lane) - 1u))] = r;
    n += __popc(ball);
  }
  if (lane == 0) sm.nlive[0] = n;
}

// The sharded plan: this block's units (u0..) of the chunk's rows
// first.. (the parents at step 0, else the live candidates) into buffer
// b of every block's chunk rows, onto its mbarrier 2 + b, which expects
// the rows of all units.
template <int W, int D, int CL>
__device__ __forceinline__ void send_rows(const CSmem& sm, int s, int first,
                                          int nrows, int b, int u0) {
  constexpr int UPB = W / CL, WP = W + 4 * (W / KCH), XP = (D + 1) * WP;
  constexpr int V = UPB % 4 == 0 ? 4 : 1, UV = UPB / V, RV = (D + 1) * UV;
  if (threadIdx.x == 0)
    mbar_expect(sm.bar + 2 + b, 4u * nrows * (D + 1) * W);
  const unsigned cb = smem_addr(dc_chunks(sm, W) + b * DC_RC * XP);
  const unsigned bb = smem_addr(sm.bar + 2 + b);
  const int per = nrows * RV;
  for (int i = threadIdx.x; i < per * CL; i += CNT) {
    const int k = i / per, j = i - k * per;
    const int row = j / RV, e = j - row * RV;
    const int seg = e / UV, ul = e % UV * V;
    const int r = s == 0 ? first + row : sm.live[first + row];
    const float* src = (s == 0 ? sm.beamx : sm.candx) +
                       (r * (D + 1) + seg) * UPB + ul;
    const unsigned a =
        mapa(cb + 4u * (unsigned)(row * XP + seg * WP + hpad(u0 + ul)), k);
    if constexpr (V == 4)
      st_async4(a, *reinterpret_cast<const float4*>(src), mapa(bb, k));
    else
      st_async(a, *src, mapa(bb, k));
  }
}

// Two f32 as the bf16 pair of an mma fragment register (lo in the low
// half), each rounded to nearest even.
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// Two bf16 weights as the pair of a B fragment register.
__device__ __forceinline__ uint32_t bf16_bits(const __nv_bfloat16* lo,
                                              const __nv_bfloat16* hi) {
  const unsigned short* l = reinterpret_cast<const unsigned short*>(lo);
  const unsigned short* h = reinterpret_cast<const unsigned short*>(hi);
  return (uint32_t)__ldg(l) | ((uint32_t)__ldg(h) << 16);
}
// c += A B over one m16n8k16 tile: bf16 operands, f32 sums.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Decode every edge of document d on the calling cluster of CL blocks
// (rank: this block's) in the plan SH of shared memory (false: rows,
// true: sharded); W = 16 NKB.  The final beam stays in sm.beamx (full
// rows, or the own units of them in the sharded plan) and sm.beamc (own
// units), its costs in sm.costf (every block alike).
//
// The sharded plan's differences are compile-time branches (if constexpr
// on SH), so that with SH false the compiler sees the rows plan's
// statements alone, in their order: sharing its code in other ways
// changed the rows plan's register allocation and measured it 2-3% slower
// at K=16 on an H100 (gen_beam_phases.py decode-rows).  After an edit
// here, compare the SASS of the SH=false kernels with the parent's
// (cuobjdump -sass, addresses and names aside), which must not move.
template <int NKB, int D, int CL, bool SH, typename WT>
__device__ void decode_edges_cluster(const Decode& p, const Doc& d,
                                     const CSmem& sm, int rank) {
  cg::cluster_group cluster = cg::this_cluster();
  constexpr bool BF = !std::is_same<WT, float>::value;
  constexpr int W = NKB * KCH / 2, G = 4 * W, S = (2 * D + 1) * W;
  constexpr int GS = 4 * NKB, HB = NKB / 2, UPB = W / CL;
  constexpr int WP = W + 4 * (W / KCH), XP = (D + 1) * WP, NB = W / KCH;
  constexpr int NRG = CNT / (UPB * GS);  // row groups
  constexpr int NT8 = UPB / 2;           // n8 tiles of the block (bf16)
  constexpr int XU = (D + 1) * UPB;      // own units of a row (sharded)
  const int tid = threadIdx.x, u0 = rank * UPB;
  const int A = p.A, L = p.L, K = p.K, KA = K * A, Vp = p.Vp;
  const size_t F = d.rec_field;
  const Weights<WT> wt = weights_of<WT>(p);
  // the lane: row group rg, unit ul (u), gate g, 32-term block kb
  const int rg = tid / (UPB * GS), ul_ = tid / GS % UPB, q_ = tid % GS;
  const int g_ = q_ / NKB, kb = q_ % NKB;
  // under bf16: the warp's n8 tile, the lane's fragment row gq and
  // column pair tq
  const int warp = tid >> 5, gq = (tid & 31) >> 2, tq = tid & 3;
  PHASE_INIT

  // f32: the lane's weights of every layer, wcat[l][32kb + k][gW + u];
  // bf16: the warp's B fragments of every layer and 32-term block
  // (k16 step j >> 1, rows 2tq (j even) or 2tq + 8 (j odd), column gq of
  // the tile)
  std::conditional_t<BF, uint32_t[D][NKB][4], float[D][KCH]> wr;
  if constexpr (BF) {
    if (warp < NT8) {
      const int n = warp * 8 + gq;  // the block's column
      const size_t col = (size_t)(n / UPB) * W + u0 + n % UPB;
#pragma unroll
      for (int l = 0; l < D; ++l)
#pragma unroll
        for (int b = 0; b < NKB; ++b)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int k = b * KCH + (j >> 1) * 16 + (j & 1) * 8 + 2 * tq;
            const __nv_bfloat16* w = wt.wcat + ((size_t)l * 2 * W + k) * G;
            wr[l][b][j] = bf16_bits(w + col, w + G + col);
          }
    }
  } else {
#pragma unroll
    for (int l = 0; l < D; ++l)
#pragma unroll
      for (int k = 0; k < KCH; ++k)
        wr[l][k] = __ldg(p.wcat + ((size_t)l * 2 * W + kb * KCH + k) * G +
                         g_ * W + u0 + ul_);
  }
  // the ring and the rows (sharded: the chunks' rows), pads included,
  // start at 0
  for (int i = tid; i < 2 * DC_RC * WP + (SH ? 2 * DC_RC : K + KA) * XP;
       i += CNT)
    sm.hn[i] = 0.0f;
  __syncthreads();
  if constexpr (SH) {
    for (int i = tid; i < K * XU; i += CNT) {
      const int k = i / XU, e = i - k * XU;
      sm.beamx[i] = d.state0[k * S + e / UPB * W + u0 + e % UPB];
    }
  } else {
    for (int i = tid; i < K * (D + 1) * W; i += CNT) {
      const int k = i / ((D + 1) * W), e = i - k * (D + 1) * W;
      const int seg = e / W;
      sm.beamx[k * XP + seg * WP + hpad(e - seg * W)] = d.state0[k * S + e];
    }
  }
  for (int i = tid; i < K * D * UPB; i += CNT) {
    const int k = i / (D * UPB), j = i - k * D * UPB;
    const int l = j / UPB, ul = j - l * UPB;
    sm.beamc[i] = d.state0[k * S + (1 + D + l) * W + u0 + ul];
  }
  for (int i = tid; i < D * 4 * UPB; i += CNT) {
    const int l = i / (4 * UPB), j = i - l * 4 * UPB;
    const int g = j / UPB, ul = j - g * UPB;
    sm.bias[i] = __ldg(p.bias + l * G + g * W + u0 + ul);
  }
  for (int k = tid; k < K; k += CNT) sm.costf[k] = d.cost0[k];
  for (int i = tid; i < W * p.v_real; i += CNT)
    sm.embt[i] = ldw(wt.embT + (size_t)(i / p.v_real) * Vp + i % p.v_real);
  if (tid == 0) {
    mbar_init(sm.bar);
    mbar_init(sm.bar + 1);
    if constexpr (SH) {  // the chunks' rows
      mbar_init(sm.bar + 2);
      mbar_init(sm.bar + 3);
    }
    mbar_init_fence();
  }
  int ex = 0, ax = 0;  // exchanges of h, chunks of rows (sharded) so far
  // an edge's arrays (A*L <= CNT), loaded into registers an edge ahead
  int nchar = 0, nsteps_next = 0;
  float nmask = 0.0f, nconf = 0.0f, nvalid = 0.0f;
  auto fetch = [&](int t) {
    if (t >= p.n_real) return;
    const size_t eo = (size_t)t * d.alt_stride + tid;
    if (tid < A * L) {
      nchar = d.chars[eo];
      nmask = d.mask[eo];
      nconf = d.conf[eo];
    }
    if (tid < A) nvalid = d.valid[(size_t)t * d.valid_stride + tid];
    nsteps_next = p.steps[t];
  };
  fetch(0);
  cluster.sync();  // every block of the cluster runs, its barriers ready

  for (int t = 0; t < p.E; ++t) {
    float* rec = d.rec + (size_t)t * d.rec_stride;
    if (t >= p.n_real) {
      if (rank == 0)
        for (int k = tid; k < K; k += CNT) {
          rec[k] = (float)k;
          rec[F + k] = 0.0f;
          rec[2 * F + k] = sm.costf[k];
        }
      continue;
    }
    if (tid < A * L) {
      sm.echar[tid] = nchar;
      sm.emask[tid] = nmask;
      sm.econf[tid] = nconf;
    }
    if (tid < A) sm.evalid[tid] = nvalid;
    const int nsteps = nsteps_next;
    fetch(t + 1);
    for (int r = tid; r < KA; r += CNT) {
      sm.acc[r] = 0.0f;
      sm.csrc[r] = SRC_OLD;  // a masked candidate keeps its parent's
    }
    __syncthreads();
    PHASE(0)

    // ---- the char steps: step 0 on the K parent rows, steps 1.. on
    // the candidate rows that still have chars, in chunks of DC_RC ----
    for (int s = 0; s < nsteps; ++s) {
      int n = K;
      if (s > 0) {
        live_rows(p, sm, s);
        __syncthreads();
        n = sm.nlive[0];
        if constexpr (SH)
          own_units<W, D, UPB, WT>(p, sm, sm.live, n, u0);
        else
          own_rows<W, D, UPB, WT>(p, sm, sm.live, n);
      }
      if constexpr (SH)
        if (n > 0) send_rows<W, D, CL>(sm, s, 0, min(n, DC_RC), ax & 1, u0);
      for (int first = 0; first < n; first += DC_RC) {
        const int nrows = min(n - first, DC_RC);
        // the chunk: the beam's parents first.. (step 0) or the live
        // candidates idx; their rows are their own (rows plan: at ridx in
        // rows) or, in order, the chunk's buffer once every block's units
        // are in (sharded plan: the next chunk's sent first)
        const int* idx = s == 0 ? nullptr : sm.live + first;
        const float* rows = s == 0 ? sm.beamx + first * XP : sm.candx;
        if constexpr (SH) {
          if (first + DC_RC < n)
            send_rows<W, D, CL>(sm, s, first + DC_RC,
                                min(n - first - DC_RC, DC_RC), (ax + 1) & 1,
                                u0);
          PHASE(8)
          mbar_wait(sm.bar + 2 + (ax & 1), (ax >> 1) & 1);
          PHASE(9)
          rows = dc_chunks(sm, W) + (ax & 1) * DC_RC * XP;
          ++ax;
        }
        const int* ridx = SH ? nullptr : idx;
        const float* crows = s == 0 ? sm.beamc + first * D * UPB : sm.candc;
        if (tid == 0)
          for (int l = 0; l < D; ++l)
            mbar_expect(sm.bar + ((ex + l) & 1), 4u * nrows * W);
#pragma unroll
        for (int l = 0; l < D; ++l) {
          const int buf = ex & 1;
          // the lane's x: block kb of [input | h_l]; input = xemb (layer
          // 0) or the new h of layer l-1 (the other buffer of the ring)
          const bool in_ring = kb < HB && l > 0;
          const int off = kb < HB ? kb * (KCH + 4)
                                  : (l + 1) * WP + (kb - HB) * (KCH + 4);
          const float* ring = sm.hn + (buf ^ 1) * DC_RC * WP + off;
          if constexpr (BF) {
            if (warp < NT8) {
              // the fragment rows gq and gq + 8 (pad rows read the
              // chunk's last row; their sums are not stored)
              const int r0 = min(gq, nrows - 1), r1 = min(gq + 8, nrows - 1);
              const float* x0 = rows + (ridx ? ridx[r0] : r0) * XP;
              const float* x1 = rows + (ridx ? ridx[r1] : r1) * XP;
              const float* h0 = sm.hn + (buf ^ 1) * DC_RC * WP + r0 * WP;
              const float* h1 = sm.hn + (buf ^ 1) * DC_RC * WP + r1 * WP;
              float tot[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
              for (int b = 0; b < NKB; ++b) {
                // block b of [input | h_l]: as the f32 lane's `off`
                const bool ring_b = b < HB && l > 0;
                const int off_b = b < HB ? b * (KCH + 4)
                                         : (l + 1) * WP + (b - HB) * (KCH + 4);
                const float* y0 = (ring_b ? h0 : x0) + off_b;
                const float* y1 = (ring_b ? h1 : x1) + off_b;
                float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
                for (int ks = 0; ks < 2; ++ks) {
                  const int k = ks * 16 + 2 * tq;
                  const float2 v00 = *reinterpret_cast<const float2*>(y0 + k);
                  const float2 v10 = *reinterpret_cast<const float2*>(y1 + k);
                  const float2 v01 =
                      *reinterpret_cast<const float2*>(y0 + k + 8);
                  const float2 v11 =
                      *reinterpret_cast<const float2*>(y1 + k + 8);
                  const uint32_t a[4] = {
                      bf16_pair(v00.x, v00.y), bf16_pair(v10.x, v10.y),
                      bf16_pair(v01.x, v01.y), bf16_pair(v11.x, v11.y)};
                  mma_bf16(c, a, wr[l][b][2 * ks], wr[l][b][2 * ks + 1]);
                }
#pragma unroll
                for (int i = 0; i < 4; ++i) tot[i] += c[i];
              }
              const int col = warp * 8 + 2 * tq;
              if (gq < nrows) {
                sm.zs[gq * 4 * UPB + col] = tot[0];
                sm.zs[gq * 4 * UPB + col + 1] = tot[1];
              }
              if (gq + 8 < nrows) {
                sm.zs[(gq + 8) * 4 * UPB + col] = tot[2];
                sm.zs[(gq + 8) * 4 * UPB + col + 1] = tot[3];
              }
            }
          } else {
            for (int pass = 0; pass * NRG * DC_RT < nrows; ++pass) {
              const int base = (pass * NRG + rg) * DC_RT;
              const float* xr[DC_RT];
#pragma unroll
              for (int r = 0; r < DC_RT; ++r) {
                const int row = min(base + r, nrows - 1);
                xr[r] = in_ring ? ring + row * WP
                                : rows + (ridx ? ridx[row] : row) * XP + off;
              }
              float acc[DC_RT];
#pragma unroll
              for (int r = 0; r < DC_RT; ++r) acc[r] = 0.0f;
#pragma unroll
              for (int k = 0; k < KCH; k += 4) {
#pragma unroll
                for (int r = 0; r < DC_RT; ++r) {
                  const float4 xv = *reinterpret_cast<const float4*>(xr[r] + k);
                  float a = acc[r];
                  a = fmaf(xv.x, wr[l][k], a);
                  a = fmaf(xv.y, wr[l][k + 1], a);
                  a = fmaf(xv.z, wr[l][k + 2], a);
                  a = fmaf(xv.w, wr[l][k + 3], a);
                  acc[r] = a;
                }
              }
              kb_sum<NKB, DC_RT, GS>(acc);
              if (kb == 0)
#pragma unroll
                for (int r = 0; r < DC_RT; ++r)
                  if (base + r < nrows)
                    sm.zs[(base + r) * 4 * UPB + g_ * UPB + ul_] = acc[r];
            }
          }
          __syncthreads();
          PHASE(2)
          // the own units' gate updates
          for (int i = tid; i < nrows * UPB; i += CNT) {
            const int row = i / UPB, ul = i % UPB;
            const float* z = sm.zs + row * 4 * UPB + ul;
            const float* bl = sm.bias + l * 4 * UPB + ul;
            const float zi = z[0] + bl[0];
            const float zf = z[UPB] + bl[UPB];
            const float zg = z[2 * UPB] + bl[2 * UPB];
            const float zo = z[3 * UPB] + bl[3 * UPB];
            const float* cold = crows + (idx ? idx[row] : row) * D * UPB;
            const float ig = sigm(zi);
            const float fg = sigm(zf);
            const float gg = tanhf(zg);
            const float og = sigm(zo);
            const float c2 = fg * cold[l * UPB + ul] + ig * gg;
            sm.cn[(l * DC_RC + row) * UPB + ul] = c2;
            sm.hloc[row * UPB + ul] = og * tanhf(c2);
            if constexpr (SH)  // the own unit of the row's new h
              (s == 0 ? sm.pnx + ((first + row) * D + l) * UPB
                      : sm.candx + idx[row] * XU + (l + 1) * UPB)[ul] =
                  sm.hloc[row * UPB + ul];
          }
          __syncthreads();
          PHASE(1)
          // the new h of the own units into every block, four units a
          // store where a block owns a multiple of 4
          {
            const unsigned hb = smem_addr(sm.hn + buf * DC_RC * WP);
            const unsigned bb = smem_addr(sm.bar + buf);
            constexpr int V = UPB % 4 == 0 ? 4 : 1, UV = UPB / V;
            const int per = nrows * UV;
            for (int i = tid; i < per * CL; i += CNT) {
              const int k = i / per, j = i - k * per;
              const int row = j / UV, ul = j % UV * V;
              const unsigned a = mapa(
                  hb + 4u * (unsigned)(row * WP + hpad(u0 + ul)), k);
              if constexpr (V == 4)
                st_async4(a,
                          *reinterpret_cast<const float4*>(
                              sm.hloc + row * UPB + ul),
                          mapa(bb, k));
              else
                st_async(a, sm.hloc[row * UPB + ul], mapa(bb, k));
            }
          }
          PHASE(3)
          mbar_wait(sm.bar + buf, (ex >> 1) & 1);  // every unit's h
          ++ex;
          PHASE(4)
          // the layer's new h into the chunk's rows (the parents' new
          // rows at step 0; rows plan): before this block's next send,
          // after which the ring's buffer may change
          if constexpr (!SH) {
            const float4* hb =
                reinterpret_cast<const float4*>(sm.hn + buf * DC_RC * WP);
            for (int i = tid; i < nrows * (WP / 4); i += CNT) {
              const int row = i / (WP / 4), e = i % (WP / 4);
              float* dst = s == 0 ? sm.pnx + ((first + row) * D + l) * WP
                                  : sm.candx + idx[row] * XP + (l + 1) * WP;
              reinterpret_cast<float4*>(dst)[e] = hb[row * (WP / 4) + e];
            }
          }
        }
        // the tied softmax of this block's rows (row = rank + CL*ri): a
        // logit's 32-term blocks on threads of their own, then added in
        // block order
        const float* htop = sm.hn + ((ex - 1) & 1) * DC_RC * WP;
        const int nmine = rank < nrows ? (nrows - rank + CL - 1) / CL : 0;
        const int vr = p.v_real;
        for (int i = tid; i < nmine * NB * vr; i += CNT) {
          const int ri = i / (NB * vr), j = i - ri * NB * vr;
          const int blk = j / vr, v = j - blk * vr;
          const float* h = htop + (rank + CL * ri) * WP + blk * (KCH + 4);
          const float* e = sm.embt + blk * KCH * vr + v;
          float a = 0.0f;
#pragma unroll
          for (int k = 0; k < KCH; ++k) a = fmaf(opnd<WT>(h[k]), e[k * vr], a);
          sm.lgt[(ri * NB + blk) * Vp + v] = a;
        }
        __syncthreads();
        for (int i = tid; i < nmine * vr; i += CNT) {
          const int ri = i / vr, v = i - ri * vr;
          float* lg = sm.lgt + ri * NB * Vp + v;
          float tot = lg[0];
#pragma unroll
          for (int blk = 1; blk < NB; ++blk) tot = tot + lg[blk * Vp];
          lg[0] = tot;
        }
        __syncthreads();
        const int lane = tid & 31, warp = tid >> 5;
        for (int ri = warp; ri < nmine; ri += CNT / 32) {
          const float* lg = sm.lgt + ri * NB * Vp;
          float mx = -INFINITY;
          for (int v = lane; v < vr; v += 32) mx = fmaxf(mx, lg[v]);
          for (int o = 16; o > 0; o >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
          float sum = 0.0f;
          for (int v = lane; v < vr; v += 32) sum += expf(lg[v] - mx);
          for (int o = 16; o > 0; o >>= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, o);
          if (lane == 0) sm.lse[ri] = mx + logf(sum);
        }
        __syncthreads();
        PHASE(5)
        // the owner's cost terms, into every block's copy of the costs
        if (s == 0) {
          for (int i = tid; i < nmine * A; i += CNT) {
            const int ri = i / A, a = i - ri * A;
            const int r = (first + rank + CL * ri) * A + a;
            const float m = sm.emask[a * L];
            if (m > 0.0f) {
              const float nll2 =
                  (sm.lse[ri] - sm.lgt[ri * NB * Vp + sm.echar[a * L]]) *
                  INV_LN2F;
              const float v =
                  sm.acc[r] + m * (p.lw * nll2 + p.lw1 * sm.econf[a * L]);
              for (int k = 0; k < CL; ++k)
                cluster.map_shared_rank(sm.acc, k)[r] = v;
            }
          }
        } else {
          for (int ri = tid; ri < nmine; ri += CNT) {
            const int r = idx[rank + CL * ri], a = r % A;
            const float m = sm.emask[a * L + s];
            const float nll2 =
                (sm.lse[ri] - sm.lgt[ri * NB * Vp + sm.echar[a * L + s]]) *
                INV_LN2F;
            const float v =
                sm.acc[r] + m * (p.lw * nll2 + p.lw1 * sm.econf[a * L + s]);
            for (int k = 0; k < CL; ++k)
              cluster.map_shared_rank(sm.acc, k)[r] = v;
          }
        }
        // the rest of the chunk's new state: c of the own units (of the
        // parents at step 0), xemb of the char taken (steps 1..)
        for (int i = tid; i < nrows * D * UPB; i += CNT) {
          const int row = i / (D * UPB), e = i % (D * UPB);
          const float v = sm.cn[(e / UPB * DC_RC + row) * UPB + e % UPB];
          if (s == 0)
            sm.pnc[(first + row) * D * UPB + e] = v;
          else
            sm.candc[idx[row] * D * UPB + e] = v;
        }
        if (s > 0) {
          if constexpr (SH) {
            for (int i = tid; i < nrows * UPB; i += CNT) {
              const int row = i / UPB, ul = i % UPB, r = idx[row];
              sm.candx[r * XU + ul] = ldw(
                  wt.emb + (size_t)sm.echar[(r % A) * L + s] * W + u0 + ul);
            }
          } else {
            for (int i = tid; i < nrows * W; i += CNT) {
              const int row = i / W, e = i % W, r = idx[row];
              sm.candx[r * XP + hpad(e)] =
                  ldw(wt.emb + (size_t)sm.echar[(r % A) * L + s] * W + e);
            }
          }
        }
        __syncthreads();
        PHASE(6)
      }
      if (s == 0)  // the candidates with a char at step 0 take it
        for (int r = tid; r < KA; r += CNT)
          if (sm.emask[(r % A) * L] > 0.0f) sm.csrc[r] = SRC_NEW;
      cluster.sync();  // the step's costs, from every block
      PHASE(7)
    }

    // ---- exact top-K by (total, candidate index), in every block ----
    for (int r = tid; r < KA; r += CNT)
      sm.total[r] = sm.evalid[r % A] > 0.5f ? sm.costf[r / A] + sm.acc[r]
                                            : BIGF;
    __syncthreads();
    for (int r = tid; r < KA; r += CNT) {
      const float tr = sm.total[r];
      int rank_r = 0;
      for (int j = 0; j < KA; ++j) {
        const float tj = sm.total[j];
        rank_r += (tj < tr) || (tj == tr && j < r);
      }
      if (rank_r < K) sm.sel[rank_r] = r;
    }
    __syncthreads();
    for (int k = tid; k < K; k += CNT) {
      const int r = sm.sel[k];
      if (rank == 0) {
        rec[k] = (float)(r / A);
        rec[F + k] = (float)(r % A);
        rec[2 * F + k] = sm.total[r];
      }
      sm.costf[k] = sm.total[r];
    }
    // the chosen candidates' rows, then the new beam
    if constexpr (SH) {
      own_units<W, D, UPB, WT>(p, sm, sm.sel, K, u0);
      __syncthreads();
      for (int i = tid; i < K * XU; i += CNT) {
        const int k = i / XU;
        sm.beamx[i] = sm.candx[sm.sel[k] * XU + i % XU];
      }
    } else {
      own_rows<W, D, UPB, WT>(p, sm, sm.sel, K);
      __syncthreads();
      for (int i = tid; i < K * XP / 4; i += CNT) {
        const int k = i / (XP / 4), e = i % (XP / 4);
        reinterpret_cast<float4*>(sm.beamx + k * XP)[e] =
            reinterpret_cast<const float4*>(sm.candx + sm.sel[k] * XP)[e];
      }
    }
    for (int i = tid; i < K * D * UPB; i += CNT) {
      const int k = i / (D * UPB);
      sm.beamc[i] = sm.candc[sm.sel[k] * D * UPB + i % (D * UPB)];
    }
    __syncthreads();
    PHASE(0)
  }
  PHASE_FLUSH
  __syncthreads();
}

// The final beam's rows into state (K, S): this block's units of xemb, h
// and c, from the rows of plan SH.
template <bool SH>
__device__ void cluster_write_state(const Decode& p, const CSmem& sm,
                                    float* state, int CL, int rank) {
  const int K = p.K, D = p.D, W = p.W, S = (2 * D + 1) * W;
  const int WP = padded_width(W), XP = (D + 1) * WP, upb = W / CL;
  const int u0 = rank * upb;
  for (int i = threadIdx.x; i < K * (2 * D + 1) * upb; i += CNT) {
    const int ul = i % upb, rest = i / upb;
    const int seg = rest % (2 * D + 1), k = rest / (2 * D + 1);
    const int u = u0 + ul;
    state[(size_t)k * S + seg * W + u] =
        seg <= D ? sm.beamx[SH ? (k * (D + 1) + seg) * upb + ul
                               : k * XP + seg * WP + hpad(u)]
                 : sm.beamc[(k * D + seg - 1 - D) * upb + ul];
  }
}

// f(integral_constant NKB, integral_constant D, integral_constant CL,
// bool_constant SH) for a shape decode_cluster_ok takes (W = 16 NKB;
// only the sizes whose row group fits a block are instantiated, and the
// sharded plan at W=128 only: with A=4 the rows plan fits a block at
// every smaller width)
template <typename F>
static int dispatch_cluster(int W, int D, int CL, bool shard, F&& f) {
  using std::integral_constant;
  auto by_cl = [&](auto nkbc, auto dc) -> int {
    constexpr int NKB = decltype(nkbc)::value;
    auto one = [&](auto clc) -> int {
      constexpr int C = decltype(clc)::value;
      if constexpr (NKB * 16 / C * 4 * NKB <= CNT) {
        if (!shard) return f(nkbc, dc, clc, std::false_type{});
        if constexpr (NKB == 8) return f(nkbc, dc, clc, std::true_type{});
      }
      return (int)cudaErrorInvalidValue;
    };
    if (CL == 4) return one(integral_constant<int, 4>{});
    if (CL == 8) return one(integral_constant<int, 8>{});
    return one(integral_constant<int, 16>{});
  };
  auto by_d = [&](auto nkbc) -> int {
    if (D == 1) return by_cl(nkbc, integral_constant<int, 1>{});
    return by_cl(nkbc, integral_constant<int, 2>{});
  };
  if (!decode_cluster_ok(W, D, CL, 1)) return (int)cudaErrorInvalidValue;
  if (W == 32) return by_d(integral_constant<int, 2>{});
  if (W == 64) return by_d(integral_constant<int, 4>{});
  return by_d(integral_constant<int, 8>{});
}

// The launch of kern on `clusters` clusters of cl blocks of CNT threads,
// or, with `fits`, how many such clusters the card holds at once.
template <typename Kern, typename... Args>
static int decode_cluster_launch(Kern kern, int cl, int clusters,
                                 size_t smem, cudaStream_t stream, int* fits,
                                 Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && cl > 8)  // 16 blocks exceed the portable 8
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl * clusters);
  cfg.blockDim = dim3(CNT);
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
  err = cudaLaunchKernelEx(&cfg, kern, args...);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
