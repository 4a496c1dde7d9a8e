// Device code shared by the lattice decode kernels (decode_lattice.cu,
// one document a launch, and decode_lattice_batch.cu, one document a
// block): the LSTM stack with the tied softmax over a chunk of rows, the
// per-edge beam step and the shared-memory plan.  Both kernels run
// decode_edges on their document, so a document's records and final
// beam do not depend on which kernel decoded it.
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
// All arithmetic is f32 on CUDA cores: no TF32, no bf16.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

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
};

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
#define KCH 32
template <int RB>
__device__ void matmul_rows(const float* __restrict__ x, int S,
                            int kdim, const float* __restrict__ w,
                            int ncols, const float* __restrict__ b,
                            float* out) {
  for (int j = threadIdx.x; j < ncols; j += NT) {
    for (int i0 = 0; i0 < kdim; i0 += KCH) {
      float acc[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) acc[r] = 0.0f;
      const int i1 = min(i0 + KCH, kdim);
      for (int i = i0; i < i1; i += 4) {
        const float w0 = __ldg(w + (size_t)(i + 0) * ncols + j);
        const float w1 = __ldg(w + (size_t)(i + 1) * ncols + j);
        const float w2 = __ldg(w + (size_t)(i + 2) * ncols + j);
        const float w3 = __ldg(w + (size_t)(i + 3) * ncols + j);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float4 xv =
              *reinterpret_cast<const float4*>(x + r * S + i);
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
template <int RB>
__device__ void chunk_step(const Decode& p, float* xs, float* zb,
                           float* lse) {
  const int W = p.W, D = p.D, S = (2 * D + 1) * W, G = 4 * W;
  for (int d = 0; d < D; ++d) {
    matmul_rows<RB>(xs + d * W, S, 2 * W, p.wcat + (size_t)d * 2 * W * G,
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
  matmul_rows<RB>(xs + D * W, S, W, p.embT, p.Vp, nullptr, zb);
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

__device__ void run_chunk(const Decode& p, int nrows, float* xs, float* zb,
                          float* lse) {
  if (nrows <= 8)
    chunk_step<8>(p, xs, zb, lse);
  else if (nrows <= 16)
    chunk_step<16>(p, xs, zb, lse);
  else
    chunk_step<32>(p, xs, zb, lse);
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
__device__ void decode_edges(const Decode& p, const Doc& d, const Smem& sm) {
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
        run_chunk(p, nrows, xs, zb, lse);
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
            v = e < W ? __ldg(p.emb + (size_t)echar[a * L] * W + e)
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
        run_chunk(p, nrows, xs, zb, lse);
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
              e < W ? __ldg(p.emb + (size_t)echar[a * L + s] * W + e)
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
