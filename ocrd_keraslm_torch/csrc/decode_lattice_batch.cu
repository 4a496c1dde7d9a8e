// Document-batched lattice beam decode for Hopper (sm_90a), and the
// backpointer walk of its records.
//
// Replaces the TPU kernel ocrd_keraslm_tpu/ops/decode_kernel.py::
// decode_lattice_pallas_batch (and, on the card, the jitted
// walk_records_batch beside it).  N independent documents decode in one
// launch with the per-document semantics of decode_lattice.cu: the same
// cost model, the same exact top K by (total cost, candidate index)
// within each document, identity records for pad edges t >= n_real.
//
// What bounds it on this card: the recurrence.  Inside a document edge
// t+1 waits for edge t's top K and char step s+1 for step s (see
// decode_lattice.cu).  The TPU kernel stacks N documents in the rows of
// one matrix unit; here documents need no rows in common: they need more
// SMs.
//
// What the design does about it: one thread-block cluster of CL blocks
// per document (decode_edges_cluster of decode_common.cuh, in its rows
// or its sharded plan, the kernel's template parameter SH; the wrapper
// chooses CL from N and from the clusters the card holds at once), or,
// where the cluster layout does not take the shape or the wrapper asks
// cl = 1, one block of 512 threads per document (decode_edges, the first
// port's code, candidate rows in the document's slice of a global
// scratch (N, K*A, S)), each on its own slice.  Nothing is shared between
// documents, so nothing needs a grid barrier, and a cluster never waits
// on another document's; a batch larger than the card holds at once runs
// in waves.  Because every document runs the same device code with the
// same A, L, K and per-edge steps as decode_lattice.cu, and both layouts
// give the same bits, its records and final beam equal those of a
// single-document launch bit for bit, whatever CL either took.  A
// batch's wall is close to that of its longest document.
//
// walk_records_batch_kernel walks a block's records in reverse from each
// document's start slot k_in[n] and writes the chosen alternative and the
// cumulative cost per edge, (N, E, 2), and the slot it reached, k_out[n],
// which starts the walk of the block before.  Its bytes are nothing
// (~655 kB for 32 documents of 1024 edges); what bounds it is the chain
// of E dependent reads.  One block per document: the document's E*K
// backpointers are copied into shared memory as bytes by independent
// loads, several in flight a thread; the chain then runs in shared
// memory, cut into segments: every (segment, entry slot) pair walks its
// segment to the slot it leaves at, one thread chains the segments' exit
// slots from k_in[n], and one thread a segment walks it again from its
// entry slot, storing each step's slot; last every thread gathers the
// alternative and cost of its steps.
// With f32 weights all arithmetic is f32 on CUDA cores: no TF32, no bf16.
// With bf16 weights (bf16 != 0 in decode_lattice_batch_launch: the TPU
// kernel's bf16 instantiation) every document runs the bf16 device code
// of decode_common.cuh, as decode_lattice.cu does: the cluster layout's
// gate products on the tensor cores; a document's records and beam equal
// a single-document bf16 launch's bit for bit.  Bound: the f32 kernel's
// operations at the bf16 tensor-core rate (989 TFLOP/s).

#include "decode_common.cuh"

struct BatchIO {
  const int* chars;    // (E, N*A, L)
  const float* mask;   // (E, N*A, L)
  const float* conf;   // (E, N*A, L)
  const float* valid;  // (E, N*A)
  const float* state0; // (N*K, S)
  const float* cost0;  // (N*K,)
  float* records;      // (E, 3, N*K)
  float* stateF;       // (N*K, S)
  float* costF;        // (N*K,)
  float* stateE;       // (N, K*A, S) scratch of the one-block kernel
};

// Document n's arrays as decode_edges reads them.
__device__ Doc batch_doc(const Decode& p, const BatchIO& io, int n, int N) {
  const int A = p.A, L = p.L, K = p.K;
  const int S = (2 * p.D + 1) * p.W;
  Doc d;
  d.chars = io.chars + (size_t)n * A * L;
  d.mask = io.mask + (size_t)n * A * L;
  d.conf = io.conf + (size_t)n * A * L;
  d.alt_stride = (size_t)N * A * L;
  d.valid = io.valid + (size_t)n * A;
  d.valid_stride = (size_t)N * A;
  d.state0 = io.state0 + (size_t)n * K * S;
  d.cost0 = io.cost0 + (size_t)n * K;
  d.rec = io.records + (size_t)n * K;
  d.rec_stride = (size_t)3 * N * K;
  d.rec_field = (size_t)N * K;
  d.stateE = io.stateE + (size_t)n * K * A * S;
  return d;
}

template <typename WT>
__global__ void __launch_bounds__(NT, 1)
    decode_lattice_batch_kernel(Decode p, BatchIO io) {
  extern __shared__ float4 smem4[];
  const int n = blockIdx.x, N = gridDim.x, tid = threadIdx.x;
  const int K = p.K;
  const int S = (2 * p.D + 1) * p.W;
  const Smem sm = carve_smem(p, reinterpret_cast<float*>(smem4));
  decode_edges<WT>(p, batch_doc(p, io, n, N), sm);

  for (int i = tid; i < K * S; i += NT)
    io.stateF[(size_t)n * K * S + i] = sm.beam[i];
  for (int k = tid; k < K; k += NT) io.costF[(size_t)n * K + k] = sm.costf[k];
}

// Document n on cluster n of CL blocks, in the plan SH of shared memory
// (false: rows, true: sharded; see decode_edges_cluster).
template <int NKB, int D, int CL, bool SH, typename WT>
__global__ void __launch_bounds__(CNT, 1)
    decode_lattice_batch_cluster_kernel(Decode p, BatchIO io) {
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n = (int)blockIdx.x / CL, N = (int)gridDim.x / CL;
  const int K = p.K, S = (2 * D + 1) * p.W;
  const CSmem sm = carve_cluster_smem<SH>(p, smem4, CL);
  const Doc d = batch_doc(p, io, n, N);
  decode_edges_cluster<NKB, D, CL, SH, WT>(p, d, sm, rank);
  cluster_write_state<SH>(p, sm, io.stateF + (size_t)n * K * S, CL, rank);
  if (rank == 0)
    for (int k = threadIdx.x; k < K; k += CNT)
      io.costF[(size_t)n * K + k] = sm.costf[k];
  cluster.sync();  // no block leaves while another may still read it
}

#define WALK_NT 512     // threads a document
#define WALK_UNROLL 8   // backpointer loads in flight a thread
#define WALK_SEGS 64    // segments of the chain, at most

// segments of the chain: (segment, entry slot) pairs fill the block
__host__ __device__ inline int walk_segments(int K) {
  const int g = WALK_NT / K;
  return g < WALK_SEGS ? g : WALK_SEGS;
}

// bytes of dynamic shared memory a document's block asks: each step's
// slot, the segments' exit and entry slots, the backpointers as bytes
extern "C" size_t walk_records_batch_smem_bytes(int E, int K) {
  const int G = walk_segments(K);
  return (size_t)4 * (E + G * K + G) + (size_t)E * K;
}

__global__ void __launch_bounds__(WALK_NT)
    walk_records_batch_kernel(const float* records, const int* k_in,
                              int* k_out, float* walks, int N, int E,
                              int K) {
  extern __shared__ int wsm[];
  const int n = blockIdx.x, tid = threadIdx.x;
  const size_t NK = (size_t)N * K;
  const int G = walk_segments(K), L = (E + G - 1) / G, EK = E * K;
  int* slot = wsm;        // (E) the slot each step's walk is at
  int* ex = slot + E;     // (G, K) each segment's exit slot, by entry
  int* entry = ex + G * K;  // (G) each segment's entry slot
  unsigned char* bp = reinterpret_cast<unsigned char*>(entry + G);
  for (int i0 = tid; i0 < EK; i0 += WALK_NT * WALK_UNROLL) {
    float v[WALK_UNROLL];
#pragma unroll
    for (int u = 0; u < WALK_UNROLL; ++u) {
      const int i = i0 + u * WALK_NT;
      v[u] = i < EK ? __ldg(records + (size_t)(i / K) * 3 * NK +
                            (size_t)n * K + i % K)
                    : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < WALK_UNROLL; ++u) {
      const int i = i0 + u * WALK_NT;
      if (i < EK) bp[i] = (unsigned char)(int)v[u];
    }
  }
  __syncthreads();
  if (tid < G * K) {  // segment g covers steps [g*L, (g+1)*L)
    const int g = tid / K, lo = g * L, hi = min(lo + L, E);
    int k = tid - g * K;
    for (int t = hi - 1; t >= lo; --t) k = bp[t * K + k];
    ex[tid] = k;
  }
  __syncthreads();
  if (tid == 0) {
    int k = k_in[n];
    for (int g = G - 1; g >= 0; --g) {
      entry[g] = k;
      k = ex[g * K + k];
    }
    k_out[n] = k;
  }
  __syncthreads();
  if (tid < G) {
    const int lo = tid * L, hi = min(lo + L, E);
    int k = entry[tid];
    for (int t = hi - 1; t >= lo; --t) {
      slot[t] = k;
      k = bp[t * K + k];
    }
  }
  __syncthreads();
  for (int t = tid; t < E; t += WALK_NT) {
    const float* rec = records + (size_t)t * 3 * NK + (size_t)n * K + slot[t];
    walks[((size_t)n * E + t) * 2] = rec[NK];
    walks[((size_t)n * E + t) * 2 + 1] = rec[2 * NK];
  }
}

// bytes of dynamic shared memory a block asks: the one-block kernel's
// plan (cl 1) or the cluster layout's (its sharded plan with shard)
extern "C" size_t decode_lattice_batch_smem_bytes(int A, int L, int K, int D,
                                                  int W, int Vp, int vr,
                                                  int cl, int shard) {
  if (cl > 1)
    return decode_cluster_smem_bytes(A, L, K, D, W, Vp, vr, cl, shard != 0);
  return decode_smem_floats(A, L, K, D, W, Vp,
                            decode_chunk_rows(A, L, K, D, W, Vp)) * 4;
}

// the cluster launch of N documents in the rows plan or the sharded one
// (or, with fits, how many such clusters the card holds at once; refuses
// a layout decode_cluster_ok does not take), with f32 or bf16 weights
static int batch_cluster_run(const Decode& p, const BatchIO& io, int N,
                             int cl, bool shard, bool bf16,
                             cudaStream_t stream, int* fits) {
  if (!decode_cluster_ok(p.W, p.D, cl, p.A * p.L) || p.K > RBMAX)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      decode_cluster_smem_bytes(p.A, p.L, p.K, p.D, p.W, p.Vp, p.v_real,
                                cl, shard);
  return dispatch_cluster(p.W, p.D, cl, shard, [&](auto nkbc, auto dc,
                                                   auto clc, auto shc) {
    constexpr int NKB = decltype(nkbc)::value, D = decltype(dc)::value;
    constexpr int C = decltype(clc)::value;
    constexpr bool SH = decltype(shc)::value;
    if (bf16)
      return decode_cluster_launch(
          decode_lattice_batch_cluster_kernel<NKB, D, C, SH, __nv_bfloat16>,
          cl, N, smem, stream, fits, p, io);
    return decode_cluster_launch(
        decode_lattice_batch_cluster_kernel<NKB, D, C, SH, float>, cl, N,
        smem, stream, fits, p, io);
  });
}

// How many clusters of cl blocks of the cluster layout the card holds at
// once (0 where the layout does not take the shape or it does not fit).
extern "C" int decode_lattice_batch_max_clusters(int A, int L, int K, int D,
                                                 int W, int Vp, int vr,
                                                 int cl, int shard,
                                                 int bf16) {
  Decode p{};
  p.A = A, p.L = L, p.K = K, p.D = D, p.W = W, p.Vp = Vp, p.v_real = vr;
  const BatchIO io{};
  int fits = 0;
  return batch_cluster_run(p, io, 1, cl, shard != 0, bf16 != 0, 0,
                           &fits) == 0
             ? fits
             : 0;
}

// The one-block launch of N documents with the kernel of weight type WT.
template <typename WT>
static int batch_one_block_run(const Decode& p, const BatchIO& io, int N,
                               size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      decode_lattice_batch_kernel<WT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_lattice_batch_kernel<WT><<<N, NT, smem, stream>>>(p, io);
  return (int)cudaGetLastError();
}

// emb, embT and wcat: float (bf16 == 0) or __nv_bfloat16 (bf16 != 0)
extern "C" int decode_lattice_batch_launch(
    const void* emb, const void* embT, const void* wcat,
    const float* bias, const int* chars, const float* mask,
    const float* conf, const float* valid, const int* steps,
    const float* state0, const float* cost0, float* records, float* stateF,
    float* costF, float* stateE, int N, int E, int n_real, int A, int L,
    int K, int D, int W, int Vp, int v_real, float lw, float lw1, int cl,
    int shard, int bf16, void* stream) {
  const int rb = decode_chunk_rows(A, L, K, D, W, Vp);
  const float* f32[3] = {nullptr, nullptr, nullptr};
  const __nv_bfloat16* b16[3] = {nullptr, nullptr, nullptr};
  if (bf16) {
    b16[0] = static_cast<const __nv_bfloat16*>(emb);
    b16[1] = static_cast<const __nv_bfloat16*>(embT);
    b16[2] = static_cast<const __nv_bfloat16*>(wcat);
  } else {
    f32[0] = static_cast<const float*>(emb);
    f32[1] = static_cast<const float*>(embT);
    f32[2] = static_cast<const float*>(wcat);
  }
  const Decode p{f32[0], f32[1], f32[2], bias, steps, E, n_real, A, L, K,
                 D, W, Vp, v_real, rb, lw, lw1, b16[0], b16[1], b16[2]};
  const BatchIO io{chars, mask, conf, valid, state0, cost0, records,
                   stateF, costF, stateE};
  if (cl > 1)
    return batch_cluster_run(p, io, N, cl, shard != 0, bf16 != 0,
                             (cudaStream_t)stream, nullptr);
  const size_t smem = decode_smem_floats(A, L, K, D, W, Vp, rb) * 4;
  return bf16 ? batch_one_block_run<__nv_bfloat16>(p, io, N, smem,
                                                   (cudaStream_t)stream)
              : batch_one_block_run<float>(p, io, N, smem,
                                           (cudaStream_t)stream);
}

extern "C" int walk_records_batch_launch(const float* records,
                                         const int* k_in, int* k_out,
                                         float* walks, int N, int E, int K,
                                         void* stream) {
  if (K < 1 || K > 255 || E < 0) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const size_t smem = walk_records_batch_smem_bytes(E, K);
  if (smem > 48 * 1024) {  // above the default: E*K > ~40k
    const cudaError_t err = cudaFuncSetAttribute(
        walk_records_batch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  walk_records_batch_kernel<<<N, WALK_NT, smem, (cudaStream_t)stream>>>(
      records, k_in, k_out, walks, N, E, K);
  return (int)cudaGetLastError();
}
