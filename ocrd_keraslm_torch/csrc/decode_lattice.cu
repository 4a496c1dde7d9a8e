// Single-document lattice beam decode for Hopper (sm_90a).
//
// Replaces the TPU kernel ocrd_keraslm_tpu/ops/decode_kernel.py::
// decode_lattice_pallas.  Same semantics, same packed outputs: for each
// real edge t < n_real every beam row [xemb | h_0..h_{D-1} | c_0..c_{D-1}]
// expands into A candidates (r = k*A + a), runs up to alt_steps[t]
// masked char steps of the D-layer LSTM plus the tied-softmax -log2 p,
// and the exact top K by (total cost, candidate index) becomes the next
// beam.  Pad edges t >= n_real are written in closed form as identity.
//
// What bounds it on this card: the recurrence.  Edge t+1 cannot start
// before edge t's top-K is known, and within an edge step s+1 needs step
// s, so the only parallelism is across the rows and gate columns of one
// step: at most K*A = 64 rows x 4W = 512 columns at full width.  The
// f32 work per edge is ~4.5 MFMA for a one-char edge, far too little to
// spread over 132 SMs with a grid-wide barrier per step.  So one thread
// block decodes the whole document and the kernel is bound by one SM's
// f32 FMA rate (1/132 of the card's 67 TFLOP/s), not by memory: the
// weights (1 MiB at W=128) stay L2-resident and are re-read per step.
//
// What the design does about it: the document runs on one thread-block
// cluster of CL (8 or 16) blocks, decode_edges_cluster of
// decode_common.cuh: each block keeps its units' gate columns of every
// layer in registers for the whole launch and computes only their gates,
// the new h goes to every block over distributed shared memory, the tied
// softmax splits the rows over the blocks, and the top K runs in every
// block alike; each block holds every row of the beam and of the K*A
// candidates where that fits its shared memory (the rows plan), else
// (K=32 at W=128) only its own units of them, the chunk's rows sent to
// every block before its products (the sharded plan: shard from the
// wrapper, the template parameter SH of the one cluster kernel and
// device function).  Shapes the cluster layout does not take (and cl = 1
// from the wrapper) run the first port's one-block kernel, decode_edges:
// one block of 512 threads loops over the edges (beam in shared memory,
// candidate rows in a global scratch buffer that the wrapper allocates,
// step 0 on the parent rows, blocked 32-term sums, rank-count top K).
// decode_lattice_batch.cu runs the same device code one cluster (or
// block) per document.  With f32 weights all arithmetic is f32 on CUDA
// cores: no TF32, no bf16.
//
// With bf16 weights (bf16 != 0 in decode_lattice_launch: the TPU
// kernel's bf16 instantiation, the JAX package's opt-in bf16 decode
// mode) the same layouts run the bf16 instantiation of the device code:
// the cluster layout's gate products on the tensor cores (mma.sync
// m16n8k16, bf16 operands, f32 sums), the one-block layout's over
// bf16-rounded operands on CUDA cores; the state and the costs stay f32.
// Bound: the f32 kernel's operations at the bf16 tensor-core rate
// (989 TFLOP/s), 0.0194 ms for a page of 617 edges at K=16.

#include "decode_common.cuh"

struct Params {
  Decode p;
  const int* chars;    // (E, A, L)
  const float* mask;   // (E, A, L)
  const float* conf;   // (E, A, L)
  const float* valid;  // (E, A)
  const float* state0; // (K, S)
  const float* cost0;  // (LANE,)
  float* records;      // (E+1, 3K)
  float* walk;         // (E+1, 2) or null
  float* stateF;       // (K, S)
  float* costF;        // (LANE,)
  float* stateE;       // (K*A, S) scratch of the one-block kernel
};

// costF, the records' header row and the device walk (block 0, of nt
// threads)
__device__ void single_tail(const Params& q, const float* costf, int nt) {
  const Decode& p = q.p;
  const int tid = threadIdx.x, K = p.K;
  for (int l = tid; l < LANE; l += nt)
    q.costF[l] = l < K ? costf[l] : (p.n_real > 0 ? BIGF : q.cost0[l]);
  for (int i = tid; i < 3 * K; i += nt) {
    float v = i >= 2 * K ? q.cost0[i - 2 * K] : 0.0f;
    if (i == 0) {
      v = BIGF;
      for (int k = 0; k < K; ++k) v = fminf(v, q.cost0[k]);
    }
    q.records[i] = v;
  }
  if (q.walk != nullptr && tid == 0) {
    int k = 0;
    for (int t = p.E - 1; t >= 0; --t) {
      const float* rec = q.records + (size_t)(t + 1) * 3 * K;
      q.walk[(t + 1) * 2] = rec[K + k];
      q.walk[(t + 1) * 2 + 1] = rec[2 * K + k];
      k = (int)rec[k];
    }
    q.walk[0] = q.cost0[k];
    q.walk[1] = 0.0f;
  }
}

// The document's arrays as decode_edges reads them.
__device__ Doc single_doc(const Params& q) {
  const int A = q.p.A, L = q.p.L, K = q.p.K;
  Doc d;
  d.chars = q.chars;
  d.mask = q.mask;
  d.conf = q.conf;
  d.alt_stride = (size_t)A * L;
  d.valid = q.valid;
  d.valid_stride = A;
  d.state0 = q.state0;
  d.cost0 = q.cost0;
  d.rec = q.records + 3 * K;  // after the header row
  d.rec_stride = 3 * K;
  d.rec_field = K;
  d.stateE = q.stateE;
  return d;
}

template <typename WT>
__global__ void __launch_bounds__(NT, 1) decode_lattice_kernel(Params q) {
  extern __shared__ float4 smem4[];
  const Decode& p = q.p;
  const int tid = threadIdx.x;
  const int K = p.K;
  const int S = (2 * p.D + 1) * p.W;
  const Smem sm = carve_smem(p, reinterpret_cast<float*>(smem4));
  decode_edges<WT>(p, single_doc(q), sm);

  for (int i = tid; i < K * S; i += NT) q.stateF[i] = sm.beam[i];
  single_tail(q, sm.costf, NT);
}

// The document on one cluster of CL blocks, in the plan SH of shared
// memory (false: rows, true: sharded; see decode_edges_cluster).
template <int NKB, int D, int CL, bool SH, typename WT>
__global__ void __launch_bounds__(CNT, 1)
    decode_lattice_cluster_kernel(Params q) {
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const CSmem sm = carve_cluster_smem<SH>(q.p, smem4, CL);
  decode_edges_cluster<NKB, D, CL, SH, WT>(q.p, single_doc(q), sm, rank);
  cluster_write_state<SH>(q.p, sm, q.stateF, CL, rank);
  if (rank == 0) single_tail(q, sm.costf, CNT);
  cluster.sync();  // no block leaves while another may still read it
}

// bytes of dynamic shared memory a block asks: the one-block kernel's
// plan (cl 1) or the cluster layout's (its sharded plan with shard)
extern "C" size_t decode_lattice_smem_bytes(int A, int L, int K, int D,
                                            int W, int Vp, int vr, int cl,
                                            int shard) {
  if (cl > 1)
    return decode_cluster_smem_bytes(A, L, K, D, W, Vp, vr, cl, shard != 0);
  return decode_smem_floats(A, L, K, D, W, Vp,
                            decode_chunk_rows(A, L, K, D, W, Vp)) * 4;
}

// the cluster launch of one document in the rows plan or the sharded
// one (or, with fits, how many such clusters the card holds at once;
// refuses a layout decode_cluster_ok does not take), with f32 or bf16
// weights
static int cluster_run(const Params& q, int cl, bool shard, bool bf16,
                       cudaStream_t stream, int* fits) {
  const Decode& p = q.p;
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
          decode_lattice_cluster_kernel<NKB, D, C, SH, __nv_bfloat16>, cl, 1,
          smem, stream, fits, q);
    return decode_cluster_launch(
        decode_lattice_cluster_kernel<NKB, D, C, SH, float>, cl, 1, smem,
        stream, fits, q);
  });
}

// How many clusters of cl blocks of the cluster layout the card holds at
// once (0 where the layout does not take the shape or it does not fit).
extern "C" int decode_lattice_max_clusters(int A, int L, int K, int D,
                                           int W, int Vp, int vr, int cl,
                                           int shard, int bf16) {
  Params q{};
  q.p.A = A, q.p.L = L, q.p.K = K, q.p.D = D, q.p.W = W, q.p.Vp = Vp;
  q.p.v_real = vr;
  int fits = 0;
  return cluster_run(q, cl, shard != 0, bf16 != 0, 0, &fits) == 0 ? fits
                                                                  : 0;
}

// The one-block launch of the kernel of weight type WT.
template <typename WT>
static int one_block_run(const Params& q, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      decode_lattice_kernel<WT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  decode_lattice_kernel<WT><<<1, NT, smem, stream>>>(q);
  return (int)cudaGetLastError();
}

// emb, embT and wcat: float (bf16 == 0) or __nv_bfloat16 (bf16 != 0)
extern "C" int decode_lattice_launch(
    const void* emb, const void* embT, const void* wcat,
    const float* bias, const int* chars, const float* mask,
    const float* conf, const float* valid, const int* steps,
    const float* state0, const float* cost0, float* records, float* walk,
    float* stateF, float* costF, float* stateE, int E, int n_real, int A,
    int L, int K, int D, int W, int Vp, int v_real, float lw, float lw1,
    int cl, int shard, int bf16, void* stream) {
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
  Params q{{f32[0], f32[1], f32[2], bias, steps, E, n_real, A, L, K, D, W,
            Vp, v_real, rb, lw, lw1, b16[0], b16[1], b16[2]},
           chars, mask, conf, valid, state0, cost0, records, walk, stateF,
           costF, stateE};
  if (cl > 1)
    return cluster_run(q, cl, shard != 0, bf16 != 0, (cudaStream_t)stream,
                       nullptr);
  const size_t smem = decode_smem_floats(A, L, K, D, W, Vp, rb) * 4;
  return bf16 ? one_block_run<__nv_bfloat16>(q, smem, (cudaStream_t)stream)
              : one_block_run<float>(q, smem, (cudaStream_t)stream);
}
