// Backpointer walk of the generation records for Hopper (sm_90a).
//
// Replaces the TPU kernel ocrd_keraslm_tpu/ops/gen_kernel.py::
// _traceback_pallas (_make_tb_kernel): from each cursor's end slot at
// step out_length - 1 (a run-time argument), walk the (char, backptr)
// records (N, T, 3, K) back to step 0 and write the chars in forward
// order, 0 at steps >= out_length.
//
// What bounds it on this card: latency.  A cursor's walk is a chain of
// out_length dependent lookups; the bytes it needs (two floats a step
// and cursor) are nothing.  Walked in device memory, each lookup is an
// L2 round trip (~340 cycles): 0.17 ms for 1000 steps.
//
// What the design does about it: the steps are cut into G segments of L
// steps (ops/gen_kernel.py::tb_layout chooses L) and the chain is walked
// in shared memory, segment by segment in parallel, in two launches:
//
//   1. gen_traceback_maps_kernel, one block a (segment, stream): stage the
//      segment's backpointers as bytes (gen_beam takes K <= 256) with
//      many loads in flight, walk the segment from each of the K entry
//      slots (split into sub-segments where K is below the block's
//      threads, then chained) and write the segment's exit map
//      maps[n][g][k] (the slot at the step before the segment, by the
//      slot at its last step);
//   2. gen_traceback_walk_kernel, one block a (segment, stream) over all
//      T steps, launched with programmatic dependent launch: it stages its
//      backpointers while launch 1 still runs, waits for the maps,
//      composes the maps of the later segments from each cursor's end
//      slot (G - 1 - g lookups in shared memory instead of ~L*(G-1-g)
//      in L2), walks its own segment again from that entry, and gathers
//      the chars rec[t][0][slot] and writes out with every thread, with
//      neighbouring threads on neighbouring steps; a segment past
//      out_length writes its zeros the same way.
//
// A segment that holds every walked step needs no maps: launch 2 alone.
// Every slot is clamped to [0, K) before it is read, as the first design
// clamped it (a float backpointer is clamped before it becomes a byte:
// the same slot as clamping the truncated int).

#include <cuda_runtime.h>

#define TB_NT 256        // threads a block
#define TB_VPT 4         // cursors a thread: VARS <= TB_NT * TB_VPT = 1024
#define TB_MAPS 64       // segment maps staged at once (launch 2)
#define TB_UNROLL 8      // backpointer loads in flight a thread
#define TB_SEG_MAX 64    // steps a segment, at most

// a slot of the records, clamped to [0, K)
__device__ __forceinline__ unsigned char tb_slot(float v, int K) {
  return (unsigned char)(int)fminf(fmaxf(v, 0.0f), (float)(K - 1));
}

// the clamped backpointers of steps [lo, hi) of one stream as bytes,
// bp[(t - lo) * K + k]: a float4 a load (K % 4 == 0), TB_UNROLL loads in
// flight a thread; a thread's (step, slot quad) advances by adding (no
// division in the loop)
__device__ __forceinline__ void tb_stage(const float* __restrict__ rn,
                                         unsigned char* bp, int lo, int hi,
                                         int K) {
  const int K4 = K / 4, rows = hi - lo;
  const int dt = TB_NT / K4, dk = TB_NT - dt * K4;
  int t = threadIdx.x / K4, k = threadIdx.x - t * K4;
  while (t < rows) {
    float4 v[TB_UNROLL];
    int tu[TB_UNROLL], ku[TB_UNROLL];
#pragma unroll
    for (int u = 0; u < TB_UNROLL; ++u) {
      tu[u] = t, ku[u] = k;
      if (t < rows)
        v[u] = __ldg(reinterpret_cast<const float4*>(
                         rn + (size_t)(lo + t) * 3 * K + K) + k);
      t += dt, k += dk;
      if (k >= K4) k -= K4, ++t;
    }
#pragma unroll
    for (int u = 0; u < TB_UNROLL; ++u) {
      if (tu[u] >= rows) break;
      *reinterpret_cast<uchar4*>(bp + tu[u] * K + ku[u] * 4) =
          make_uchar4(tb_slot(v[u].x, K), tb_slot(v[u].y, K),
                      tb_slot(v[u].z, K), tb_slot(v[u].w, K));
    }
  }
}

// sub-segments a segment splits into, so that every thread walks
__host__ __device__ inline int tb_subsegments(int K) {
  return K < TB_NT ? TB_NT / K : 1;
}

// bytes of dynamic shared memory of each launch at segment length L
extern "C" size_t gen_traceback_maps_smem_bytes(int K, int L) {
  return (size_t)4 * tb_subsegments(K) * K + (size_t)L * K;
}

// slots of the walk: TB_NT cursors by L steps, a cursor's row padded to
// an odd number of words so that neither the walk nor the gather meets
// bank conflicts
__host__ __device__ inline int tb_slot_stride(int L) { return L | 1; }

extern "C" size_t gen_traceback_walk_smem_bytes(int K, int L) {
  return (size_t)4 * TB_NT * tb_slot_stride(L) + (size_t)TB_MAPS * K +
         (size_t)L * K;
}

__global__ void __launch_bounds__(TB_NT)
    gen_traceback_maps_kernel(const float* __restrict__ rec,
                              unsigned char* maps, int T, int K, int L, int G,
                              int out_length) {
  extern __shared__ int tsm[];
  const int g = blockIdx.x, n = blockIdx.y, tid = threadIdx.x;
  const int P = tb_subsegments(K);
  int* sub = tsm;  // (P, K) each sub-segment's exit slot, by entry slot
  unsigned char* bp = reinterpret_cast<unsigned char*>(sub + P * K);
  // the walk launch may start (and stage its own backpointers) now
  asm volatile("griddepcontrol.launch_dependents;");
  const int lo = g * L, hi = min(lo + L, out_length);
  tb_stage(rec + (size_t)n * T * 3 * K, bp, lo, hi, K);
  __syncthreads();
  const int Ls = (hi - lo + P - 1) / P;
  if (tid < P * K) {  // sub-segment p covers [lo + p*Ls, lo + (p+1)*Ls)
    const int p = tid / K, s_lo = p * Ls, s_hi = min(s_lo + Ls, hi - lo);
    int k = tid - p * K;
    for (int t = s_hi - 1; t >= s_lo; --t) k = bp[t * K + k];
    sub[tid] = k;
  }
  __syncthreads();
  if (tid < K) {
    int k = tid;
    for (int p = P - 1; p >= 0; --p) k = sub[p * K + k];
    maps[((size_t)n * G + g) * K + tid] = (unsigned char)k;
  }
}

__global__ void __launch_bounds__(TB_NT)
    gen_traceback_walk_kernel(const float* __restrict__ rec,
                              const int* __restrict__ best,
                              const unsigned char* maps, int* __restrict__ out,
                              int T, int K, int VARS, int L, int G,
                              int out_length) {
  extern __shared__ int tsm[];
  const int g = blockIdx.x, n = blockIdx.y, tid = threadIdx.x;
  const int S = tb_slot_stride(L);
  int* sl = tsm;  // (TB_NT, S) the slot of each cursor at each step
  // (TB_MAPS, K) staged segment maps, then the backpointers
  unsigned char* mp = reinterpret_cast<unsigned char*>(sl + TB_NT * S);
  unsigned char* bp = mp + TB_MAPS * K;
  const int lo = g * L, hi = min(lo + L, T);
  const int Lw = max(min(hi, out_length) - lo, 0);  // steps walked here
  const float* rn = rec + (size_t)n * T * 3 * K;
  int* on = out + (size_t)n * VARS * T;
  if (Lw > 0) tb_stage(rn, bp, lo, lo + Lw, K);
  // each cursor's slot at step lo + Lw - 1: its end slot through the
  // maps of the segments after this one
  int ke[TB_VPT];
#pragma unroll
  for (int j = 0; j < TB_VPT; ++j) {
    const int v = j * TB_NT + tid;
    ke[j] = v < VARS ? min(max(best[(size_t)n * VARS + v], 0), K - 1) : 0;
  }
  asm volatile("griddepcontrol.wait;" ::: "memory");  // launch 1's maps
  if (Lw > 0) {
    for (int h1 = G - 1; h1 > g; h1 -= TB_MAPS) {
      const int h0 = max(g + 1, h1 - TB_MAPS + 1);
      const int words = (h1 - h0 + 1) * K / 4;
      const unsigned* src =
          reinterpret_cast<const unsigned*>(maps + ((size_t)n * G + h0) * K);
      __syncthreads();  // the chunk before is composed
      for (int i = tid; i < words; i += TB_NT)
        reinterpret_cast<unsigned*>(mp)[i] = src[i];
      __syncthreads();
#pragma unroll
      for (int j = 0; j < TB_VPT; ++j)
        if (j * TB_NT < VARS)
          for (int h = h1; h >= h0; --h) ke[j] = mp[(h - h0) * K + ke[j]];
    }
  }
  const int Lo = hi - lo;
#pragma unroll
  for (int j = 0; j < TB_VPT; ++j) {
    const int v0 = j * TB_NT;
    if (v0 >= VARS) break;
    const int nv = min(TB_NT, VARS - v0);
    __syncthreads();  // backpointers staged, the slots before gathered
    if (tid < nv) {
      int k = ke[j];
      for (int t = Lw - 1; t >= 0; --t) {
        sl[tid * S + t] = k;
        k = bp[t * K + k];
      }
    }
    __syncthreads();
    for (int i = tid; i < nv * Lo; i += TB_NT) {
      const int c = i / Lo, t = i - c * Lo;
      on[(size_t)(v0 + c) * T + lo + t] =
          t < Lw ? (int)__ldg(rn + (size_t)(lo + t) * 3 * K + sl[c * S + t])
                 : 0;
    }
  }
}

// Walk N streams' records from the VARS slots best[n] at step
// out_length - 1 in segments of L steps; maps is scratch of N * G * K
// bytes, G = ceil(out_length / L) (unused where G is 1).  K % 4 == 0 (a
// float4 of backpointers a load, a word of map bytes a copy).
extern "C" int gen_traceback_launch(const float* rec, const int* best,
                                    unsigned char* maps, int* out, int N,
                                    int T, int K, int VARS, int out_length,
                                    int L, void* stream) {
  if (N < 1 || N > 65535 || VARS < 1 || VARS > TB_NT * TB_VPT ||
      out_length < 1 || out_length > T || K < 4 || K > 256 || K % 4 ||
      L < 1 || L > TB_SEG_MAX)
    return (int)cudaErrorInvalidValue;
  const int G = (out_length + L - 1) / L, Gt = (T + L - 1) / L;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (G > 1) {
    const size_t smem = gen_traceback_maps_smem_bytes(K, L);
    gen_traceback_maps_kernel<<<dim3(G, N), TB_NT, smem, st>>>(
        rec, maps, T, K, L, G, out_length);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const size_t smem = gen_traceback_walk_smem_bytes(K, L);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(gen_traceback_walk_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Gt, N);
  cfg.blockDim = dim3(TB_NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = G > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, gen_traceback_walk_kernel, rec, best,
                           (const unsigned char*)maps, out, T, K, VARS, L, G,
                           out_length);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
