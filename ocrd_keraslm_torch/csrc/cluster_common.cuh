// Thread-block cluster primitives shared by the cluster kernels
// (scan_common.cuh's register layout of the LSTM recurrences, the LSTM
// backward of lstm_bwd.cu, the lattice decode of decode_common.cuh and
// the generation beam step of gen_beam.cu): the clock64() phase marks of
// gen_beam_phases.py, the in-order sum of a column's 32-term blocks over
// warp lanes, the exchange of values between the blocks of a cluster by
// st.async onto the receiver's mbarrier, and a counter in device memory
// that blocks of several clusters arrive on and wait for (the grid and
// wide layouts, gen_beam's row groups).
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

#ifdef SCAN_PHASES
// clock64() cycles per phase (SCAN_NPHASE marks), summed over the steps
// of block 0's thread 0 in registers and added to g_scan_phase at the
// end (built only by gen_beam_phases.py)
#define SCAN_NPHASE 10
__device__ unsigned long long g_scan_phase[SCAN_NPHASE];
#define PHASE_INIT                                       \
  const bool pon_ = blockIdx.x == 0 && threadIdx.x == 0; \
  unsigned long long ph_[SCAN_NPHASE] = {};              \
  unsigned long long tp_ = clock64();
#define PHASE(k)                                \
  {                                             \
    const unsigned long long tn_ = clock64();   \
    ph_[k] += tn_ - tp_;                        \
    tp_ = tn_;                                  \
  }
#define PHASE_FLUSH                      \
  if (pon_)                              \
    for (int k_ = 0; k_ < SCAN_NPHASE; ++k_) \
      atomicAdd(g_scan_phase + k_, ph_[k_]);
extern "C" int scan_phase_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_scan_phase, sizeof(g_scan_phase));
}
extern "C" int scan_phase_reset() {
  unsigned long long zero[SCAN_NPHASE] = {0};
  return (int)cudaMemcpyToSymbol(g_scan_phase, zero, sizeof(zero));
}
#else
#define PHASE_INIT
#define PHASE(k) \
  {}
#define PHASE_FLUSH
#endif

// h rows in shared memory are padded: each 32-term block starts 4 floats
// further on, so the float4 loads of a warp's NKB blocks fall into
// distinct banks
__host__ __device__ inline int hpad(int i) { return i + ((i >> 5) << 2); }
__host__ __device__ inline int padded_width(int W) {
  return W + 4 * ((W + 31) / 32);
}

// On the kb=0 lanes: each column's sum, its NKB blocks added to 0 in
// block order (dot_cols' float); every lane of the warp takes part.
template <int NKB, int N, int GS>
__device__ __forceinline__ void kb_sum(float* acc) {
  float tot[N];
#pragma unroll
  for (int i = 0; i < N; ++i) tot[i] = 0.0f;
#pragma unroll
  for (int k = 0; k < NKB; ++k)
#pragma unroll
    for (int i = 0; i < N; ++i)
      tot[i] += k ? __shfl_down_sync(0xffffffffu, acc[i], k, GS) : acc[i];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = tot[i];
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// the address of the same shared-memory location in block rank k
__device__ __forceinline__ unsigned mapa(unsigned addr, int k) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(k));
  return r;
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// the barrier's one arrival of a phase, expecting `bytes` to complete
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "{\n.reg .b64 st;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
// A wait that has not ended after MBAR_TIMEOUT_NS of the card's global
// timer (checked every 1024 polls; a step takes microseconds) traps.
// The trap is fatal to the process's CUDA context: every later call of
// the process fails too.  It turns a fault of the exchange into a failed
// process instead of a card that hangs for good.
#define MBAR_TIMEOUT_NS 10000000000ull
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done, polls = 0;
  unsigned long long t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if ((++polls & 1023u) == 0) {
      const unsigned long long now = global_ns();
      if (t0 == 0)
        t0 = now;
      else if (now - t0 > MBAR_TIMEOUT_NS)
        __trap();
    }
  }
}
__device__ __forceinline__ void st_async(unsigned addr, float v,
                                         unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}
// st_async of four floats at a 16-byte aligned address
__device__ __forceinline__ void st_async4(unsigned addr, float4 v,
                                          unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)),
      "r"(__float_as_uint(v.z)), "r"(__float_as_uint(v.w)), "r"(bar)
      : "memory");
}

// the group's counter: a block arrives once a step, after its writes of
// the step (every thread of the block calls these)
__device__ __forceinline__ void group_arrive(unsigned* flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(flag, 1u);
  }
}
__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
// Wait until the counter reaches target.  A wait that has not ended
// after MBAR_TIMEOUT_NS traps, as mbar_wait does: a fault of the
// exchange fails the process instead of hanging the card.
__device__ __forceinline__ void group_wait(const unsigned* flag,
                                           unsigned target) {
  if (threadIdx.x == 0) {
    unsigned polls = 0;
    unsigned long long t0 = 0;
    while (ld_acquire(flag) < target) {
      if ((++polls & 1023u) == 0) {
        const unsigned long long now = global_ns();
        if (t0 == 0)
          t0 = now;
        else if (now - t0 > MBAR_TIMEOUT_NS)
          __trap();
      }
    }
    __threadfence();
  }
  __syncthreads();
}
