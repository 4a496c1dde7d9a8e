// Arithmetic shared by the LSTM recurrences of score_scan.cu,
// lstm_scan.cu and lstm_bwd.cu: the blocked dot product of one gate
// column (f32 or bf16 weights), one unit's gate update, and how many
// streams a block takes.
//
// Accuracy rule: each dot product is summed in blocks of KCH terms (as
// in decode_lattice.cu).  One chain of W FMAs drifts from the plain
// version past 1e-5 over the thousands of steps of a scoring chunk.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#define KCH 32   // terms per partial sum
#define RBMAX 8  // streams per block

__device__ __forceinline__ float sigm(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Whether a weight type is bf16, and a float rounded to the nearest
// bf16 value (ties to even), as a float.
template <typename WT>
struct is_bf16 : std::false_type {};
template <>
struct is_bf16<__nv_bfloat16> : std::true_type {};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// One weight as f32: f32 weights through the read-only cache, bf16
// weights promoted exactly.
__device__ __forceinline__ float ldw(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldw(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// tot[r] += sum_i x[r*xs + i] * w[i*ncols + j] over i < n, in blocks of
// KCH; x is the block's RB rows in shared memory (row stride xs, read as
// float4s), w an (n, ncols) weight, f32 or bf16, read once per element
// for all RB rows.  Products and sums are f32.
template <int RB, typename WT>
__device__ __forceinline__ void dot_cols(const float* __restrict__ x, int xs,
                                         int n, const WT* __restrict__ w,
                                         int ncols, int j, float* tot) {
  for (int i0 = 0; i0 < n; i0 += KCH) {
    float acc[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) acc[r] = 0.0f;
    const int i1 = min(i0 + KCH, n);
    for (int i = i0; i < i1; i += 4) {
      const float w0 = ldw(w + (size_t)(i + 0) * ncols + j);
      const float w1 = ldw(w + (size_t)(i + 1) * ncols + j);
      const float w2 = ldw(w + (size_t)(i + 2) * ncols + j);
      const float w3 = ldw(w + (size_t)(i + 3) * ncols + j);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float4 xv = *reinterpret_cast<const float4*>(x + r * xs + i);
        float a = acc[r];
        a = fmaf(xv.x, w0, a);
        a = fmaf(xv.y, w1, a);
        a = fmaf(xv.z, w2, a);
        a = fmaf(xv.w, w3, a);
        acc[r] = a;
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) tot[r] += acc[r];
  }
}

// dot_cols over RB rows of W f32 values at stride W and an f32 weight
template <int RB>
__device__ __forceinline__ void dot_col(const float* __restrict__ x, int W,
                                        const float* __restrict__ w,
                                        int ncols, int j, float* tot) {
  dot_cols<RB, float>(x, W, W, w, ncols, j, tot);
}

// Unit u's new (h, c) from its row's gate pre-activations zr (blocks i,
// f, g, o of W each: sigmoid, sigmoid, tanh, sigmoid) and its old c.
// c = f*c + i*g rounds each product and the sum, as the plain version
// does: left to the compiler, the contraction into an FMA depends on
// the surrounding code, and over a 4096-step chunk, where |c| reaches
// ~3.6e3, the choice moves c's drift from a float64 run by a factor 2-3.
__device__ __forceinline__ float2 lstm_unit(const float* zr, int W, int u,
                                            float c) {
  const float ig = sigm(zr[u]);
  const float fg = sigm(zr[W + u]);
  const float gg = tanhf(zr[2 * W + u]);
  const float og = sigm(zr[3 * W + u]);
  const float c2 = __fadd_rn(__fmul_rn(fg, c), __fmul_rn(ig, gg));
  return make_float2(__fmul_rn(og, tanhf(c2)), c2);
}

// streams per block: the power of two >= B, at most RBMAX
static inline int rows_per_block(int B) {
  int rb = 1;
  while (rb < B && rb < RBMAX) rb *= 2;
  return rb;
}

// f(std::integral_constant<int, RB>) for the RB that B streams take
template <typename F>
static int dispatch_rows(int B, F&& f) {
  switch (rows_per_block(B)) {
    case 1:
      return f(std::integral_constant<int, 1>{});
    case 2:
      return f(std::integral_constant<int, 2>{});
    case 4:
      return f(std::integral_constant<int, 4>{});
    default:
      return f(std::integral_constant<int, RBMAX>{});
  }
}
