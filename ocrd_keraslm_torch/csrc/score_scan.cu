// Teacher-forced scoring of one chunk, for Hopper (sm_90a).
//
// Replaces the TPU kernel ocrd_keraslm_tpu/ops/score_kernel.py::
// score_scan_pallas.  For each stream b and step t, in order: layer 0
// from the streamed input projection, z = xp1[b, t] + h_0 @ rec1;
// layers d >= 1 as z = h_{d-1} @ kcat[d-1] + h_d @ ucat[d-1] + bias[d-1];
// the gates i, f, g, o of each layer; the tied-softmax logits
// h_{D-1} @ embT masked at v_real; their logsumexp; and
//   prob[b, t] = exp(logit[y] - lse) * mask,   nll = (lse - logit[y]) * mask,
// with the per-stream NLL summed over the chunk (in double, in step
// order) and the (D, B, W) carry read at the start and written at the
// end.
//
// What bounds it on this card: the recurrence.  Step t+1 needs all
// layers of step t, so a stream's T steps run in order, and the work of
// one step (2*W*4W FLOPs per layer and stream) is far too little for
// the card: a step takes the latency of its chain of dependent products,
// gate updates and exchanges.  The one-block layout (score_scan_kernel,
// one block per <= 8 streams) streams rec1, kcat, ucat and embT (~805
// KiB at W=128, D=2) from L2 at every step on one SM and runs each
// column's W FMAs and the softmax on the step's chain.
//
// What the design does about it (scan_common.cuh; layout chosen by
// ops/scan_layout.py from the shape and the card's cluster occupancy):
//  * the register layout, where a column has 2, 4 or 8 blocks of 32
//    terms and D layer groups fit a block, runs three kernels: the
//    recurrence (score_scan_reg_kernel), then the tied softmax over all
//    B*T rows at once (score_softmax_kernel), then the per-stream NLL
//    sums (score_nll_kernel).  The logits do not feed the recurrence, so
//    the scan writes the top layer's h of every step (B, T, W) to a
//    scratch tensor and the softmax runs off its serial chain;
//  * the recurrence: a thread-block cluster of CL blocks per group of RB
//    streams splits the gate columns of every layer (block k owns W/CL
//    units and their four gate columns); a layer group of warps per
//    layer; each lane keeps the 32 weights of one 32-term block of one
//    gate column in registers (of rec1 for layer 0, of ucat and kcat for
//    a layer above), so no weight is read again; layer 0's product and
//    every layer's recurrent product (step t-1's h) run at once, then
//    each layer's input product as soon as the layer below's new h has
//    arrived; partial sums are added in block order by warp shuffles,
//    lane j of a unit's group runs row j's gate update (c in its
//    registers), and the new h goes into every block by st.async,
//    completing on the receiving block's mbarrier: no block or cluster
//    barrier in the T loop;
//  * the softmax: one block per 32 rows computes their v_real logits
//    (blocked sums, as dot_cols), and one warp per row the logsumexp,
//    the target prob and the row's NLL in the one-block kernel's order;
//    one warp per stream adds the NLLs in double in step order;
//  * every other shape (W=384 on the fused path, D=2 at W=256, a launch
//    whose clusters the card cannot hold at once) runs the one-block
//    kernel of the first port, unchanged, softmax and NLL sums inside.
// Every output keeps the first port's bits.  All arithmetic is f32 (the
// NLL sums double) on CUDA cores: no TF32.

#include "scan_common.cuh"

#define BIGF 1.0e30f
#define SM_ROWS 32  // softmax rows per block
#define SM_NT 256   // softmax threads per block
static_assert(RBMAX <= SCAN_NT / 32, "one warp per stream in the logsumexp");

struct ScoreArgs {
  const float* xp1;   // (B, T, G) layer-0 input projection
  const int* y;       // (B, T) targets
  const float* mask;  // (B, T)
  const float* h0;    // (D, B, W)
  const float* c0;    // (D, B, W)
  const float* rec1;  // (W, G)
  const float* kcat;  // (Dw, W, G)
  const float* ucat;  // (Dw, W, G)
  const float* bias;  // (Dw, G)
  const float* embT;  // (W, Vp)
  float* probs;       // (B, T)
  float* nll;         // (B,)
  float* hT;          // (D, B, W)
  float* cT;          // (D, B, W)
  float* htop;        // (B, T, W) top layer's h of every step (register
                      // layout only)
  int B, T, D, W, Vp, v_real, rb;
};

// ---- the one-block layout ----
//
// Each thread owns one gate (or vocabulary) column and keeps RB
// accumulators in registers, so one weight read (from L2) feeds RB FMAs;
// the (D, RB, W) carry lives in shared memory for the whole chunk.  The
// logsumexp is one warp per stream; the target logit is an index load,
// and each stream's NLL sum is kept in double by its warp's lane 0.

// New (h, c) of one layer's nr rows from their gate pre-activations z
// (row stride ZW).
__device__ __forceinline__ void gates(const float* z, int ZW, int W, int nr,
                                      float* h, float* c) {
  for (int i = threadIdx.x; i < nr * W; i += SCAN_NT) {
    const int r = i / W, u = i - r * W;
    const float2 hc = lstm_unit(z + r * ZW, W, u, c[i]);
    h[i] = hc.x;
    c[i] = hc.y;
  }
}

template <int RB>
__global__ void __launch_bounds__(SCAN_NT, 1) score_scan_kernel(ScoreArgs p) {
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int W = p.W, D = p.D, G = 4 * W, T = p.T, B = p.B;
  const int ZW = G > p.Vp ? G : p.Vp;
  float* hs = reinterpret_cast<float*>(smem4);  // (D, RB, W)
  float* cs = hs + D * RB * W;                  // (D, RB, W)
  float* z = cs + D * RB * W;                   // (RB, ZW)
  const int s0 = blockIdx.x * RB;
  const int nr = min(RB, B - s0);
  for (int i = tid; i < D * RB * W; i += SCAN_NT) {
    const int d = i / (RB * W), r = (i / W) % RB, u = i % W;
    const size_t o = ((size_t)d * B + s0 + r) * W + u;
    hs[i] = r < nr ? p.h0[o] : 0.0f;
    cs[i] = r < nr ? p.c0[o] : 0.0f;
  }
  double nacc = 0.0;  // lane 0 of warp r: stream s0 + r
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    // ---- layer 0: streamed input projection + h_0 @ rec1 ----
    for (int j = tid; j < G; j += SCAN_NT) {
      float tot[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) tot[r] = 0.0f;
      dot_col<RB>(hs, W, p.rec1, G, j, tot);
#pragma unroll
      for (int r = 0; r < RB; ++r)
        if (r < nr)
          z[r * ZW + j] = p.xp1[((size_t)(s0 + r) * T + t) * G + j] + tot[r];
    }
    __syncthreads();
    gates(z, ZW, W, nr, hs, cs);
    __syncthreads();

    // ---- layers 1..D-1: h_{d-1} @ kcat + h_d @ ucat + bias ----
    for (int d = 1; d < D; ++d) {
      const float* hin = hs + (d - 1) * RB * W;
      float* hd = hs + d * RB * W;
      const float* kc = p.kcat + (size_t)(d - 1) * W * G;
      const float* uc = p.ucat + (size_t)(d - 1) * W * G;
      for (int j = tid; j < G; j += SCAN_NT) {
        float ta[RB], tb[RB];
#pragma unroll
        for (int r = 0; r < RB; ++r) ta[r] = tb[r] = 0.0f;
        dot_col<RB>(hin, W, kc, G, j, ta);
        dot_col<RB>(hd, W, uc, G, j, tb);
        const float bj = __ldg(p.bias + (size_t)(d - 1) * G + j);
#pragma unroll
        for (int r = 0; r < RB; ++r)
          if (r < nr) z[r * ZW + j] = (ta[r] + tb[r]) + bj;
      }
      __syncthreads();
      gates(z, ZW, W, nr, hd, cs + d * RB * W);
      __syncthreads();
    }

    // ---- tied softmax: logits, logsumexp, target prob and NLL ----
    // only the v_real real columns: the padding never reaches the sums
    const float* htop = hs + (D - 1) * RB * W;
    for (int v = tid; v < p.v_real; v += SCAN_NT) {
      float tot[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) tot[r] = 0.0f;
      dot_col<RB>(htop, W, p.embT, p.Vp, v, tot);
#pragma unroll
      for (int r = 0; r < RB; ++r)
        if (r < nr) z[r * ZW + v] = tot[r];
    }
    __syncthreads();
    if (warp < nr) {
      const float* lg = z + warp * ZW;
      float mx = -BIGF;
      for (int v = lane; v < p.v_real; v += 32) mx = fmaxf(mx, lg[v]);
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      float sum = 0.0f;
      for (int v = lane; v < p.v_real; v += 32) sum += expf(lg[v] - mx);
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const size_t o = (size_t)(s0 + warp) * T + t;
        const float lse = mx + logf(sum);
        const int yv = p.y[o];
        const float tgt = yv < p.v_real ? lg[yv] : -BIGF;
        const float m = p.mask[o];
        p.probs[o] = expf(tgt - lse) * m;
        nacc += (double)((lse - tgt) * m);
      }
    }
    __syncthreads();  // z is rewritten by the next step's layer 0
  }

  for (int i = tid; i < D * RB * W; i += SCAN_NT) {
    const int d = i / (RB * W), r = (i / W) % RB, u = i % W;
    if (r < nr) {
      const size_t o = ((size_t)d * B + s0 + r) * W + u;
      p.hT[o] = hs[i];
      p.cT[o] = cs[i];
    }
  }
  if (warp < nr && lane == 0) p.nll[s0 + warp] = (float)nacc;
}

// The register layout (scan_common.cuh): layer group 0 holds rec1's
// weights, layer group d >= 1 those of ucat[d-1] and kcat[d-1] (two
// blocks of 32 a thread); rows (D, 2, rb, WP) padded in shared memory
// and their 2D mbarriers are all the block holds.  A step: group 0 runs
// layer 0 to its gate updates and sends the new h into every block
// while the groups d >= 1 run their recurrent products; group d waits
// for layer d-1's h of the step on its mbarrier, runs its input product,
// gate updates and send; every group then waits for all layers' h of the
// step.  Lane j < RT of a unit's group runs the gate update of row j (c,
// h and layer 0's xp1 in its registers).  No cluster barrier in the T
// loop.
template <int NKB, int RT>
__global__ void __launch_bounds__(SCAN_NT, 1)
    score_scan_reg_kernel(ScoreArgs p) {
  extern __shared__ float4 smem4[];
  float* hb = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = (int)cluster.num_blocks();
  const Geo g = make_geo(p.W, CL, (int)cluster.block_rank());
  const int W = p.W, B = p.B, T = p.T, D = p.D, RB = p.rb;
  const int WP = padded_width(W), rows = RB * WP;
  const int s0 = (int)(blockIdx.x / CL) * RB, nr = min(RB, B - s0);
  uint64_t* bar = reinterpret_cast<uint64_t*>(hb + (size_t)D * 2 * rows);
  const RegRole ro = reg_role<NKB, 1>(g, RB / RT,
                                      reg_group_threads(W, RB, CL, RT, 1));
  const int lg = ro.lg;
  const bool work = lg < D;
  // this lane's row in its layer's gate update, and whether it has one
  const int row = ro.rg * RT + ro.q;
  const bool mine = work && ro.valid && ro.q < RT && row < nr;
  const size_t xrow = (size_t)(s0 + row) * T * g.G + ro.u;
  const size_t WG = (size_t)W * g.G;
  const unsigned bytes = 4u * nr * W;  // a layer's rows of a step
  PHASE_INIT

  // wa: rec1 (group 0) or ucat[lg-1]; wb: kcat[lg-1]
  float wa[KCH], wb[KCH], tb[RT], c = 0.0f, hf = 0.0f, xc[4], xn[4];
  float bj = 0.0f;
  if (work) {
    load_wreg<1, float>(wa, lg == 0 ? p.rec1 : p.ucat + (lg - 1) * WG, g, ro);
    if (lg > 0) {
      load_wreg<1, float>(wb, p.kcat + (lg - 1) * WG, g, ro);
      if (ro.valid)
        bj = p.bias[(size_t)(lg - 1) * g.G + ro.gate * W + ro.u];
    }
  }
  if (mine) {
    c = p.c0[((size_t)lg * B + s0 + row) * W + ro.u];
    hf = p.h0[((size_t)lg * B + s0 + row) * W + ro.u];
  }
  const bool xin = mine && lg == 0;  // holds layer 0's xp1
#pragma unroll
  for (int gate = 0; gate < 4; ++gate) {  // xp1 of steps 0 and 1
    xc[gate] = xin && T > 0 ? p.xp1[xrow + gate * W] : 0.0f;
    xn[gate] = xin && T > 1 ? p.xp1[xrow + g.G + gate * W] : 0.0f;
  }
#pragma unroll
  for (int r = 0; r < RT; ++r) tb[r] = 0.0f;
  for (int d = 0; d < D; ++d)
    reg_fill_rows(hb + (size_t)d * 2 * rows, p.h0 + (size_t)d * B * W, s0,
                  nr, RB, W, WP, false);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * D; ++i) mbar_init(bar + i);
    mbar_init_fence();
  }
  cluster.sync();  // every block of the cluster runs and holds its rows

  if (work)
    for (int t = 0; t < T; ++t) {
      const int nxt = (t + 1) & 1;
      const unsigned par = (t >> 1) & 1;
      if (threadIdx.x == 0)
        for (int d = 0; d < D; ++d) mbar_expect(bar + d * 2 + nxt, bytes);
      // layer 0's product, or layer lg's recurrent product: step t-1's h
      float acc[RT];
      reg_chain<RT, 1>(hb + ((lg * 2 + (t & 1)) * RB + ro.rg * RT) * WP,
                       WP, ro.kb, W, wa, acc);
      kb_sum<NKB, RT, 4 * NKB>(acc);
      PHASE(1)
      if (lg == 0) {
        const float h = reg_gate<NKB, RT, 1>(acc, xc, c, hf, false, ro.q);
        reg_send<NKB, RT, 1>(h, hb + nxt * rows, bar + nxt, WP, ro, nr, CL);
        if (xin) {
          if (D == 1) p.htop[((size_t)(s0 + row) * T + t) * W + ro.u] = hf;
#pragma unroll
          for (int gate = 0; gate < 4; ++gate) {  // xp1 of step t+2
            xc[gate] = xn[gate];
            xn[gate] = t + 2 < T ? __ldg(p.xp1 + xrow +
                                         (size_t)(t + 2) * g.G + gate * W)
                                 : 0.0f;
          }
        }
      } else {
#pragma unroll
        for (int r = 0; r < RT; ++r) tb[r] = acc[r];
        // layer lg-1's h of step t, then layer lg's input product
        mbar_wait(bar + (lg - 1) * 2 + nxt, par);
        reg_chain<RT, 1>(
            hb + (((lg - 1) * 2 + nxt) * RB + ro.rg * RT) * WP, WP, ro.kb, W,
            wb, acc);
        kb_sum<NKB, RT, 4 * NKB>(acc);
#pragma unroll
        for (int r = 0; r < RT; ++r) acc[r] = (acc[r] + tb[r]) + bj;
        const float h = reg_gate<NKB, RT, 1>(acc, nullptr, c, hf, false, ro.q);
        reg_send<NKB, RT, 1>(h, hb + (lg * 2 + nxt) * rows, bar + lg * 2 + nxt,
                          WP, ro, nr, CL);
        if (mine && lg == D - 1)
          p.htop[((size_t)(s0 + row) * T + t) * W + ro.u] = hf;
      }
      PHASE(2)
      for (int d = 0; d < D; ++d)  // every layer's h of step t
        mbar_wait(bar + d * 2 + nxt, par);
      PHASE(7)
    }
  if (mine) {
    const size_t o = ((size_t)lg * B + s0 + row) * W + ro.u;
    p.hT[o] = hf;
    p.cT[o] = c;
  }
  PHASE_FLUSH
  cluster.sync();  // no block leaves while another may still write to it
}

// The tied softmax of R = B*T rows of htop (R, W): per row the v_real
// logits (blocked sums of 32 terms, as dot_cols), their logsumexp, the
// target's prob and the row's NLL, each as the one-block kernel computes
// them in its step (one warp per row).
__global__ void __launch_bounds__(SM_NT) score_softmax_kernel(
    const float* __restrict__ htop, const int* __restrict__ y,
    const float* __restrict__ mask, const float* __restrict__ embT,
    float* probs, float* nl, int R, int W, int Vp, int v_real) {
  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);  // (SM_ROWS, W)
  float* lg = hs + SM_ROWS * W;                 // (SM_ROWS, v_real)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * SM_ROWS, nrow = min(SM_ROWS, R - row0);
  const float4* src = reinterpret_cast<const float4*>(htop + (size_t)row0 * W);
  float4* dst = reinterpret_cast<float4*>(hs);
  for (int i = tid; i < nrow * W / 4; i += SM_NT) dst[i] = src[i];
  __syncthreads();
  for (int it = tid; it < nrow * v_real; it += SM_NT) {
    const int r = it / v_real, v = it - r * v_real;
    const float* x = hs + r * W;
    float tot = 0.0f;
    for (int i0 = 0; i0 < W; i0 += KCH) {
      const int i1 = min(i0 + KCH, W);
      float acc = 0.0f;
      for (int i = i0; i < i1; ++i)
        acc = fmaf(x[i], __ldg(embT + (size_t)i * Vp + v), acc);
      tot += acc;
    }
    lg[it] = tot;
  }
  __syncthreads();
  for (int r = warp; r < nrow; r += SM_NT / 32) {
    const float* l = lg + r * v_real;
    float mx = -BIGF;
    for (int v = lane; v < v_real; v += 32) mx = fmaxf(mx, l[v]);
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.0f;
    for (int v = lane; v < v_real; v += 32) sum += expf(l[v] - mx);
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      const size_t o = (size_t)row0 + r;
      const float lse = mx + logf(sum);
      const int yv = y[o];
      const float tgt = yv < v_real ? l[yv] : -BIGF;
      const float m = mask[o];
      probs[o] = expf(tgt - lse) * m;
      nl[o] = (lse - tgt) * m;
    }
  }
}

// nll[b] = the sum of nl[b, :] in double, in step order (one warp per
// stream: the lanes load 32 steps, lane 0 adds them).
__global__ void __launch_bounds__(SM_NT) score_nll_kernel(
    const float* __restrict__ nl, float* nll, int B, int T) {
  __shared__ float buf[SM_NT / 32][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (SM_NT / 32) + warp;
  if (b >= B) return;
  double acc = 0.0;
  for (int t0 = 0; t0 < T; t0 += 32) {
    buf[warp][lane] = t0 + lane < T ? nl[(size_t)b * T + t0 + lane] : 0.0f;
    __syncwarp();
    if (lane == 0)
      for (int i = 0; i < min(32, T - t0); ++i) acc += (double)buf[warp][i];
    __syncwarp();
  }
  if (lane == 0) nll[b] = (float)acc;
}

// bytes of dynamic shared memory a block of the layout asks: the
// register layout's padded rows (D, 2, rb, WP) and 2D mbarriers, or the
// one-block layout's carry (2, D, rb, W) and z rows (rb, max(4W, Vp))
static size_t score_scan_smem_bytes(int D, int W, int Vp, int rb, int reg) {
  if (reg) return (size_t)D * 2 * rb * padded_width(W) * 4 + 2 * D * 8;
  const int ZW = 4 * W > Vp ? 4 * W : Vp;
  return ((size_t)2 * D * rb * W + (size_t)rb * ZW) * sizeof(float);
}

static size_t softmax_smem_bytes(int W, int v_real) {
  return (size_t)SM_ROWS * (W + v_real) * sizeof(float);
}

// Refuses (invalid value) a layout that is not the register layout of
// ops/scan_layout.py or the one-block layout (one_block_rows_ok streams,
// cl 1, rt rb), or whose smem differs from score_scan_smem_bytes.
static int checked_scan(const ScoreArgs& a, int cl, int rt, int reg,
                        size_t smem, cudaStream_t stream, int* fits) {
  const bool ok =
      a.B >= 1 && a.D >= 1 && a.W >= 4 && a.W % 4 == 0 &&
      (reg ? reg_layout_ok(a.W, a.D, a.rb, cl, rt, 1)
           : !fits && one_block_rows_ok(a.B, a.rb) && cl == 1 &&
                 rt == a.rb) &&
      smem == score_scan_smem_bytes(a.D, a.W, a.Vp, a.rb, reg);
  if (!ok) return (int)cudaErrorInvalidValue;
  if (!reg)
    return dispatch_rows(a.rb, [&](auto rbc) {
      constexpr int RB = decltype(rbc)::value;
      cudaError_t err = cudaFuncSetAttribute(
          score_scan_kernel<RB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return (int)err;
      score_scan_kernel<RB><<<(a.B + RB - 1) / RB, SCAN_NT, smem, stream>>>(
          a);
      return (int)cudaGetLastError();
    });
  const int clusters = fits ? 1 : (a.B + a.rb - 1) / a.rb;
  return dispatch_nkb_rt((a.W + KCH - 1) / KCH, rt, [&](auto nkbc, auto rtc) {
    constexpr int NKB = decltype(nkbc)::value, RT = decltype(rtc)::value;
    return cluster_launch(score_scan_reg_kernel<NKB, RT>, a, cl, clusters,
                          smem, stream, fits);
  });
}

// How many clusters of the register layout the card holds at once (0 if
// none).
extern "C" int score_scan_max_clusters(int D, int W, int rb, int cl, int rt,
                                       size_t smem) {
  ScoreArgs a{};
  a.B = rb, a.D = D, a.W = W, a.rb = rb;
  int fits = 0;
  return checked_scan(a, cl, rt, 1, smem, 0, &fits) == 0 ? fits : 0;
}

// (rb, cl, rt, reg) is the scan's layout and smem its shared memory
// (ops/scan_layout.py), which must equal score_scan_smem_bytes; under
// the register layout htop (B, T, W) and nl (B, T) are f32 scratch (null
// otherwise)
extern "C" int score_scan_launch(
    const float* xp1, const int* y, const float* mask, const float* h0,
    const float* c0, const float* rec1, const float* kcat,
    const float* ucat, const float* bias, const float* embT, float* probs,
    float* nll, float* hT, float* cT, float* htop, float* nl, int B, int T,
    int D, int W, int Vp, int v_real, int rb, int cl, int rt, int reg,
    size_t smem, void* stream) {
  if (v_real < 1 || v_real > Vp || (reg && (htop == nullptr || nl == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  ScoreArgs a{xp1,  y,  mask, h0, c0, rec1, kcat, ucat,   bias, embT, probs,
              nll,  hT, cT,   htop, B, T,  D,    W,    Vp,   v_real, rb};
  int err = checked_scan(a, cl, rt, reg, smem, s, nullptr);
  if (err != 0 || !reg) return err;
  const int R = B * T;
  if (R > 0) {
    const size_t sm_bytes = softmax_smem_bytes(W, v_real);
    cudaError_t e = cudaFuncSetAttribute(
        score_softmax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)sm_bytes);
    if (e != cudaSuccess) return (int)e;
    score_softmax_kernel<<<(R + SM_ROWS - 1) / SM_ROWS, SM_NT, sm_bytes, s>>>(
        a.htop, y, mask, embT, probs, nl, R, W, Vp, v_real);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  score_nll_kernel<<<(B + SM_NT / 32 - 1) / (SM_NT / 32), SM_NT, 0, s>>>(
      nl, nll, B, T);
  return (int)cudaGetLastError();
}
