// One LSTM layer's forward recurrence over a precomputed input
// projection, for Hopper (sm_90a).
//
// Replaces the TPU kernel ocrd_keraslm_tpu/ops/lstm_cell.py::
// _lstm_scan_pallas_raw (forward; f32 or bf16 recurrent weights).  For
// each stream b and step t:  z = x_proj[b, t] + q(h) @ U,  gates i, f,
// g, o (sigmoid, sigmoid, tanh, sigmoid),  c = f*c + i*g,
// h = o*tanh(c).  q rounds h to bf16 (nearest even) when U is bf16 and
// is the identity when U is f32; products and sums, gates and the carry
// are f32 either way.  Writes h_all and (when asked) c_all time-major
// (T, B, W), and the final (hT, cT).
//
// What bounds it on this card: the recurrence.  Step t+1 needs step t's
// h, so a stream's T steps run in order, and a step's 2*W*4W FLOPs per
// stream are far too few for the card: the time of a step is the
// latency of its dependent chain (weights to the FMAs, the gate update,
// h to every column's next product), not bytes or operations.  The
// one-block layout (lstm_scan_kernel, one block per <= 8 streams) reads
// U (256 KiB in f32 at W=128, more than a block's shared memory) from L2
// at every step and runs each column's W FMAs on one thread, on one SM
// per group.
//
// What the design does about it (scan_common.cuh; layout chosen by
// ops/scan_layout.py from the shape and the card's cluster occupancy):
//  * the register layout (lstm_scan_reg_kernel, where a column has 2, 4
//    or 8 blocks of 32 terms): a thread-block cluster of CL blocks per
//    group of RB streams splits the gate columns (block k owns W/CL
//    units and their four gate columns, so the gate update stays in the
//    block); each lane keeps the 32 weights of one 32-term block of two
//    gate columns in registers for the whole scan, so no weight is read
//    again and one load of h feeds two FMAs; the blocks' partial sums
//    are added in block order by warp shuffles; lane j of a unit's group
//    runs row j's gate update with c, h and x_proj in its registers; the
//    new h goes into every block of the cluster by st.async, each store
//    completing on the receiving block's mbarrier, and a block waits
//    only for the step's rows to arrive: no block or cluster barrier in
//    the T loop;
//  * at W = 512 (16 blocks of 32 terms a column) the grid layout of
//    scan_common.cuh (lstm_scan_grid_kernel): groups of rb streams on
//    W/16 blocks each, one block an SM, every group resident at once (a
//    cooperative launch); a block keeps U's 64 gate columns of its 16
//    units in registers (128 weights a thread); the h rows of a step
//    cross the group's blocks through device memory (h_all itself,
//    behind the group's counter) and are staged in chunks into shared
//    memory; each thread's 32-term chains leave partial sums that one
//    thread a (stream, unit) adds in block order before its gate
//    update.  A step moves the group's h rows from L2 once a block (8
//    MiB at B=128) instead of U once a block (64 MiB);
//  * at W > 512 (AWD-LSTM enwik8's 1840), where U (54 MB) fits neither
//    the card's registers and shared memory nor L2, the wide layout of
//    wide_common.cuh (lstm_scan_wide_kernel): one block an SM, each step
//    a product of every stream's h row with the block's 64 packed gate
//    columns, both streamed by TMA in 32-term chunks, and one counter
//    over all blocks a step;
//  * every other width, and a launch whose clusters the card cannot
//    hold at once, runs the one-block kernel of the first port,
//    unchanged;
//  * h_all and c_all are written by the lane that owns each unit; under
//    a bf16 U the rows exchanged hold h rounded to bf16.
// Every layout gives dot_cols' sums in its order, so every output keeps
// the first port's bits.  All arithmetic is f32 on CUDA cores: no TF32,
// no tensor cores.

#include "scan_common.cuh"
#include "wide_common.cuh"

struct LstmArgs {
  const float* xp;  // (B, T, 4W)
  const float* h0;  // (B, W)
  const float* c0;  // (B, W)
  const void* U;    // (W, 4W) f32 or bf16
  float* h_all;     // (T, B, W)
  float* c_all;     // (T, B, W) or null
  float* hT;        // (B, W)
  float* cT;        // (B, W)
  unsigned* flags;  // the grid layout's group counters, zeroed
  int B, T, W, rb, rt;
};

// The one-block layout: each thread owns one gate column of U and keeps
// RB accumulators in registers, so one weight read (from L2) feeds RB
// FMAs; h and c (and, under a bf16 U, h rounded to bf16) live in shared
// memory, read as broadcast float4s.
template <int RB, typename WT>
__global__ void __launch_bounds__(SCAN_NT, 1)
    lstm_scan_kernel(const float* __restrict__ xp, const float* h0,
                     const float* c0, const WT* __restrict__ U, float* h_all,
                     float* c_all, float* hT, float* cT, int B, int T,
                     int W) {
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x, G = 4 * W;
  float* h = reinterpret_cast<float*>(smem4);  // (RB, W)
  float* c = h + RB * W;                       // (RB, W)
  float* z = c + RB * W;                       // (RB, G)
  // the rows the product reads: h itself (f32 U) or h rounded to bf16
  float* hq = is_bf16<WT>::value ? z + RB * G : h;
  const int s0 = blockIdx.x * RB;
  const int nr = min(RB, B - s0);
  for (int i = tid; i < RB * W; i += SCAN_NT) {
    const int r = i / W;
    const float hv = r < nr ? h0[(size_t)s0 * W + i] : 0.0f;
    h[i] = hv;
    c[i] = r < nr ? c0[(size_t)s0 * W + i] : 0.0f;
    if (is_bf16<WT>::value)
      hq[i] = round_bf16(hv);
  }
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    for (int j = tid; j < G; j += SCAN_NT) {
      float tot[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) tot[r] = 0.0f;
      dot_cols<RB, WT>(hq, W, W, U, G, j, tot);
#pragma unroll
      for (int r = 0; r < RB; ++r)
        if (r < nr)
          z[r * G + j] = xp[((size_t)(s0 + r) * T + t) * G + j] + tot[r];
    }
    __syncthreads();
    for (int i = tid; i < nr * W; i += SCAN_NT) {
      const int r = i / W, u = i - r * W;
      const float2 hc = lstm_unit(z + r * G, W, u, c[i]);
      h[i] = hc.x;
      c[i] = hc.y;
      if (is_bf16<WT>::value)
        hq[i] = round_bf16(hc.x);
      const size_t o = ((size_t)t * B + s0) * W + i;
      h_all[o] = hc.x;
      if (c_all != nullptr) c_all[o] = hc.y;
    }
    __syncthreads();
  }
  for (int i = tid; i < nr * W; i += SCAN_NT) {
    hT[(size_t)s0 * W + i] = h[i];
    cT[(size_t)s0 * W + i] = c[i];
  }
}

// gate columns a lane of the register layout holds: two, so that one
// load of h feeds two FMAs (64 weights in registers)
#define GPL 2

// The register layout (scan_common.cuh): U's 32 weights of a column
// block, of two gate columns of a unit, in each thread's registers; rows
// (2, rb, WP) padded in shared memory and their two mbarriers are all the
// block holds.  Lane j < RT
// of a unit's group runs the gate update of row j (c, h and the row's
// x_proj in its registers); the group's lanes send the new h into every
// block (st.async), and each block waits for the step's rows on its own
// mbarrier: no cluster barrier in the T loop.
template <int NKB, int RT, typename WT>
__global__ void __launch_bounds__(SCAN_NT, 1)
    lstm_scan_reg_kernel(LstmArgs p) {
  extern __shared__ float4 smem4[];
  float* hb = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = (int)cluster.num_blocks();
  const Geo g = make_geo(p.W, CL, (int)cluster.block_rank());
  const int W = p.W, B = p.B, T = p.T, RB = p.rb, WP = padded_width(W);
  const int s0 = (int)(blockIdx.x / CL) * RB, nr = min(RB, B - s0);
  uint64_t* bar = reinterpret_cast<uint64_t*>(hb + 2 * RB * WP);
  const RegRole ro = reg_role<NKB, GPL>(
      g, RB / RT, reg_group_threads(W, RB, CL, RT, GPL));
  const bool q = is_bf16<WT>::value;
  // this lane's row in the gate update, and whether it has one
  const int row = ro.rg * RT + ro.q;
  const bool mine = ro.lg == 0 && ro.valid && ro.q < RT && row < nr;
  const size_t xrow = (size_t)(s0 + row) * T * g.G + ro.u;
  PHASE_INIT

  float wr[GPL * KCH], c = 0.0f, hf = 0.0f, xc[4], xn[4];
  if (ro.lg == 0)
    load_wreg<GPL, WT>(wr, static_cast<const WT*>(p.U), g, ro);
  if (mine) {
    c = p.c0[(size_t)(s0 + row) * W + ro.u];
    hf = p.h0[(size_t)(s0 + row) * W + ro.u];
  }
#pragma unroll
  for (int gate = 0; gate < 4; ++gate) {  // x_proj of steps 0 and 1
    xc[gate] = mine && T > 0 ? p.xp[xrow + gate * W] : 0.0f;
    xn[gate] = mine && T > 1 ? p.xp[xrow + g.G + gate * W] : 0.0f;
  }
  reg_fill_rows(hb, p.h0, s0, nr, RB, W, WP, q);
  if (threadIdx.x == 0) {
    mbar_init(bar);
    mbar_init(bar + 1);
    mbar_init_fence();
  }
  cluster.sync();  // every block of the cluster runs and holds its rows

  if (ro.lg == 0)
    for (int t = 0; t < T; ++t) {
      const int nxt = (t + 1) & 1;
      if (threadIdx.x == 0) mbar_expect(bar + nxt, 4u * nr * W);
      float acc[GPL * RT];
      reg_chain<RT, GPL>(hb + ((t & 1) * RB + ro.rg * RT) * WP, WP, ro.kb,
                         W, wr, acc);
      PHASE(1)
      kb_sum<NKB, GPL * RT, 4 / GPL * NKB>(acc);
      const float h = reg_gate<NKB, RT, GPL>(acc, xc, c, hf, q, ro.q);
      PHASE(2)
      reg_send<NKB, RT, GPL>(h, hb + nxt * RB * WP, bar + nxt, WP, ro, nr,
                             CL);
      if (mine) {
        const size_t o = ((size_t)t * B + s0 + row) * W + ro.u;
        p.h_all[o] = hf;
        if (p.c_all != nullptr) p.c_all[o] = c;
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) {  // x_proj of step t+2
          xc[gate] = xn[gate];
          xn[gate] = t + 2 < T ? __ldg(p.xp + xrow + (size_t)(t + 2) * g.G +
                                       gate * W)
                               : 0.0f;
        }
      }
      PHASE(3)
      mbar_wait(bar + nxt, (t >> 1) & 1);  // every block's h of step t
      PHASE(4)
    }
  if (mine) {
    p.hT[(size_t)(s0 + row) * W + ro.u] = hf;
    p.cT[(size_t)(s0 + row) * W + ro.u] = c;
  }
  PHASE_FLUSH
  cluster.sync();  // no block leaves while another may still write to it
}

// The grid layout (scan_common.cuh; W = 512): thread (warp w, lane l)
// of block k keeps U[32kb .. 32kb + 32, g*W + u] for the four gates g of
// unit u = 16k + 2w + l/16 and the block kb = l % 16 in registers (128
// weights); per chunk of rt streams it runs the four 32-term chains of
// each stream's staged h row (rounded to bf16 when Q) and stores them
// as partial sums; thread (r, eu) of the chunk adds each gate's 16 in
// block order, adds x_proj (loaded before the products) and updates the
// unit (c in shared memory), writing h_all (the rows the next step
// reads), c_all and, at the last step, hT and cT.
#define GRID_PS (4 * GRID_UPB + 4)  // a block's partial sums of one 32-term block
// rows whose chains a thread runs at once (gen_beam_phases.py wide
// builds other values to time them)
#ifndef GRID_RU
#define GRID_RU 2
#endif

template <bool Q, typename WT>
__global__ void __launch_bounds__(GRID_NT, 1)
    lstm_scan_grid_kernel(LstmArgs p, const __grid_constant__ CUtensorMap th0,
                          const __grid_constant__ CUtensorMap th) {
  extern __shared__ float4 smem4[];
  const int W = p.W, G = 4 * W, B = p.B, T = p.T, RT = p.rt;
  const int cl = W / GRID_UPB, per = W / KCH;  // per: blocks of a row
  float* rows = grid_smem(smem4);  // (2, RT, W), swizzled
  float* part = rows + 2 * RT * W;             // (RT, GRID_NKB, PS)
  float* cs = part + RT * GRID_NKB * GRID_PS;  // (rb, GRID_UPB)
  // the staged buffers' mbarriers
  uint64_t* bar = reinterpret_cast<uint64_t*>(cs + p.rb * GRID_UPB);
  const int grp = blockIdx.x / cl, u0 = (blockIdx.x % cl) * GRID_UPB;
  const int s0 = grp * p.rb, nr = min(p.rb, B - s0);
  unsigned* flag = p.flags + grp;
  // the products' role: unit ul, 32-term block kb
  const int ul = 2 * (threadIdx.x >> 5) + ((threadIdx.x >> 4) & 1);
  const int kb = threadIdx.x & 15;
  // the sums' role: row er of a chunk, unit eu
  const int er = threadIdx.x >> 4, eu = threadIdx.x & 15;
  PHASE_INIT

  float wr[4 * KCH];
  const WT* U = static_cast<const WT*>(p.U);
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int k = 0; k < KCH; ++k)
      wr[g * KCH + k] =
          ldw(U + (size_t)(kb * KCH + k) * G + g * W + u0 + ul);
  for (int i = threadIdx.x; i < nr * GRID_UPB; i += GRID_NT)
    cs[i] = p.c0[(size_t)(s0 + i / GRID_UPB) * W + u0 + i % GRID_UPB];
  if (T == 0)
    for (int i = threadIdx.x; i < nr * GRID_UPB; i += GRID_NT) {
      const size_t o = (size_t)(s0 + i / GRID_UPB) * W + u0 + i % GRID_UPB;
      p.hT[o] = p.h0[o];
      p.cT[o] = p.c0[o];
    }
  if (threadIdx.x == 0) {
    mbar_init(bar);
    mbar_init(bar + 1);
    mbar_init_fence();
  }
  __syncthreads();
  unsigned ph = 0;  // bit b: the parity of buffer b's next phase
  const int nch = (nr + RT - 1) / RT;
  const int sw = kb & 7;  // the swizzle of the lane's blocks
  for (int t = 0; t < T; ++t) {
    // the rows of step t-1 (of the initial carry at t = 0), from block
    // row0 of th0 or th
    const CUtensorMap* tm = t == 0 ? &th0 : &th;
    const int row0 = ((t == 0 ? 0 : (t - 1) * B) + s0) * per;
    if (t > 0) group_wait(flag, (unsigned)(cl * t));
    PHASE(1)
    grid_stage_rows(rows, tm, row0, per, min(RT, nr), bar);
    for (int c = 0; c < nch; ++c) {
      const int rc = min(RT, nr - c * RT);
      const bool mine = er < rc;
      const int s = s0 + c * RT + er;
      float xg[4];
#pragma unroll
      for (int g = 0; g < 4; ++g)
        xg[g] = mine ? __ldg(p.xp + ((size_t)s * T + t) * G + g * W + u0 + eu)
                     : 0.0f;
      if (c + 1 < nch)
        grid_stage_rows(rows + ((c + 1) & 1) * RT * W, tm,
                        row0 + (c + 1) * RT * per, per,
                        min(RT, nr - (c + 1) * RT), bar + ((c + 1) & 1));
      mbar_wait(bar + (c & 1), (ph >> (c & 1)) & 1u);
      ph ^= 1u << (c & 1);
      __syncthreads();  // the sums of the chunk before are read
      PHASE(2)
      const float* xr = rows + (c & 1) * RT * W + kb * KCH;
      // RU rows at a time (more independent chains), then the rest
      auto rows_of = [&](auto ruc, int r) {
        constexpr int RU = decltype(ruc)::value;
        float acc[RU][4];
#pragma unroll
        for (int u = 0; u < RU; ++u)
#pragma unroll
          for (int g = 0; g < 4; ++g) acc[u][g] = 0.0f;
#pragma unroll
        for (int k = 0; k < KCH; k += 4) {
#pragma unroll
          for (int u = 0; u < RU; ++u) {
            float4 xv = swz_ld4(xr + (r + u) * W, k / 4, sw);
            if (Q) {
              xv.x = round_bf16(xv.x);
              xv.y = round_bf16(xv.y);
              xv.z = round_bf16(xv.z);
              xv.w = round_bf16(xv.w);
            }
#pragma unroll
            for (int g = 0; g < 4; ++g) {
              float a = acc[u][g];
              a = fmaf(xv.x, wr[g * KCH + k], a);
              a = fmaf(xv.y, wr[g * KCH + k + 1], a);
              a = fmaf(xv.z, wr[g * KCH + k + 2], a);
              a = fmaf(xv.w, wr[g * KCH + k + 3], a);
              acc[u][g] = a;
            }
          }
        }
#pragma unroll
        for (int u = 0; u < RU; ++u)
          *reinterpret_cast<float4*>(part + ((r + u) * GRID_NKB + kb) *
                                              GRID_PS +
                                     4 * ul) =
              make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
      };
      int r = 0;
      for (; r + GRID_RU <= rc; r += GRID_RU)
        rows_of(std::integral_constant<int, GRID_RU>{}, r);
      for (; r < rc; ++r) rows_of(std::integral_constant<int, 1>{}, r);
      __syncthreads();
      PHASE(3)
      if (mine) {
        float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int b = 0; b < GRID_NKB; ++b) {
          const float4 v = *reinterpret_cast<const float4*>(
              part + (er * GRID_NKB + b) * GRID_PS + 4 * eu);
          z[0] += v.x;
          z[1] += v.y;
          z[2] += v.z;
          z[3] += v.w;
        }
        float* cp = cs + (c * RT + er) * GRID_UPB + eu;
        const float2 hc = lstm_gate(xg[0] + z[0], xg[1] + z[1],
                                    xg[2] + z[2], xg[3] + z[3], *cp);
        *cp = hc.y;
        const size_t o = ((size_t)t * B + s) * W + u0 + eu;
        p.h_all[o] = hc.x;
        if (p.c_all != nullptr) p.c_all[o] = hc.y;
        if (t == T - 1) {
          p.hT[(size_t)s * W + u0 + eu] = hc.x;
          p.cT[(size_t)s * W + u0 + eu] = hc.y;
        }
      }
      PHASE(4)
    }
    group_arrive(flag);
    PHASE(5)
  }
  PHASE_FLUSH
}

// The wide layout (wide_common.cuh; W > 512): block k owns the units
// [16k, 16k + 16) and their four gate columns, packed by
// lstm_scan_wide_pack as up[k][term][4 unit + gate]; thread (rg, cq)
// runs unit 16k + cq of the rows rg, rg + 16, ..., so the four sums of
// its unit's gates and the gate update stay in its registers (c too).
// Step t's rows are h_all[t-1] (h0 at t = 0), read through the tensor
// maps th (h_all) and th0 (h0); every block arrives on the launch's
// counter once its units of h_all[t] are written.
#define WIDE_UPB 16  // units a block: 64 columns

template <bool Q>
__global__ void __launch_bounds__(WIDE_NT, 1)
    lstm_scan_wide_kernel(LstmArgs p, const float* __restrict__ up,
                          const __grid_constant__ CUtensorMap th0,
                          const __grid_constant__ CUtensorMap th) {
  extern __shared__ float4 smem4[];
  const int W = p.W, G = 4 * W, B = p.B, T = p.T, nkb = wide_chunks(W);
  const int cq = threadIdx.x & 15, rg = threadIdx.x >> 4;
  const int u = blockIdx.x * WIDE_UPB + cq;
  const bool unit = u < W;
  const float* bp = up + (size_t)blockIdx.x * nkb * KCH * WIDE_NC;
  const WideRing w = wide_ring(smem4, B);
  float c[WIDE_RPT];
#pragma unroll
  for (int i = 0; i < WIDE_RPT; ++i) {
    const int r = rg + 16 * i;
    c[i] = unit && r < B ? p.c0[(size_t)r * W + u] : 0.0f;
    if (T == 0 && unit && r < B) {
      p.hT[(size_t)r * W + u] = p.h0[(size_t)r * W + u];
      p.cT[(size_t)r * W + u] = c[i];
    }
  }
  unsigned it = 0;
  for (int t = 0; t < T; ++t) {
    // this step's x_proj into L2 while the product runs
    if (unit)
#pragma unroll
      for (int i = 0; i < WIDE_RPT; ++i) {
        const int r = rg + 16 * i;
        if (r < B)
#pragma unroll
          for (int g = 0; g < 4; ++g)
            asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
                p.xp + ((size_t)r * T + t) * G + g * W + u));
      }
    if (t > 0) group_wait(p.flags, (unsigned)(gridDim.x * t));
    float tot[WIDE_RPT][4];
    wide_product<Q>(w, t == 0 ? &th0 : &th, 0, t == 0 ? 0 : (t - 1) * B, bp,
                    nkb, it, tot);
    if (unit)
#pragma unroll
      for (int i = 0; i < WIDE_RPT; ++i) {
        const int r = rg + 16 * i;
        if (r >= B) continue;
        const float* x = p.xp + ((size_t)r * T + t) * G + u;
        const float2 hc = lstm_gate(x[0] + tot[i][0], x[W] + tot[i][1],
                                    x[2 * W] + tot[i][2],
                                    x[3 * W] + tot[i][3], c[i]);
        c[i] = hc.y;
        const size_t o = ((size_t)t * B + r) * W + u;
        p.h_all[o] = hc.x;
        if (p.c_all != nullptr) p.c_all[o] = hc.y;
        if (t == T - 1) {
          p.hT[(size_t)r * W + u] = hc.x;
          p.cT[(size_t)r * W + u] = hc.y;
        }
      }
    group_arrive(p.flags);
  }
}

// up[k][i][4 ul + g] = U[i, g W + 16k + ul] as f32 for the wide layout's
// blocks k, terms i < 32 * wide_chunks(W) and units 16k + ul, 0 past W
template <typename WT>
__global__ void __launch_bounds__(256)
    lstm_scan_wide_pack(const WT* __restrict__ U, float* up, int W,
                        size_t n) {
  const size_t idx = (size_t)blockIdx.x * 256 + threadIdx.x;
  if (idx >= n) return;
  const int col = (int)(idx % WIDE_NC);
  const size_t rest = idx / WIDE_NC;
  const int kp = wide_chunks(W) * KCH;
  const int i = (int)(rest % kp), k = (int)(rest / kp);
  const int u = k * WIDE_UPB + col / 4, g = col % 4;
  up[idx] = i < W && u < W ? ldw(U + (size_t)i * 4 * W + g * W + u) : 0.0f;
}

// bytes of dynamic shared memory a block of the layout asks: the
// register layout's padded rows (2, rb, WP) and two mbarriers, or the
// one-block layout's rows (h, c, z and, under a bf16 U, the rounded h)
static size_t lstm_scan_smem_bytes(int W, int u_bf16, int rb, int rt,
                                   int mode) {
  if (mode == MODE_GRID)  // 1024 bytes to align the rows, 2 mbarriers
    return 1024 + (size_t)4 * (2 * rt * W + rt * GRID_NKB * GRID_PS +
                               rb * GRID_UPB) +
           2 * 8;
  if (mode == MODE_REG) return (size_t)2 * rb * padded_width(W) * 4 + 2 * 8;
  return (size_t)rb * (2 * W + 4 * W + (u_bf16 ? W : 0)) * sizeof(float);
}

// the grid layout's streams a staged chunk at most (ops/scan_layout.py
// GRID_RT; gen_beam_phases.py wide builds other values to time them)
#ifndef GRID_RT
#define GRID_RT 16
#endif
// one thread a (stream, unit) of a chunk runs its sums and update
static_assert(GRID_RT <= GRID_NT / GRID_UPB, "a chunk's streams > 16");

template <typename WT>
static int run(const LstmArgs& a, int cl, int rt, int mode, size_t smem,
               cudaStream_t stream, int* fits) {
  if (mode == MODE_ONE) {
    return dispatch_rows(a.rb, [&](auto rbc) {
      constexpr int RB = decltype(rbc)::value;
      cudaError_t err = cudaFuncSetAttribute(
          lstm_scan_kernel<RB, WT>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      lstm_scan_kernel<RB, WT><<<(a.B + RB - 1) / RB, SCAN_NT, smem,
                                 stream>>>(
          a.xp, a.h0, a.c0, static_cast<const WT*>(a.U), a.h_all, a.c_all,
          a.hT, a.cT, a.B, a.T, a.W);
      return (int)cudaGetLastError();
    });
  }
  const int groups = (a.B + a.rb - 1) / a.rb;
  if (mode == MODE_GRID) {
    cudaError_t err =
        cudaMemsetAsync(a.flags, 0, groups * sizeof(unsigned), stream);
    if (err != cudaSuccess) return (int)err;
    // the tensor maps of the rows the steps read: h0, then h_all (none
    // without steps)
    CUtensorMap th0 = {}, th = {};
    int e = 0;
    if (a.T > 0) {
      e = encode_rows(&th0, a.h0, (size_t)a.B * a.W / KCH, a.W / KCH);
      if (e == 0)
        e = encode_rows(&th, a.h_all, (size_t)a.T * a.B * a.W / KCH,
                        a.W / KCH);
    }
    if (e != 0) return e;
    constexpr bool Q = is_bf16<WT>::value;
    return grid_launch(lstm_scan_grid_kernel<Q, WT>, groups * cl, smem,
                       stream, a, th0, th);
  }
  const int clusters = fits ? 1 : groups;
  return dispatch_nkb_rt((a.W + KCH - 1) / KCH, rt, [&](auto nkbc, auto rtc) {
    constexpr int NKB = decltype(nkbc)::value, RT = decltype(rtc)::value;
    return cluster_launch(lstm_scan_reg_kernel<NKB, RT, WT>, a, cl, clusters,
                          smem, stream, fits);
  });
}

// Refuses (invalid value) a layout that is not the register layout of
// ops/scan_layout.py, the grid layout (W = 512, cl = W/16 blocks a group
// of 1 <= rb <= B streams, rt = grid_chunk_rows(rb, GRID_RT, the plan),
// the group counters given) or the one-block layout (one_block_rows_ok
// streams, cl 1, rt rb), or whose smem differs from
// lstm_scan_smem_bytes.
static int checked_run(const LstmArgs& a, int u_bf16, int cl, int rt,
                       int mode, size_t smem, cudaStream_t stream,
                       int* fits) {
  bool ok = a.B >= 1 && a.W >= 4 && a.W % 4 == 0;
  if (mode == MODE_REG)
    ok = ok && reg_layout_ok(a.W, 1, a.rb, cl, rt, GPL);
  else if (mode == MODE_GRID)
    ok = ok && !fits && grid_width_ok(a.W) && cl == a.W / GRID_UPB &&
         a.rb >= 1 && a.rb <= a.B && a.flags != nullptr &&
         rt == grid_chunk_rows(a.rb, GRID_RT, [&](int r) {
           return lstm_scan_smem_bytes(a.W, u_bf16, a.rb, r, MODE_GRID);
         });
  else
    ok = ok && mode == MODE_ONE && !fits && one_block_rows_ok(a.B, a.rb) &&
         cl == 1 && rt == a.rb;
  ok = ok && smem == lstm_scan_smem_bytes(a.W, u_bf16, a.rb, rt, mode);
  if (!ok) return (int)cudaErrorInvalidValue;
  return u_bf16 ? run<__nv_bfloat16>(a, cl, rt, mode, smem, stream, fits)
                : run<float>(a, cl, rt, mode, smem, stream, fits);
}

// How many clusters of the register layout the card holds at once (0 if
// none).
extern "C" int lstm_scan_max_clusters(int W, int u_bf16, int rb, int cl,
                                      int rt, size_t smem) {
  LstmArgs a{};
  a.B = rb, a.W = W, a.rb = rb;
  int fits = 0;
  return checked_run(a, u_bf16, cl, rt, MODE_REG, smem, 0, &fits) == 0
             ? fits
             : 0;
}

// U points to W*4W floats, or to W*4W bf16 values when u_bf16 is set;
// (rb, cl, rt, mode) is the layout (mode: MODE_ONE, MODE_REG or
// MODE_GRID) and smem its shared memory (ops/scan_layout.py), which must
// equal lstm_scan_smem_bytes; flags is the grid layout's scratch of
// ceil(B / rb) counters (zeroed here), else unused
extern "C" int lstm_scan_launch(const float* xp, const float* h0,
                                const float* c0, const void* U,
                                float* h_all, float* c_all, float* hT,
                                float* cT, unsigned* flags, int B, int T,
                                int W, int u_bf16, int rb, int cl, int rt,
                                int mode, size_t smem, void* stream) {
  LstmArgs a{xp, h0, c0, U, h_all, c_all, hT, cT, flags, B, T, W, rb, rt};
  return checked_run(a, u_bf16, cl, rt, mode, smem, (cudaStream_t)stream,
                     nullptr);
}

// Whether the wide layout takes B streams of width W: W > 512 (wider
// than every other layout) and W % 4 == 0, 1 <= B <= WIDE_RB, and its
// ceil(W / 16) blocks at most `n_sm` (one block an SM, all at once).
static inline bool lstm_scan_wide_ok(int B, int W, int n_sm) {
  return W > GRID_NKB * KCH && W % 4 == 0 && B >= 1 && B <= WIDE_RB &&
         (W + WIDE_UPB - 1) / WIDE_UPB <= n_sm;
}

// The wide layout's launch (wide_common.cuh): up is scratch of
// ceil(W / 16) * 32 * wide_chunks(W) * 64 floats (the packed U, written
// here), flags one counter (zeroed here), smem WIDE_SMEM_BYTES;
// refuses (invalid value) a shape that lstm_scan_wide_ok does not take or
// another smem.
extern "C" int lstm_scan_wide_launch(const float* xp, const float* h0,
                                     const float* c0, const void* U,
                                     float* h_all, float* c_all, float* hT,
                                     float* cT, unsigned* flags, float* up,
                                     int B, int T, int W, int u_bf16,
                                     size_t smem, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  if (!lstm_scan_wide_ok(B, W, n_sm) || flags == nullptr || up == nullptr ||
      smem != WIDE_SMEM_BYTES)
    return (int)cudaErrorInvalidValue;
  const int blocks = (W + WIDE_UPB - 1) / WIDE_UPB;
  const size_t n = (size_t)blocks * wide_chunks(W) * KCH * WIDE_NC;
  const unsigned grid = (unsigned)((n + 255) / 256);
  if (u_bf16)
    lstm_scan_wide_pack<__nv_bfloat16><<<grid, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(U), up, W, n);
  else
    lstm_scan_wide_pack<float>
        <<<grid, 256, 0, s>>>(static_cast<const float*>(U), up, W, n);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = cudaMemsetAsync(flags, 0, sizeof(unsigned), s);
  if (err != cudaSuccess) return (int)err;
  // the rows the steps read: h0, then h_all (none without steps)
  CUtensorMap th0 = {}, th = {};
  if (T > 0) {
    int e = encode_wide(&th0, h0, B, 1, W, B);
    if (e == 0) e = encode_wide(&th, h_all, (size_t)T * B, 1, W, B);
    if (e != 0) return e;
  }
  const LstmArgs a{xp, h0, c0, U, h_all, c_all, hT, cT, flags, B, T, W, B, 1};
  return u_bf16 ? grid_launch(lstm_scan_wide_kernel<true>, blocks, smem, s, a,
                              (const float*)up, th0, th)
                : grid_launch(lstm_scan_wide_kernel<false>, blocks, smem, s,
                              a, (const float*)up, th0, th);
}
