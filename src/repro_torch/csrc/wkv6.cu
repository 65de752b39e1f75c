// RWKV6 "Finch" WKV recurrence for Hopper (sm_90a), exact form.
//
// Replaces the Pallas TPU kernel repro/kernels/wkv6/kernel.py (`wkv6`,
// body `_kernel`), which keeps each (batch, head)'s hd x hd fp32 state in
// VMEM across a sequential grid axis over time.  Per (b, h) and step t:
//
//   y_t = r_t^T (S + u (.) k_t v_t^T)       S <- diag(w_t) S + k_t v_t^T
//
// with S[i][j] indexed (k-dim, v-dim).  Exact recurrence, no chunked 1/P
// rescaling (which overflows for small decays).
//
// What bounds it on this card: dispatching FP32 instructions, not bytes.
// Per (b, t, h) the kernel reads r, k, v (bf16 on the model's path) and w
// (fp32) and writes y (fp32): 14·hd bytes, 0.29 ms at the rwkv prefill
// shape (16 x 1024 x 64 heads of 64) over 3.35 TB/s.  The exact step
// costs 3 FP32 lane-instructions per state element (the y FMA, the k·v
// MUL, the decay FMA): 12.9 G at that shape, 0.39 ms at 132 SMs x 128
// lanes x 1.98 GHz, and every other instruction (loads, bf16 conversion,
// shuffles, addresses) takes a dispatch slot beside them.  The design cuts
// both the FP32 work and what surrounds it:
//
// * One warp a (b, h) pair, the state in registers.  At hd 64 each lane
//   keeps a 16 x 8 tile (rows i, columns j) for the whole sequence: 128
//   state registers, up to 255 in all, 8 blocks an SM, so the 1024 pairs
//   of the prefill shape are resident at once.  Per step a lane reads r,
//   k, w for its rows and v for its columns from shared memory in wide
//   loads: per two steps 24 loads and 88 bf16 conversions beside the 640
//   FP32 instructions on its tile.  Its columns are 4-wide pieces 32
//   apart, so a warp reads and writes whole 32-byte sectors of a state
//   row.
// * Two steps a pass.  The state advances over steps a, b at once, with
//   products of w only (no division):
//     S'' = diag(w_b w_a) S + (w_b k_a) v_a^T + k_b v_b^T
//     y_b = (r_b w_a)^T S + (r_b . k_a) v_a + (r_b . u k_b) v_b
//   5 FP32 instructions per element for two steps instead of 6; an odd
//   last step takes the one-step form (WKV_TWO_STEP=0 keeps it always).
// * The bonus across the warp.  The 8 lanes of a row group each sum 2 of
//   its 16 rows of r·u·k (and r_b·k_a), add the 8 partials with three
//   shuffles and fold v_j times the sum into their y partials; the 4 row
//   groups then sum y by a reduce-scatter of `__shfl_xor_sync`, which
//   leaves each lane 2 whole y values, stored straight from registers
//   (a warp writes the 256-byte y row in one instruction).
// * A `cp.async` ring.  r, k, v, w go from device memory to shared memory
//   in 16-byte pieces (`.cg`): 4 stages of 8 steps (20 KB), the next 3
//   chunks in flight while one is computed, one barrier a chunk.  The
//   ragged last chunk copies and computes only its valid steps.  Inputs
//   whose pointers or strides are not 16-byte aligned are copied element
//   by element through the same ring.
// * state_in and state_out may be the same buffer: each lane reads its
//   own tile before the loop and writes it after, and no other lane
//   touches it.
//
// Build-time hooks, for tools/wkv6_probe.py (each defaults to the build
// above): WKV_TI x WKV_TJ the hd-64 tile, WKV_CT steps a chunk, WKV_S ring
// stages, WKV_TWO_STEP the two-step update, WKV_MARK(k) a phase mark.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#ifndef WKV_TI
#define WKV_TI 16
#endif
#ifndef WKV_TJ
#define WKV_TJ 8
#endif
#ifndef WKV_CT
#define WKV_CT 8
#endif
#ifndef WKV_S
#define WKV_S 4
#endif
#ifndef WKV_TWO_STEP
#define WKV_TWO_STEP 1
#endif
#ifndef WKV_MARK
#define WKV_MARK(k)
#endif

namespace {

constexpr int CT = WKV_CT;  // time steps a chunk
constexpr int S = WKV_S;    // ring stages
static_assert(S >= 2, "the ring needs two stages");
static_assert(!WKV_TWO_STEP || CT % 2 == 0, "two-step chunks are even");

// the tile a thread holds, per head dim: TI rows x TJ columns
template <int HD> struct Tile;
template <> struct Tile<16> { static constexpr int TI = 4, TJ = 2; };
template <> struct Tile<32> { static constexpr int TI = 8, TJ = 4; };
template <> struct Tile<64> { static constexpr int TI = WKV_TI, TJ = WKV_TJ; };

// A thread (row group ig, column group jg) holds rows ig·TI + [0, TI) and
// its TJ columns in pieces of VW: piece p is columns p·VW·NJG + jg·VW +
// [0, VW), so that the column groups of a warp cover whole 32-byte
// sectors of a state row with each vector load or store.
template <int HD> struct Shape {
  static constexpr int TI = Tile<HD>::TI, TJ = Tile<HD>::TJ;
  static constexpr int NIG = HD / TI;           // row groups (lanes of a sum)
  static constexpr int NJG = HD / TJ;           // column groups
  static constexpr int NT = NIG * NJG;          // threads a block
  static constexpr int VW = TJ < 4 ? TJ : 4;    // columns a piece
  static constexpr int PS = VW * NJG;           // columns from piece to piece
  static constexpr int R = TJ >= NIG ? TJ / NIG : 1;  // y values a lane stores
  // bonus rows a lane sums when the column groups of a warp split a row
  // group's TI rows (TI · NIG = HD rows over 32 lanes); 0: each its own
  static constexpr int RB = HD >= 32 ? HD / 32 : 0;
  static constexpr int UB = RB > 0 ? RB : TI;  // bonus rows a thread sums
  static_assert(HD % TI == 0 && HD % TJ == 0 && TJ % VW == 0, "tile");
  static_assert(NIG <= 32 && 32 % NIG == 0 && NT % 32 == 0, "lanes");
  static_assert(R <= VW, "a lane's y values lie in one piece");
  // column of the thread's value q (jg's own columns start at jg·VW)
  __device__ static __forceinline__ int col(int jg, int q) {
    return (q / VW) * PS + jg * VW + q % VW;
  }
};

struct Args {
  const void* r;        // (B, T, H, hd), last dim contiguous
  const void* k;        // same dtype and strides as r
  const void* v;        // same dtype and strides as r
  int64_t sb, st, sh;   // element strides of r, k, v
  const void* w;        // (B, T, H, hd), last dim contiguous
  int64_t wsb, wst, wsh;
  const float* u;       // (H, hd) contiguous
  const float* s_in;    // (B, H, hd, hd) contiguous
  float* s_out;         // (B, H, hd, hd) contiguous; may be s_in
  float* y;             // (B, T, H, hd) contiguous
  int T, H, BH;
  bool vec;             // r, k, v, w (pointers, strides) and states 16-byte aligned
};

template <typename RKV, typename WT, int HD> struct Smem {
  RKV r[S][CT][HD], k[S][CT][HD], v[S][CT][HD];
  WT w[S][CT][HD];
};

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage n <= CT steps of one (B, T, H, hd) input, starting at src, into
// dst[CT][HD]: 16-byte cp.async pieces, or elements when not aligned.
template <typename E, int HD, int NT>
__device__ __forceinline__ void stage(E* dst, const E* src, int64_t st, int n, int tid,
                                      bool vec) {
  constexpr int PER = 16 / sizeof(E);
  constexpr int ROW = HD / PER;  // pieces a step
  if (vec) {
#pragma unroll
    for (int q = 0; q < (CT * ROW + NT - 1) / NT; ++q) {
      const int p = tid + q * NT, c = p / ROW, e = (p % ROW) * PER;
      if (p < CT * ROW && c < n) cp16(dst + c * HD + e, src + c * st + e);
    }
  } else {
    for (int p = tid; p < n * HD; p += NT) dst[p] = src[(p / HD) * st + p % HD];
  }
}

__device__ __forceinline__ float lo(uint32_t x) { return __uint_as_float(x << 16); }
__device__ __forceinline__ float hi(uint32_t x) { return __uint_as_float(x & 0xffff0000u); }

// N consecutive values at p (shared or global, 16-byte aligned when N
// fills 16 bytes) as fp32, in the widest loads that fit.
template <int N>
__device__ __forceinline__ void ld(const float* p, float (&o)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N; q += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + q);
      o[q] = x.x; o[q + 1] = x.y; o[q + 2] = x.z; o[q + 3] = x.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int q = 0; q < N; q += 2) {
      const float2 x = *reinterpret_cast<const float2*>(p + q);
      o[q] = x.x; o[q + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) o[q] = p[q];
  }
}
template <int N>
__device__ __forceinline__ void ld(const __nv_bfloat16* p, float (&o)[N]) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int q = 0; q < N; q += 8) {
      const uint4 x = *reinterpret_cast<const uint4*>(p + q);
      o[q] = lo(x.x); o[q + 1] = hi(x.x); o[q + 2] = lo(x.y); o[q + 3] = hi(x.y);
      o[q + 4] = lo(x.z); o[q + 5] = hi(x.z); o[q + 6] = lo(x.w); o[q + 7] = hi(x.w);
    }
  } else if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N; q += 4) {
      const uint2 x = *reinterpret_cast<const uint2*>(p + q);
      o[q] = lo(x.x); o[q + 1] = hi(x.x); o[q + 2] = lo(x.y); o[q + 3] = hi(x.y);
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int q = 0; q < N; q += 2) {
      const uint32_t x = *reinterpret_cast<const uint32_t*>(p + q);
      o[q] = lo(x); o[q + 1] = hi(x);
    }
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) o[q] = lo(*reinterpret_cast<const uint16_t*>(p + q));
  }
}

// The TJ values of a thread's columns from a row whose column jg·VW is
// at p: TJ / VW pieces, PS apart.
template <int HD, typename E>
__device__ __forceinline__ void ld_cols(const E* p, float (&o)[Shape<HD>::TJ]) {
  using Sh = Shape<HD>;
#pragma unroll
  for (int q = 0; q < Sh::TJ; q += Sh::VW) {
    float x[Sh::VW];
    ld<Sh::VW>(p + (q / Sh::VW) * Sh::PS, x);
#pragma unroll
    for (int e = 0; e < Sh::VW; ++e) o[q + e] = x[e];
  }
}

template <int N>
__device__ __forceinline__ void st_vec(float* p, const float (&o)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N; q += 4)
      *reinterpret_cast<float4*>(p + q) = make_float4(o[q], o[q + 1], o[q + 2], o[q + 3]);
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int q = 0; q < N; q += 2) *reinterpret_cast<float2*>(p + q) = make_float2(o[q], o[q + 1]);
  } else {
    p[0] = o[0];
  }
}

// Sum y[TJ] over the NIG lanes (xor masks M, M/2, .., 1) that share a
// column group, halving the values a lane keeps while N > 1: the lane
// ends with y[0, N_final) whole, at column offset `off` in its group.
template <int M, int N, int TJ>
__device__ __forceinline__ void reduce(float (&y)[TJ], int ig, int& off) {
  if constexpr (N > 1) {
    constexpr int HN = N / 2;
    const bool up = (ig & M) != 0;
#pragma unroll
    for (int q = 0; q < HN; ++q) {
      const float send = up ? y[q] : y[q + HN];
      const float keep = up ? y[q + HN] : y[q];
      y[q] = keep + __shfl_xor_sync(0xffffffffu, send, M);
    }
    off += up ? HN : 0;
    if constexpr (M > 1) reduce<M / 2, HN, TJ>(y, ig, off);
  } else {
    y[0] += __shfl_xor_sync(0xffffffffu, y[0], M);
    if constexpr (M > 1) reduce<M / 2, 1, TJ>(y, ig, off);
  }
}

// The whole y of one step from the lanes' partials, stored to out (one
// row of y in device memory).
template <int HD>
__device__ __forceinline__ void emit(float (&y)[Shape<HD>::TJ], int ig, int jg, float* out) {
  using Sh = Shape<HD>;
  int off = 0;
  if constexpr (Sh::NIG > 1) reduce<Sh::NIG / 2, Sh::TJ, Sh::TJ>(y, ig, off);
  if (Sh::TJ >= Sh::NIG || (ig & (Sh::NIG / Sh::TJ - 1)) == 0) {
    float o[Sh::R];
#pragma unroll
    for (int q = 0; q < Sh::R; ++q) o[q] = y[q];
    st_vec<Sh::R>(out + Sh::col(jg, off), o);
  }
}

// Bonus terms of a step for the thread's row group: out[n] = sum over
// rows of a_n · b_n, times u where bit n of WITH_U is set.  Where a
// warp's column groups can split the group's TI rows (RB > 0), each lane
// sums its RB rows (a_n, b_n point at them; u holds their u) and the
// warp adds the lanes of its column groups; otherwise each thread sums
// all TI rows.
template <int HD, int N, int WITH_U, typename RKV>
__device__ __forceinline__ void bonus_terms(const RKV* const (&a)[N], const RKV* const (&b)[N],
                                            const float (&u)[Shape<HD>::UB], float (&out)[N]) {
  using Sh = Shape<HD>;
#pragma unroll
  for (int n = 0; n < N; ++n) {
    float x[Sh::UB], y[Sh::UB];
    ld<Sh::UB>(a[n], x);
    ld<Sh::UB>(b[n], y);
    out[n] = 0.f;
#pragma unroll
    for (int e = 0; e < Sh::UB; ++e)
      out[n] = fmaf((WITH_U >> n) & 1 ? x[e] * u[e] : x[e], y[e], out[n]);
  }
  if constexpr (Sh::RB > 0) {
#pragma unroll
    for (int m = Sh::NIG; m < 32; m *= 2)
#pragma unroll
      for (int n = 0; n < N; ++n) out[n] += __shfl_xor_sync(0xffffffffu, out[n], m);
  }
}

// One step: y partials from the old state and the bonus, then the state
// update.  r, k, w point at the thread's first row, v at its first
// column, of the step's row in the ring; `bo` is the offset of the rows
// whose bonus the lane sums and u holds their u.  Rows go four at a
// time, so that few row values are live at once.
template <int HD, typename RKV, typename WT, int TI = Shape<HD>::TI, int TJ = Shape<HD>::TJ>
__device__ __forceinline__ void one_step(float (&s)[TI][TJ], const float (&u)[Shape<HD>::UB], int bo,
                                         const RKV* r, const RKV* k, const RKV* v, const WT* w,
                                         float (&y)[TJ]) {
  constexpr int RG = TI < 4 ? TI : 4;
  float bonus[1];
  bonus_terms<HD, 1, 1, RKV>({r + bo}, {k + bo}, u, bonus);
  float vv[TJ];
  ld_cols<HD>(v, vv);
#pragma unroll
  for (int q = 0; q < TJ; ++q) y[q] = 0.f;
#pragma unroll
  for (int i0 = 0; i0 < TI; i0 += RG) {
    float rr[RG], kk[RG], ww[RG];
    ld<RG>(r + i0, rr);
    ld<RG>(k + i0, kk);
    ld<RG>(w + i0, ww);
#pragma unroll
    for (int e = 0; e < RG; ++e)
#pragma unroll
      for (int q = 0; q < TJ; ++q) {
        y[q] = fmaf(rr[e], s[i0 + e][q], y[q]);
        s[i0 + e][q] = fmaf(ww[e], s[i0 + e][q], kk[e] * vv[q]);
      }
  }
  // the bonus last: its sum over lanes is then off the path of the FMAs
#pragma unroll
  for (int q = 0; q < TJ; ++q) y[q] = fmaf(vv[q], bonus[0], y[q]);
}

// Two steps a, b in one pass over the state (the header's two-step form).
// `step` is the distance from a step's row to the next in the ring.
template <int HD, typename RKV, typename WT, int TI = Shape<HD>::TI, int TJ = Shape<HD>::TJ>
__device__ __forceinline__ void two_steps(float (&s)[TI][TJ], const float (&u)[Shape<HD>::UB], int bo,
                                          const RKV* ra, const RKV* ka, const RKV* va,
                                          const WT* wa, int step, float (&ya)[TJ],
                                          float (&yb)[TJ]) {
  constexpr int RG = TI < 4 ? TI : 4;
  const RKV* rb = ra + step;
  const RKV* kb = ka + step;
  float bon[3];  // r_a·u·k_a, r_b·u·k_b, r_b·k_a
  bonus_terms<HD, 3, 0b011, RKV>({ra + bo, rb + bo, rb + bo}, {ka + bo, kb + bo, ka + bo}, u,
                                 bon);
  float v_a[TJ], v_b[TJ];
  ld_cols<HD>(va, v_a);
  ld_cols<HD>(va + step, v_b);
#pragma unroll
  for (int q = 0; q < TJ; ++q) ya[q] = yb[q] = 0.f;
#pragma unroll
  for (int i0 = 0; i0 < TI; i0 += RG) {
    float r_a[RG], k_a[RG], w_a[RG], r_b[RG], k_b[RG], w_b[RG];
    ld<RG>(ra + i0, r_a);
    ld<RG>(ka + i0, k_a);
    ld<RG>(wa + i0, w_a);
    ld<RG>(rb + i0, r_b);
    ld<RG>(kb + i0, k_b);
    ld<RG>(wa + step + i0, w_b);
#pragma unroll
    for (int e = 0; e < RG; ++e) {
      const float rbw = r_b[e] * w_a[e], ww = w_b[e] * w_a[e], wk = w_b[e] * k_a[e];
#pragma unroll
      for (int q = 0; q < TJ; ++q) {
        ya[q] = fmaf(r_a[e], s[i0 + e][q], ya[q]);
        yb[q] = fmaf(rbw, s[i0 + e][q], yb[q]);
        s[i0 + e][q] = fmaf(ww, s[i0 + e][q], fmaf(wk, v_a[q], k_b[e] * v_b[q]));
      }
    }
  }
#pragma unroll
  for (int q = 0; q < TJ; ++q) {
    ya[q] = fmaf(v_a[q], bon[0], ya[q]);
    yb[q] = fmaf(v_a[q], bon[2], fmaf(v_b[q], bon[1], yb[q]));
  }
}

template <typename RKV, typename WT, int HD>
__global__ void __launch_bounds__(Shape<HD>::NT, 8) wkv6_kernel(Args a) {
  using Sh = Shape<HD>;
  constexpr int TI = Sh::TI, TJ = Sh::TJ, NT = Sh::NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<RKV, WT, HD>& sm = *reinterpret_cast<Smem<RKV, WT, HD>*>(smem_raw);
  WKV_MARK(0);

  const int tid = threadIdx.x;
  const int ig = tid % Sh::NIG, jg = tid / Sh::NIG;
  const int i0 = ig * TI, j0 = jg * Sh::VW;
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const RKV* rp = static_cast<const RKV*>(a.r) + b * a.sb + h * a.sh;
  const RKV* kp = static_cast<const RKV*>(a.k) + b * a.sb + h * a.sh;
  const RKV* vp = static_cast<const RKV*>(a.v) + b * a.sb + h * a.sh;
  const WT* wp = static_cast<const WT*>(a.w) + b * a.wsb + h * a.wsh;
  const int nch = (a.T + CT - 1) / CT;

  auto load_chunk = [&](int c) {
    const int slot = c % S, n = min(CT, a.T - c * CT);
    const int64_t t0 = static_cast<int64_t>(c) * CT;
    stage<RKV, HD, NT>(&sm.r[slot][0][0], rp + t0 * a.st, a.st, n, tid, a.vec);
    stage<RKV, HD, NT>(&sm.k[slot][0][0], kp + t0 * a.st, a.st, n, tid, a.vec);
    stage<RKV, HD, NT>(&sm.v[slot][0][0], vp + t0 * a.st, a.st, n, tid, a.vec);
    stage<WT, HD, NT>(&sm.w[slot][0][0], wp + t0 * a.wst, a.wst, n, tid, a.vec);
  };
#pragma unroll
  for (int c = 0; c < S - 1; ++c) {
    if (c < nch) load_chunk(c);
    cp_commit();
  }

  // the thread's tile of the state, in flight beside the first chunks
  float s[TI][TJ];
  const int64_t tile = static_cast<int64_t>(bh) * HD * HD + i0 * HD;
#pragma unroll
  for (int i = 0; i < TI; ++i) {
    if (a.vec) {
      ld_cols<HD>(a.s_in + tile + i * HD + j0, s[i]);
    } else {
#pragma unroll
      for (int q = 0; q < TJ; ++q) s[i][q] = a.s_in[tile + i * HD + Sh::col(jg, q)];
    }
  }
  // the rows whose bonus terms the lane sums, and their u
  const int bo = Sh::RB > 0 ? (jg % (32 / Sh::NIG)) * Sh::RB : 0;
  float u[Sh::UB];
#pragma unroll
  for (int e = 0; e < Sh::UB; ++e) u[e] = a.u[h * HD + i0 + bo + e];
  WKV_MARK(1);

  float* yrow = a.y + (static_cast<int64_t>(b) * a.T * a.H + h) * HD;
  const int64_t y_st = static_cast<int64_t>(a.H) * HD;
  for (int c = 0; c < nch; ++c) {
    WKV_MARK(2);
    cp_wait<S - 2>();
    __syncthreads();  // chunk c landed for all; chunk c - 1 consumed by all
    WKV_MARK(3);
    if (c + S - 1 < nch) load_chunk(c + S - 1);  // into the slot chunk c - 1 left
    cp_commit();
    WKV_MARK(4);
    const int slot = c % S, n = min(CT, a.T - c * CT);
    const int64_t t0 = static_cast<int64_t>(c) * CT;
    auto out = [&](int t) { return yrow + (t0 + t) * y_st; };
    int t = 0;
#if WKV_TWO_STEP
    for (; t + 1 < n; t += 2) {
      float ya[TJ], yb[TJ];
      two_steps<HD>(s, u, bo, &sm.r[slot][t][i0], &sm.k[slot][t][i0], &sm.v[slot][t][j0],
                    &sm.w[slot][t][i0], HD, ya, yb);
      emit<HD>(ya, ig, jg, out(t));
      emit<HD>(yb, ig, jg, out(t + 1));
    }
#endif
#pragma unroll 1
    for (; t < n; ++t) {
      float y[TJ];
      one_step<HD>(s, u, bo, &sm.r[slot][t][i0], &sm.k[slot][t][i0], &sm.v[slot][t][j0],
                   &sm.w[slot][t][i0], y);
      emit<HD>(y, ig, jg, out(t));
    }
  }
  WKV_MARK(5);
#pragma unroll
  for (int i = 0; i < TI; ++i) {
    if (a.vec) {
#pragma unroll
      for (int q = 0; q < TJ; q += Sh::VW) {
        float x[Sh::VW];
#pragma unroll
        for (int e = 0; e < Sh::VW; ++e) x[e] = s[i][q + e];
        st_vec<Sh::VW>(a.s_out + tile + i * HD + Sh::col(jg, q), x);
      }
    } else {
#pragma unroll
      for (int q = 0; q < TJ; ++q) a.s_out[tile + i * HD + Sh::col(jg, q)] = s[i][q];
    }
  }
  WKV_MARK(6);
}

// Dynamic shared memory of one block; above 48 KB (a probe's ring only)
// the kernel is allowed it once.
template <typename RKV, typename WT, int HD>
size_t smem_bytes() {
  constexpr size_t bytes = sizeof(Smem<RKV, WT, HD>);
  if constexpr (bytes > 48 * 1024) {
    static const cudaError_t once = cudaFuncSetAttribute(
        wkv6_kernel<RKV, WT, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    (void)once;
  }
  return bytes;
}

// Launch (blocks == nullptr) or ask how many blocks an SM holds.
template <typename RKV, typename WT, int HD>
cudaError_t run(const Args& a, cudaStream_t s, int* blocks) {
  if (blocks)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, wkv6_kernel<RKV, WT, HD>,
                                                         Shape<HD>::NT, smem_bytes<RKV, WT, HD>());
  wkv6_kernel<RKV, WT, HD><<<a.BH, Shape<HD>::NT, smem_bytes<RKV, WT, HD>(), s>>>(a);
  return cudaSuccess;
}

template <typename RKV, typename WT>
cudaError_t by_hd(const Args& a, int hd, cudaStream_t s, int* blocks) {
  switch (hd) {
    case 16: return run<RKV, WT, 16>(a, s, blocks);
    case 32: return run<RKV, WT, 32>(a, s, blocks);
    case 64: return run<RKV, WT, 64>(a, s, blocks);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t by_dtype(const Args& a, int rkv_dtype, int w_dtype, int hd, cudaStream_t s,
                     int* blocks = nullptr) {
  using bf16 = __nv_bfloat16;
  if (rkv_dtype == 0 && w_dtype == 0) return by_hd<float, float>(a, hd, s, blocks);
  if (rkv_dtype == 0 && w_dtype == 1) return by_hd<float, bf16>(a, hd, s, blocks);
  if (rkv_dtype == 1 && w_dtype == 0) return by_hd<bf16, float>(a, hd, s, blocks);
  if (rkv_dtype == 1 && w_dtype == 1) return by_hd<bf16, bf16>(a, hd, s, blocks);
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p, int64_t s0, int64_t s1, int64_t s2, int elem) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (s0 * elem) % 16 == 0 &&
         (s1 * elem) % 16 == 0 && (s2 * elem) % 16 == 0;
}

}  // namespace

// r, k, v (B, T, H, hd) of dtype rkv_dtype (0 fp32, 1 bf16), sharing the
// element strides sb, st, sh with a contiguous last dim; w (B, T, H, hd)
// of dtype w_dtype with strides wsb, wst, wsh; u (H, hd) fp32; s_in and
// s_out (B, H, hd, hd) fp32 contiguous, possibly the same buffer; y
// (B, T, H, hd) fp32 contiguous.  hd is 16, 32 or 64; T >= 1.
// Returns cudaGetLastError().
extern "C" int repro_wkv6(const void* r, const void* k, const void* v, int rkv_dtype,
                          int64_t sb, int64_t st, int64_t sh, const void* w, int w_dtype,
                          int64_t wsb, int64_t wst, int64_t wsh, const float* u,
                          const float* s_in, float* s_out, float* y, int B, int T, int H,
                          int hd, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || T < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const int re = rkv_dtype == 0 ? 4 : 2, we = w_dtype == 0 ? 4 : 2;
  const bool vec = aligned16(r, sb, st, sh, re) && aligned16(k, sb, st, sh, re) &&
                   aligned16(v, sb, st, sh, re) && aligned16(w, wsb, wst, wsh, we) &&
                   aligned16(s_in, 0, 0, 0, 4) && aligned16(s_out, 0, 0, 0, 4);
  const Args a{r, k, v, sb, st, sh, w, wsb, wst, wsh, u, s_in, s_out, y, T, H, B * H, vec};
  const cudaError_t err = by_dtype(a, rkv_dtype, w_dtype, hd, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Blocks of the kernel for (rkv_dtype, w_dtype, hd), one a (batch, head)
// pair, that one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *blocks.
extern "C" int repro_wkv6_blocks_per_sm(int rkv_dtype, int w_dtype, int hd, int* blocks) {
  return (int)by_dtype(Args{}, rkv_dtype, w_dtype, hd, nullptr, blocks);
}
