// GQA flash decode for Hopper (sm_90a): one new query token per sequence
// against a KV cache that lies in HBM or in page-locked host memory.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention/kernel.py
// (`decode_attention`, body `_kernel`), which walks KV blocks of `block_t`
// in order on one core, keeps the online-softmax state (m, l, acc) in VMEM
// and skips blocks past `lengths[b]`.  Two entry points share each body:
//
// * partial form (`repro_decode_attention_partial`): a validity mask
//   (B, T) in, the unnormalised (acc, m, l) out — the per-partition piece
//   the tiered KV cache merges across its device pools
//   (repro/models/attention.py `attend_partial`);
// * normalised form (`repro_decode_attention`): lengths (B,) in,
//   acc / max(l, 1e-30) out — the TPU kernel's own function.
//
// What bounds it: bytes.  Each K/V row is read once and serves the G = H/K
// query heads of its KV head: 2·G flops per element, 12 per byte for bf16
// at G = 12, far below the tensor cores' ~295 per byte.  From HBM the
// bound is 3.35 TB/s; from pinned host memory, read in place through
// unified virtual addressing, it is the PCIe link.  The design keeps the
// shared-memory pipe and the barriers out of the way of that stream.
//
// bf16 K/V (every serving pool) — `decode_mma_kernel`:
// * One block of four warps per (sequence, KV head, split).  The split
//   is taken over the tiles of 64 positions that hold a valid position:
//   the block reads its row of the mask (T bytes, from L2) into one bit
//   per tile, counts those tiles and takes its contiguous share of them,
//   in order (normalised form: of the tiles below lengths[b]).  No block
//   idles on a masked stretch of T, and a tile with no valid position is
//   never read.  The block's threads fill a table of (tile, 64-bit
//   validity word) entries of the share together, 32 at a time, from
//   those bits and the mask: two windows in the prologue (the second
//   behind the ring's first copies), then after each window of 32 tiles
//   its half takes the window after next.  The table's
//   size does not grow with T; only the tile bits do (4 bytes per 2048
//   positions).
// * A ring of three 64-position K/V stages in shared memory, filled by
//   16-byte `cp.async` (coalesced rows, each row padded by 16 bytes so
//   the `ldmatrix` row addresses of a phase fall in distinct banks); one
//   barrier per stage.  A masked position (or one past T) issues its
//   copy with source size 0: the row is zero-filled and nothing is read,
//   so only a pool's own valid rows cross PCIe.  HBM rows bypass L1
//   (.cg); pinned host rows go through it (.ca), which PCIe serves far
//   faster.
// * Both products run on the tensor cores as `mma.sync` m16n8k16 bf16
//   with fp32 accumulation.  The G <= 16 query heads of the KV head are
//   the 16 rows of the A tile (rows past G are zero).  `wgmma` needs 64
//   rows and the problem has 16, so the warp-level `mma.sync` is the
//   right instruction here; the tensor cores idle at this byte-bound
//   shape either way.  Q·Kᵀ reads K with `ldmatrix`, P·V reads V with
//   `ldmatrix.trans`; the score accumulator becomes P in registers (as
//   in FlashAttention-2) and the online softmax runs on the fragments,
//   with quad shuffles for the row maxima, in base 2 (the 1/sqrt(hd)
//   scale folded into log2(e)).
// * fp32 accuracy: an fp32 q is split into a bf16 high half and a bf16
//   low half (q - hi), and Q·Kᵀ issues one MMA for each; P (fp32) is
//   split the same way for P·V.  hi + lo carries 16 bits of mantissa.
//   A bf16 q is taken as it is (no low half, no cast launch).
// * Each warp owns 16 positions of every stage (hd <= 160) and the
//   whole output row of its heads: at most 80 fp32 accumulators a
//   thread.  At hd 256 that would be 128, so two warps share each 32
//   positions: both compute the (cheap) scores, each keeps half of the
//   output columns.  The warps' (m, l, acc) are merged in a fixed order
//   at the end through the ring's shared memory.
// * The splits of one (sequence, KV head) form a thread-block cluster
//   (at most 8, the portable size) and merge their (acc, m, l) through
//   distributed shared memory, in rank order, straight into the outputs:
//   one launch per call, no scratch.
// * The prologue overlaps its global round trips (Q, the mask scan) and
//   puts the ring's first stages in flight before converting Q.
//
// fp32 K/V — `decode_f32_kernel`, the CUDA-core body: bf16 or tf32
// operands could not hold its 1e-5 tolerance, and no serving pool is
// fp32.  One block of 256 threads per (sequence, KV head, split of T);
// tiles of 32 positions loaded into registers while the previous tile
// computes, staged in padded shared memory, one (head, position) score
// per thread, one warp per head for the softmax, four columns per thread
// for P·V.
//
// Both: a sequence with no valid position returns m = -1e30, l = 0,
// acc = 0 (the plain version returns l = T and the sum of V there; both
// merge with weight exp(-1e30 - m_all) = 0).  Scores are the dot product
// divided by sqrt(hd), masked with the finite NEG_INF = -1e30; every
// reduction runs in a fixed order, so results do not change from run to
// run.  The fp32 body writes its splits to scratch and a second small
// kernel merges them with the same algebra (and normalises, in the
// normalised form).
//
// The same source holds the append scatter of the decode step: one new
// K and V row per sequence, written at a per-sequence row of a pool layer
// (HBM or pinned) with the cast to the pool's dtype fused in; rows out of
// range are dropped.  It replaces the `.at[...].set(mode="drop")` scatter
// of repro/serving/kv_cache.py `append_layer` without a host sync.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int MAX_G = 16;        // query heads per KV head
constexpr int SMEM_MAX = 232448; // bytes of shared memory a block may use

struct Args {
  const void* q;             // (B, H, hd) contiguous, fp32 or bf16
  int q_dtype;               // 0 fp32, 1 bf16
  const void* k;             // (B, T, K, hd), last dim contiguous
  const void* v;             // same shape and strides as k
  int kv_host;               // k and v lie in pinned host memory
  int64_t sb, st, sk;        // element strides of k and v
  const uint8_t* valid;      // (B, T) mask (partial form) or null
  int64_t valid_sb;
  const int32_t* lengths;    // (B,) (normalised form) or null
  int B, T, K, G, splits;
  float* acc;                // scratch (B, K, splits, G, hd) of the fp32 body
  float* m;                  // (B, K, splits, G)
  float* l;                  // (B, K, splits, G)
  float* acc_out;            // partial form: (B, H, hd), (B, H), (B, H)
  float* m_out;
  float* l_out;
  float* out;                // normalised form: (B, H, hd)
};

__device__ __forceinline__ float load_q(const Args& a, int64_t i) {
  return a.q_dtype == 0 ? static_cast<const float*>(a.q)[i]
                        : __bfloat162float(static_cast<const __nv_bfloat16*>(a.q)[i]);
}

// ---------------------------------------------------------------------------
// bf16 K/V: tensor cores, cp.async ring, splits over valid tiles

constexpr int TP = 64;          // positions per tile and per ring stage
constexpr int NS = 3;           // ring stages
constexpr int MW = 4;           // warps per block
constexpr int MTHREADS = MW * 32;
constexpr int MAX_SPLITS = 8;   // blocks per (sequence, KV head): one portable cluster
constexpr int WE = MTHREADS / 4;  // share entries a table fill takes (four threads each)

// Hooks for tools/decode_attention_probe.py, left at these defaults in the
// port's build: DA_P_LO 0 drops P's low half (an accuracy control), and
// DA_MARK(k) marks the start of phase k of the bf16 body.
#ifndef DA_P_LO
#define DA_P_LO 1
#endif
#ifndef DA_MARK
#define DA_MARK(k)
#endif

template <int HD>
struct Tile {
  static constexpr int WC = HD > 160 ? 2 : 1;  // warps that share positions, each a column slice
  static constexpr int WT = MW / WC;           // position groups of a stage
  static constexpr int PW = TP / WT;           // positions per warp per stage
  static constexpr int NT = PW / 8;            // n-tiles of the scores
  static constexpr int KQ = HD / 16;           // k-steps of Q·Kᵀ
  static constexpr int KP = PW / 16;           // k-steps of P·V
  static constexpr int CW = HD / WC;           // output columns per warp
  static constexpr int NO = CW / 8;            // n-tiles of the output
  static constexpr int PITCH = HD * 2 + 16;    // bytes per shared row (padded)
  static constexpr int CR = HD / 8;            // 16-byte chunks per row
  static constexpr int STAGE = 2 * TP * PITCH; // K rows then V rows
  static constexpr int QBYTES = 16 * PITCH;    // one bf16 half of Q
  static constexpr int MP = HD + 4;            // floats per row of the merge area
  static_assert(NT % 2 == 0 && NO % 2 == 0 && KP >= 1, "tile shape");
  static_assert((WT * 16 * (MP + 2) + (2 * MAX_SPLITS + 4) * 16 + 16 * HD + MAX_SPLITS) * 4 <=
                    NS * STAGE,
                "merge area fits the ring");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with ok false the row is zero-filled and
// nothing is read (source size 0).  From HBM the copy bypasses L1 (.cg);
// from pinned host memory it goes through L1 (.ca), which read PCIe at
// three times the rate of .cg on an H100 (PERF.md).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok, bool host) {
  if (host)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// c (16x8 fp32) += a (16x16 bf16, row) · b (16x8 bf16, col)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits_of(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x, y) as packed bf16 high halves and low halves (x - hi, y - hi).
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bits_of(h);
  lo = bits_of(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Positions t0 .. t0 + 15 as 16 bits: t < t_end, and the mask's byte where
// there is a mask (one 16-byte load when the row is aligned and whole).
__device__ __forceinline__ uint32_t seg_bits(const uint8_t* vm, int t0, int t_end,
                                             bool aligned) {
  uint32_t bits = 0;
  if (vm != nullptr && aligned && t0 + 16 <= t_end) {
    const uint4 x = *reinterpret_cast<const uint4*>(vm + t0);
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)  // nonzero bytes -> 0x01, gathered into 4 bits
      bits |= (((__vcmpne4(w[i], 0u) & 0x01010101u) * 0x01020408u) >> 24) << (4 * i);
    return bits;
  }
  for (int i = 0; i < 16; ++i) {
    const int t = t0 + i;
    if (t < t_end && (vm == nullptr || vm[t] != 0)) bits |= 1u << i;
  }
  return bits;
}

// The tile of rank r among the set bits of tbits at or after tile t
// (tiles if there is none).
__device__ __forceinline__ int nth_set(const uint32_t* tbits, int t, int r, int tiles) {
  for (int w = t / 32; w * 32 < tiles; ++w) {
    uint32_t x = tbits[w];
    if (w == t / 32) x &= ~0u << (t % 32);
    const int c = __popc(x);
    if (r < c) {  // select bit r of x by halves
      int pos = 0;
#pragma unroll
      for (int h = 16; h > 0; h >>= 1) {
        const int lo = __popc(x & ((1u << h) - 1u));
        if (r >= lo) { r -= lo; x >>= h; pos += h; }
      }
      return w * 32 + pos;
    }
    r -= c;
  }
  return tiles;
}

// Shared memory, not registers, caps the blocks per SM.  Without a
// minimum ptxas trades a few spilled bytes for a register-count occupancy
// step the kernel can never use (hd 160 and 64, and hd 256 with a bf16
// q); with one, at hd 256 with an fp32 q it schedules for ILP and spills
// more.  So that one instantiation leaves the minimum unset (0) and the
// others ask for one block per SM.
template <int HD, bool LO>
__global__ void __launch_bounds__(MTHREADS, HD > 160 && LO ? 0 : 1)
decode_mma_kernel(Args a) {
  using S = Tile<HD>;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* ring = smem;
  uint8_t* qhi = ring + NS * S::STAGE;
  uint8_t* qlo = qhi + S::QBYTES;  // only with LO
  // entry j of the share: its validity word and tile, in slot j % (2 WE)
  uint64_t* smask = reinterpret_cast<uint64_t*>(qhi + (LO ? 2 : 1) * S::QBYTES);
  int* stile = reinterpret_cast<int*>(smask + 2 * WE);
  uint32_t* tbits = reinterpret_cast<uint32_t*>(stile + 2 * WE);  // a bit per tile: any valid
  const int tiles = (a.T + TP - 1) / TP;
  const int words = (tiles + 31) / 32;

  const int bk = blockIdx.x;
  const int b = bk / a.K, kh = bk % a.K;
  const int split = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = a.G;
  DA_MARK(0);

  // The prologue keeps its global round trips few and overlapped: Q's
  // loads and the mask scan's go out together, and the ring's first
  // stages are in flight before Q is converted.

  // Q's G rows (zero-padded to 16) as raw 16-byte chunks; LO is set
  // exactly when q is fp32
  constexpr int EPC = LO ? 4 : 8;  // q elements per 16 bytes
  constexpr int QCH = 16 * HD / EPC;
  constexpr int QPT = (QCH + MTHREADS - 1) / MTHREADS;
  uint4 qraw[QPT];
  {
    const uint8_t* qb = static_cast<const uint8_t*>(a.q) +
                        ((int64_t)b * a.K + kh) * G * HD * (LO ? 4 : 2);
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      const int c = tid + j * MTHREADS;
      qraw[j] = make_uint4(0u, 0u, 0u, 0u);
      if (c < QCH && c * EPC / HD < G) qraw[j] = *reinterpret_cast<const uint4*>(qb + c * 16);
    }
  }

  // this block's share of the tiles that hold a valid position
  DA_MARK(1);
  const uint8_t* vm = a.valid != nullptr ? a.valid + b * a.valid_sb : nullptr;
  const bool aligned = (reinterpret_cast<uintptr_t>(vm) & 15) == 0;
  int t_end = a.T;
  if (a.lengths != nullptr) t_end = min(t_end, max(a.lengths[b], 0));
  int n, first = 0, s0 = 0;
  if (vm == nullptr) {
    const int nt = (t_end + TP - 1) / TP;
    first = (int)((int64_t)split * nt / a.splits);
    n = (int)((int64_t)(split + 1) * nt / a.splits) - first;
  } else {
    for (int w = tid; w < words; w += MTHREADS) tbits[w] = 0;
    __syncthreads();
    constexpr int U = 4;  // 16-position segments a thread scans per round, loads first
    for (int sg0 = tid; sg0 * 16 < a.T; sg0 += U * MTHREADS) {
      uint32_t any[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int sg = sg0 + u * MTHREADS;
        any[u] = sg * 16 < a.T ? seg_bits(vm, sg * 16, a.T, aligned) : 0u;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int sg = sg0 + u * MTHREADS;
        if (any[u] != 0) atomicOr(&tbits[sg / 128], 1u << ((sg / 4) % 32));
      }
    }
    __syncthreads();
    int nv = 0;
    for (int w = 0; w < words; ++w) nv += __popc(tbits[w]);
    s0 = (int)((int64_t)split * nv / a.splits);
    n = (int)((int64_t)(split + 1) * nv / a.splits) - s0;
  }
  // Entries j0 .. j0 + WE - 1 of the share (those below n) into the table:
  // four threads an entry, 16 positions each, gathered by shuffles.  Their
  // tiles are those of rank r0, r0 + 1, .. among the set bits from tile
  // `from` on.
  auto fill = [&](int j0, int from, int r0) {
    const int j = j0 + tid / 4;
    const bool mine = j < n;
    int tile = 0;
    if (mine) tile = vm == nullptr ? first + j : nth_set(tbits, from, r0 + tid / 4, tiles);
    const uint32_t bits = mine ? seg_bits(vm, tile * TP + (tid % 4) * 16, t_end, aligned) : 0u;
    const uint32_t b1 = __shfl_down_sync(0xffffffffu, bits, 1);
    const uint32_t b2 = __shfl_down_sync(0xffffffffu, bits, 2);
    const uint32_t b3 = __shfl_down_sync(0xffffffffu, bits, 3);
    if (mine && tid % 4 == 0) {
      smask[j % (2 * WE)] = (uint64_t)(bits | (b1 << 16)) | ((uint64_t)(b2 | (b3 << 16)) << 32);
      stile[j % (2 * WE)] = tile;
    }
  };
  fill(0, 0, s0);
  __syncthreads();  // the first window is in place

  const uint8_t* kb = static_cast<const uint8_t*>(a.k) + (b * a.sb + kh * a.sk) * 2;
  const uint8_t* vb = static_cast<const uint8_t*>(a.v) + (b * a.sb + kh * a.sk) * 2;
  const int64_t row_stride = a.st * 2;
  // each thread copies one 16-byte column chunk of every RPP-th row
  constexpr int RPP = MTHREADS / S::CR;  // rows per pass
  const int ch = tid % S::CR, p0 = tid / S::CR;
  const bool copier = p0 < RPP;  // hd 160: 120 of 128 threads copy
  const bool host = a.kv_host != 0;
  auto issue = [&](int i, int slot) {
    const uint64_t ok = smask[i % (2 * WE)];
    const int64_t g0 = (int64_t)(stile[i % (2 * WE)] * TP + p0) * row_stride + ch * 16;
    uint32_t so = smem_u32(ring + slot * S::STAGE + p0 * S::PITCH + ch * 16);
    if (!copier) return;
#pragma unroll
    for (int p = p0, j = 0; j < (TP + RPP - 1) / RPP; ++j, p += RPP, so += RPP * S::PITCH) {
      if (p >= TP) break;
      const bool on = (ok >> p) & 1;
      const int64_t off = on ? g0 + (int64_t)(p - p0) * row_stride : 0;
      cp_async16(so, kb + off, on, host);
      cp_async16(so + TP * S::PITCH, vb + off, on, host);
    }
  };
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < n) issue(i, i);
    cp_commit();
  }

  // Q into shared memory as bf16 (hi, and lo = q - hi for fp32 q); the
  // first barrier of the loop publishes it
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int c = tid + j * MTHREADS;
    if (c >= QCH) break;
    const int at = (c * EPC / HD) * S::PITCH + (c * EPC % HD) * 2;
    if (LO) {
      uint32_t h0, h1, l0, l1;
      split2(__uint_as_float(qraw[j].x), __uint_as_float(qraw[j].y), h0, l0);
      split2(__uint_as_float(qraw[j].z), __uint_as_float(qraw[j].w), h1, l1);
      *reinterpret_cast<uint2*>(qhi + at) = make_uint2(h0, h1);
      *reinterpret_cast<uint2*>(qlo + at) = make_uint2(l0, l1);
    } else {
      *reinterpret_cast<uint4*>(qhi + at) = qraw[j];
    }
  }

  // the second window, read from the loop's first barrier on
  if (n > WE) fill(WE, 0, s0 + WE);

  const int wt = warp / S::WC, wc = warp % S::WC;
  const int g = lane >> 2, tg = lane & 3;
  const int pw0 = wt * S::PW;  // this warp's first position in a stage
  // scores are kept as z = dot · log2(e) / sqrt(hd), so p = 2^(z - m)
  const float zscale = LOG2E / sqrtf((float)HD);
  float acc[S::NO][4];
#pragma unroll
  for (int o = 0; o < S::NO; ++o)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[o][e] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;  // rows g, g + 8 (z units)

  // ldmatrix row/column of this lane: A (Q) and K take matrices in the
  // order (rows 0-7 | 8-15) x (cols 0-7 | 8-15) as the fragments want them
  const int qr = (lane & 7) + ((lane >> 3) & 1) * 8, qc = (lane >> 4) * 8;
  const int kr = (lane & 7) + (lane >> 4) * 8, kc = ((lane >> 3) & 1) * 8;
  const int vr = (lane & 7) + ((lane >> 3) & 1) * 8, vc = (lane >> 4) * 8;

  DA_MARK(2);
  for (int i0 = 0; i0 < n; i0 += WE) {  // windows of WE entries
    for (int i = i0; i < min(n, i0 + WE); ++i) {
      cp_wait<NS - 2>();
      __syncthreads();  // stage i landed for all; stage i - 1 is free
      if (i + NS - 1 < n) issue(i + NS - 1, (i + NS - 1) % NS);
      cp_commit();
      const uint64_t ok = smask[i % (2 * WE)];
      const uint8_t* sk = ring + (i % NS) * S::STAGE;
      const uint8_t* sv = sk + TP * S::PITCH;

      // scores: (16 heads) x (PW positions) = Q · Kᵀ, in two accumulator
      // chains (q's low half, or the odd k-steps, in the second)
      float s[S::NT][4], s2[S::NT][4];
#pragma unroll
      for (int nt = 0; nt < S::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = s2[nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < S::KQ; ++ks) {
        uint32_t qa[4], ql[4];
        ldsm_x4(qa, smem_u32(qhi + qr * S::PITCH + (ks * 16 + qc) * 2));
        if (LO) ldsm_x4(ql, smem_u32(qlo + qr * S::PITCH + (ks * 16 + qc) * 2));
#pragma unroll
        for (int np = 0; np < S::NT / 2; ++np) {
          uint32_t kf[4];
          ldsm_x4(kf, smem_u32(sk + (pw0 + np * 16 + kr) * S::PITCH + (ks * 16 + kc) * 2));
          if (LO || ks % 2 == 0) {
            mma16816(s[2 * np], qa, kf[0], kf[1]);
            mma16816(s[2 * np + 1], qa, kf[2], kf[3]);
          } else {
            mma16816(s2[2 * np], qa, kf[0], kf[1]);
            mma16816(s2[2 * np + 1], qa, kf[2], kf[3]);
          }
          if (LO) {
            mma16816(s2[2 * np], ql, kf[0], kf[1]);
            mma16816(s2[2 * np + 1], ql, kf[2], kf[3]);
          }
        }
      }

      // online softmax on the fragments: thread holds rows g, g + 8
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int nt = 0; nt < S::NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = pw0 + nt * 8 + tg * 2 + (e & 1);
          s[nt][e] = ((ok >> p) & 1) ? (s[nt][e] + s2[nt][e]) * zscale : NEG_INF;
        }
        mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
        mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
      }
      const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
      const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      l0 *= al0;
      l1 *= al1;
      if (__any_sync(0xffffffffu, al0 != 1.f || al1 != 1.f)) {  // a row's max moved
#pragma unroll
        for (int o = 0; o < S::NO; ++o) {
          acc[o][0] *= al0; acc[o][1] *= al0;
          acc[o][2] *= al1; acc[o][3] *= al1;
        }
      }
#pragma unroll
      for (int nt = 0; nt < S::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = s[nt][e] == NEG_INF ? 0.f : exp2f(s[nt][e] - (e < 2 ? mn0 : mn1));
          s[nt][e] = p;
          if (e < 2) l0 += p; else l1 += p;
        }

      // acc += P · V, P as (hi, lo) bf16 A fragments straight from the scores
#pragma unroll
      for (int kk = 0; kk < S::KP; ++kk) {
        uint32_t ph[4], pl[4];
        split2(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
        split2(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
        split2(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
        split2(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int op = 0; op < S::NO / 2; ++op) {
          uint32_t vf[4];
          ldsm_x4_t(vf, smem_u32(sv + (pw0 + kk * 16 + vr) * S::PITCH +
                                 (wc * S::CW + op * 16 + vc) * 2));
          mma16816(acc[2 * op], ph, vf[0], vf[1]);
          if (DA_P_LO) mma16816(acc[2 * op], pl, vf[0], vf[1]);
          mma16816(acc[2 * op + 1], ph, vf[2], vf[3]);
          if (DA_P_LO) mma16816(acc[2 * op + 1], pl, vf[2], vf[3]);
        }
      }
    }
    // the window is done: its half of the table takes the window after
    // next, whose first tile the ring issues a window from now
    if (i0 + 2 * WE < n) {
      __syncthreads();
      fill(i0 + 2 * WE, stile[(i0 + 2 * WE - 1) % (2 * WE)] + 1, 0);
    }
  }
  cp_wait<0>();
  __syncthreads();  // the ring is free: it becomes the merge area
  DA_MARK(3);

  // Merge.  The position groups of every split of this (sequence, KV
  // head) hold (m, l, acc) for the 16 rows; the splits form one thread
  // block cluster.  Each block publishes its rows' (m, l), reads every
  // split's, and from the row maxima M weighs each group by 2^(m - M).
  // The output elements are dealt out to the blocks in rank order; each
  // block pushes its weighted share of every element into the owner's
  // shared memory, and the owner sums the splits in rank order.
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const int nsp = a.splits;
  const int chunk = (G * HD + nsp - 1) / nsp;    // output elements per owner
  float* macc = reinterpret_cast<float*>(ring);  // (WT, 16, MP) group acc
  float* mm = macc + S::WT * 16 * S::MP;         // (WT, 16) group m, then weight
  float* ml = mm + S::WT * 16;                   // (WT, 16) group l
  float* bm = ml + S::WT * 16;                   // (16) block m, l
  float* bl = bm + 16;
  float* cm = bl + 16;                           // (MAX_SPLITS, 16) splits' m, l
  float* cl = cm + MAX_SPLITS * 16;
  float* rl = cl + MAX_SPLITS * 16;              // (16) merged m, l
  float* rm = rl + 16;
  float* inbox = rm + 16;                        // (nsp, chunk) pushed shares
#pragma unroll
  for (int o = 0; o < S::NO; ++o) {
    const int col = wc * S::CW + o * 8 + tg * 2;
    *reinterpret_cast<float2*>(macc + (wt * 16 + g) * S::MP + col) =
        make_float2(acc[o][0], acc[o][1]);
    *reinterpret_cast<float2*>(macc + (wt * 16 + g + 8) * S::MP + col) =
        make_float2(acc[o][2], acc[o][3]);
  }
  if (wc == 0 && tg == 0) {
    mm[wt * 16 + g] = m0; mm[wt * 16 + g + 8] = m1;
    ml[wt * 16 + g] = l0; ml[wt * 16 + g + 8] = l1;
  }
  __syncthreads();
  if (tid < 16) {
    float mx = NEG_INF, y = 0.f;
#pragma unroll
    for (int w = 0; w < S::WT; ++w) mx = fmaxf(mx, mm[w * 16 + tid]);
#pragma unroll
    for (int w = 0; w < S::WT; ++w) y += ml[w * 16 + tid] * exp2f(mm[w * 16 + tid] - mx);
    bm[tid] = mx;
    bl[tid] = y;
  }
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  cluster.sync();  // every split's (m, l) is published
  if (tid < nsp * 16) {
    cm[tid] = cluster.map_shared_rank(bm, tid / 16)[tid % 16];
    cl[tid] = cluster.map_shared_rank(bl, tid / 16)[tid % 16];
  }
  __syncthreads();
  if (tid < 16) {  // row r: merged m and l, and this block's group weights
    float mx = NEG_INF, y = 0.f;
    for (int sp = 0; sp < nsp; ++sp) mx = fmaxf(mx, cm[sp * 16 + tid]);
    for (int sp = 0; sp < nsp; ++sp) y += cl[sp * 16 + tid] * exp2f(cm[sp * 16 + tid] - mx);
    rm[tid] = mx;
    rl[tid] = y;
#pragma unroll
    for (int w = 0; w < S::WT; ++w) mm[w * 16 + tid] = exp2f(mm[w * 16 + tid] - mx);
  }
  __syncthreads();
  for (int i = tid; i < G * HD; i += MTHREADS) {  // push this split's shares
    const int r = i / HD, d = i % HD;
    float x = 0.f;
#pragma unroll
    for (int w = 0; w < S::WT; ++w) x += macc[(w * 16 + r) * S::MP + d] * mm[w * 16 + r];
    const int owner = i / chunk;
    cluster.map_shared_rank(inbox, owner)[rank * chunk + (i - owner * chunk)] = x;
  }
  cluster.sync();  // every share has landed; no block reads another after this
  const int64_t o0 = (int64_t)bk * G;
  for (int j = tid; j < chunk; j += MTHREADS) {
    const int i = rank * chunk + j;
    if (i >= G * HD) break;
    const int r = i / HD, d = i % HD;
    float x = 0.f;
    for (int sp = 0; sp < nsp; ++sp) x += inbox[sp * chunk + j];
    if (a.out != nullptr) {
      a.out[(o0 + r) * HD + d] = x / fmaxf(rl[r], 1e-30f);
    } else {
      a.acc_out[(o0 + r) * HD + d] = x;
      if (d == 0) {  // m back from z units to scores
        a.m_out[o0 + r] = rm[r] == NEG_INF ? NEG_INF : rm[r] / LOG2E;
        a.l_out[o0 + r] = rl[r];
      }
    }
  }
  DA_MARK(4);
}

// ---------------------------------------------------------------------------
// fp32 K/V: the CUDA-core body

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int TPF = 32;  // positions per tile: one per lane in the softmax

template <int HD>
struct F32Tile {
  static constexpr int ROW = HD * 4;       // bytes of one K or V row
  static constexpr int CH = ROW / 16;      // 16-byte chunks per row
  static constexpr int PITCH = ROW + 16;   // padded: conflict-free row reads
  static constexpr int KV_BYTES = 2 * TPF * PITCH;
};

template <int HD>
__global__ void __launch_bounds__(THREADS)
decode_f32_kernel(Args a) {
  using F = F32Tile<HD>;
  constexpr int CH = F::CH, PITCH = F::PITCH;
  constexpr int NCH = (TPF * CH + THREADS - 1) / THREADS;
  constexpr int QD = HD / 4;                 // quads of one row
  constexpr int NG = THREADS / QD;           // head groups of the P·V pass
  constexpr int JH = (MAX_G + NG - 1) / NG;  // heads per thread in that pass
  // QD need not divide THREADS (hd 160: 6 groups of 40 threads); the
  // threads past the last whole group take no part in P·V

  extern __shared__ __align__(16) uint8_t dsm[];  // K, V tiles, then q (G * HD)
  uint8_t* sk = dsm;
  uint8_t* sv = dsm + TPF * PITCH;
  float* sq = reinterpret_cast<float*>(dsm + F::KV_BYTES);
  __shared__ float sp[MAX_G * TPF];
  __shared__ float sm[MAX_G], sl[MAX_G], salpha[MAX_G];

  const int bk = blockIdx.x;
  const int b = bk / a.K, kh = bk % a.K;
  const int split = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int G = a.G;

  int t_end = a.T;
  if (a.lengths != nullptr) t_end = min(t_end, max(a.lengths[b], 0));
  const int chunk = (t_end + a.splits - 1) / a.splits;
  const int t0 = split * chunk;
  const int t1 = min(t_end, t0 + chunk);

  for (int i = tid; i < G * HD; i += THREADS)
    sq[i] = load_q(a, ((int64_t)b * a.K * G + kh * G) * HD + i);
  if (tid < G) { sm[tid] = NEG_INF; sl[tid] = 0.f; }
  const uint8_t* kb = reinterpret_cast<const uint8_t*>(
      static_cast<const float*>(a.k) + b * a.sb + kh * a.sk);
  const uint8_t* vb = reinterpret_cast<const uint8_t*>(
      static_cast<const float*>(a.v) + b * a.sb + kh * a.sk);
  const int64_t row_stride = a.st * 4;
  const uint8_t* vm = a.valid != nullptr ? a.valid + b * a.valid_sb : nullptr;
  const float sqrt_hd = sqrtf((float)HD);
  const int dq = tid % QD, hg = tid / QD;
  const bool pv = hg < NG;

  float acc[JH][4];
#pragma unroll
  for (int j = 0; j < JH; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  // The next tile's K/V chunks wait in registers while this one computes.
  uint4 rk[NCH], rv[NCH];
  bool rok[NCH];
  auto fetch = [&](int base) {
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int i = tid + j * THREADS;
      rok[j] = false;
      if (i < TPF * CH) {
        const int t = base + i / CH, c = i % CH;
        rok[j] = t < t1 && (vm == nullptr || vm[t]);
        if (rok[j]) {  // a masked position issues no load
          rk[j] = *reinterpret_cast<const uint4*>(kb + t * row_stride + c * 16);
          rv[j] = *reinterpret_cast<const uint4*>(vb + t * row_stride + c * 16);
        }
      }
    }
  };

  if (t0 < t1) fetch(t0);
  for (int base = t0; base < t1; base += TPF) {
    __syncthreads();  // the previous tile is done with shared memory
    bool mine = false;
    const uint4 zero = make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int i = tid + j * THREADS;
      if (i < TPF * CH) {
        const int p = i / CH, c = i % CH;
        *reinterpret_cast<uint4*>(sk + p * PITCH + c * 16) = rok[j] ? rk[j] : zero;
        *reinterpret_cast<uint4*>(sv + p * PITCH + c * 16) = rok[j] ? rv[j] : zero;
        mine |= rok[j];
      }
    }
    const bool any = __syncthreads_or(mine);
    if (base + TPF < t1) fetch(base + TPF);
    if (!any) continue;  // a tile with no valid position costs no math

    // scores: one (head, position) pair per thread and step
    for (int i = tid; i < G * TPF; i += THREADS) {
      const int g = i / TPF, p = i % TPF, t = base + p;
      float s = NEG_INF;
      if (t < t1 && (vm == nullptr || vm[t])) {
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const float4 kf = *reinterpret_cast<const float4*>(sk + p * PITCH + c * 16);
          const float* qg = sq + g * HD + c * 4;
          dot = fmaf(qg[0], kf.x, dot);
          dot = fmaf(qg[1], kf.y, dot);
          dot = fmaf(qg[2], kf.z, dot);
          dot = fmaf(qg[3], kf.w, dot);
        }
        s = dot / sqrt_hd;
      }
      sp[g * TPF + p] = s;
    }
    __syncthreads();

    // online softmax over the tile: one warp per head, one lane per position
    for (int g = warp; g < G; g += NWARPS) {
      const float s = sp[g * TPF + lane];
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = sm[g];
      const float m_new = fmaxf(m_old, mx);
      const float pv = s == NEG_INF ? 0.f : expf(s - m_new);
      float sum = pv;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      sp[g * TPF + lane] = pv;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        salpha[g] = alpha;
        sl[g] = sl[g] * alpha + sum;
        sm[g] = m_new;
      }
    }
    __syncthreads();

    // P·V: each thread owns four columns of up to JH heads
#pragma unroll
    for (int j = 0; j < JH; ++j) {
      const int g = hg + j * NG;
      if (pv && g < G) {
        const float alpha = salpha[g];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] *= alpha;
#pragma unroll 4
        for (int p = 0; p < TPF; ++p) {
          const float w = sp[g * TPF + p];
          const float4 vf = *reinterpret_cast<const float4*>(sv + p * PITCH + dq * 16);
          acc[j][0] = fmaf(w, vf.x, acc[j][0]);
          acc[j][1] = fmaf(w, vf.y, acc[j][1]);
          acc[j][2] = fmaf(w, vf.z, acc[j][2]);
          acc[j][3] = fmaf(w, vf.w, acc[j][3]);
        }
      }
    }
  }
  __syncthreads();

  const int64_t out = ((int64_t)bk * a.splits + split) * G;
#pragma unroll
  for (int j = 0; j < JH; ++j) {
    const int g = hg + j * NG;
    if (pv && g < G) {
      float* dst = a.acc + (out + g) * HD + dq * 4;
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[e] = acc[j][e];
    }
  }
  if (tid < G) {
    a.m[out + tid] = sm[tid];
    a.l[out + tid] = sl[tid];
  }
}

// Scratch is (B·K, splits, G, hd); outputs are (B·K, G, hd), i.e. (B, H, hd).
__global__ void combine_kernel(const float* __restrict__ acc, const float* __restrict__ m,
                               const float* __restrict__ l, int64_t bk_count, int splits,
                               int G, int hd, float* acc_out, float* m_out, float* l_out,
                               float* out) {
  const int64_t n = bk_count * G * hd;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t bk = i / ((int64_t)G * hd);
    const int g = (int)((i / hd) % G);
    const int d = (int)(i % hd);
    float mm = NEG_INF;
    for (int s = 0; s < splits; ++s) mm = fmaxf(mm, m[(bk * splits + s) * G + g]);
    float ll = 0.f, aa = 0.f;
    for (int s = 0; s < splits; ++s) {
      const int64_t h = (bk * splits + s) * G + g;
      const float w = expf(m[h] - mm);
      ll = ll + l[h] * w;
      aa = aa + acc[h * hd + d] * w;
    }
    if (out != nullptr) {
      out[i] = aa / fmaxf(ll, 1e-30f);
    } else {
      acc_out[i] = aa;
      if (d == 0) { m_out[bk * G + g] = mm; l_out[bk * G + g] = ll; }
    }
  }
}

unsigned grid_for(int64_t work) {
  int64_t blocks = (work + THREADS - 1) / THREADS;
  if (blocks > 132 * 8) blocks = 132 * 8;
  return (unsigned)(blocks < 1 ? 1 : blocks);
}

template <typename Kern>
cudaError_t allow_smem(Kern* kern, int bytes) {
  if (bytes > SMEM_MAX) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int HD>
cudaError_t launch_f32(const Args& a, cudaStream_t s) {
  const int dyn = F32Tile<HD>::KV_BYTES + a.G * HD * (int)sizeof(float);
  const cudaError_t err = allow_smem(decode_f32_kernel<HD>, dyn);
  if (err != cudaSuccess) return err;
  decode_f32_kernel<HD><<<dim3((unsigned)(a.B * a.K), (unsigned)a.splits), THREADS, dyn, s>>>(a);
  return cudaSuccess;
}

template <int HD, bool LO>
cudaError_t launch_mma(const Args& a, cudaStream_t s) {
  using S = Tile<HD>;
  if (a.splits > MAX_SPLITS) return cudaErrorInvalidValue;
  const int64_t tiles = ((int64_t)a.T + TP - 1) / TP;
  const int64_t dyn =
      NS * S::STAGE + (LO ? 2 : 1) * S::QBYTES + 2 * WE * 12 + 4 * ((tiles + 31) / 32);
  // refused when the tile bits (4 bytes per 2048 positions) do not fit
  // beside the ring: past 6.1 M positions at hd 256 with an fp32 q
  const cudaError_t err = allow_smem(decode_mma_kernel<HD, LO>, (int)dyn);
  if (err != cudaSuccess) return err;
  // the splits of one (sequence, KV head) form a cluster
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(a.B * a.K), (unsigned)a.splits);
  cfg.blockDim = dim3(MTHREADS);
  cfg.dynamicSmemBytes = (size_t)dyn;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = (unsigned)a.splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, decode_mma_kernel<HD, LO>, a);
}

template <int HD>
cudaError_t launch_hd(const Args& a, int kv_dtype, cudaStream_t s) {
  if (kv_dtype == 0) return launch_f32<HD>(a, s);
  if (kv_dtype != 1) return cudaErrorInvalidValue;
  return a.q_dtype == 0 ? launch_mma<HD, true>(a, s) : launch_mma<HD, false>(a, s);
}

int run(const Args& a, int hd, int kv_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.B > 0 && a.K > 0) {
    if (a.G < 1 || a.G > MAX_G || a.splits < 1 || (a.q_dtype != 0 && a.q_dtype != 1))
      return (int)cudaErrorInvalidValue;
    cudaError_t err;
    switch (hd) {
      case 16: err = launch_hd<16>(a, kv_dtype, s); break;
      case 32: err = launch_hd<32>(a, kv_dtype, s); break;
      case 64: err = launch_hd<64>(a, kv_dtype, s); break;
      case 128: err = launch_hd<128>(a, kv_dtype, s); break;
      case 160: err = launch_hd<160>(a, kv_dtype, s); break;
      case 256: err = launch_hd<256>(a, kv_dtype, s); break;
      default: err = cudaErrorInvalidValue;
    }
    if (err != cudaSuccess) return (int)err;
    if (kv_dtype == 0 && (a.out != nullptr || a.splits > 1)) {  // the fp32 body's merge
      const int64_t bk = (int64_t)a.B * a.K;
      combine_kernel<<<grid_for(bk * a.G * hd), THREADS, 0, s>>>(
          a.acc, a.m, a.l, bk, a.splits, a.G, hd, a.acc_out, a.m_out, a.l_out, a.out);
    }
  }
  return (int)cudaGetLastError();
}

template <typename Ti, typename To>
__device__ __forceinline__ To cvt(Ti x);
template <> __device__ __forceinline__ float cvt<float, float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 cvt<float, __nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ float cvt<__nv_bfloat16, float>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ __nv_bfloat16 cvt<__nv_bfloat16, __nv_bfloat16>(
    __nv_bfloat16 x) {
  return x;
}


template <typename Ti, typename To>
__global__ void append_kernel(const Ti* __restrict__ k_src, const Ti* __restrict__ v_src,
                              To* k_dst, To* v_dst, const int64_t* __restrict__ rows,
                              int T, int64_t row_elems, int64_t sb, int64_t st) {
  const int b = blockIdx.x;
  const int64_t r = rows[b];
  if (r < 0 || r >= T) return;  // owned by another pool: dropped
  const Ti* ks = k_src + b * row_elems;
  const Ti* vs = v_src + b * row_elems;
  To* kd = k_dst + b * sb + r * st;
  To* vd = v_dst + b * sb + r * st;
  for (int64_t i = threadIdx.x; i < row_elems; i += blockDim.x) {
    kd[i] = cvt<Ti, To>(ks[i]);
    vd[i] = cvt<Ti, To>(vs[i]);
  }
}

}  // namespace

// Partial form.  q (B, H, hd) contiguous, fp32 or bf16 (q_dtype 0 / 1);
// k, v (B, T, K, hd) fp32 or bf16 (kv_dtype 0 / 1), in HBM or (kv_host 1)
// in pinned host memory, with element strides
// sb, st, sk and a contiguous last dim, rows 16-byte aligned; valid (B, T)
// bytes with row stride valid_sb.  Outputs acc_out (B, H, hd), m_out and
// l_out (B, H).  fp32 K/V also take scratch acc (B, K, splits, G, hd), m
// and l (B, K, splits, G), which may be the outputs themselves when
// splits == 1 (then no merge runs); bf16 K/V take none (null is fine),
// at most 8 splits, and T at most 6.1 M (hd 256 with fp32 q; more below).
// hd is 16, 32, 64, 128, 160 or 256 and G = H / K at most 16.  Returns
// cudaGetLastError().
extern "C" int repro_decode_attention_partial(
    const void* q, int q_dtype, const void* k, const void* v, int kv_dtype, int kv_host,
    int64_t sb, int64_t st, int64_t sk, const uint8_t* valid, int64_t valid_sb, int B, int T, int K,
    int G, int hd, int splits, float* acc, float* m, float* l, float* acc_out, float* m_out,
    float* l_out, void* stream) {
  const Args a{q, q_dtype, k, v, kv_host, sb, st, sk, valid, valid_sb, nullptr, B, T, K, G, splits,
               acc, m, l, acc_out, m_out, l_out, nullptr};
  return run(a, hd, kv_dtype, stream);
}

// Normalised form: as above with lengths (B,) int32 in place of the mask;
// out (B, H, hd) fp32 gets acc / max(l, 1e-30) (0 where lengths[b] <= 0);
// the fp32 body always takes the scratch here.
extern "C" int repro_decode_attention(
    const void* q, int q_dtype, const void* k, const void* v, int kv_dtype, int kv_host,
    int64_t sb, int64_t st, int64_t sk, const int32_t* lengths, int B, int T, int K, int G, int hd,
    int splits, float* acc, float* m, float* l, float* out, void* stream) {
  const Args a{q, q_dtype, k, v, kv_host, sb, st, sk, nullptr, 0, lengths, B, T, K, G, splits,
               acc, m, l, nullptr, nullptr, nullptr, out};
  return run(a, hd, kv_dtype, stream);
}

// Append scatter: k_src, v_src (B, row_elems) contiguous, dtype src_dtype;
// row rows[b] of sequence b in k_dst, v_dst (dtype dst_dtype, element
// strides sb per sequence and st per row, rows contiguous) receives them;
// rows outside [0, T) are dropped.  Returns cudaGetLastError().
extern "C" int repro_kv_append(const void* k_src, const void* v_src, int src_dtype,
                               void* k_dst, void* v_dst, int dst_dtype,
                               const int64_t* rows, int B, int T, int64_t row_elems,
                               int64_t sb, int64_t st, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B > 0 && row_elems > 0) {
    const unsigned threads = row_elems >= 256 ? 256 : 64;
    if (src_dtype == 0 && dst_dtype == 0) {
      append_kernel<float, float><<<B, threads, 0, s>>>(
          static_cast<const float*>(k_src), static_cast<const float*>(v_src),
          static_cast<float*>(k_dst), static_cast<float*>(v_dst), rows, T, row_elems, sb, st);
    } else if (src_dtype == 0 && dst_dtype == 1) {
      append_kernel<float, __nv_bfloat16><<<B, threads, 0, s>>>(
          static_cast<const float*>(k_src), static_cast<const float*>(v_src),
          static_cast<__nv_bfloat16*>(k_dst), static_cast<__nv_bfloat16*>(v_dst), rows, T,
          row_elems, sb, st);
    } else if (src_dtype == 1 && dst_dtype == 0) {
      append_kernel<__nv_bfloat16, float><<<B, threads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(k_src), static_cast<const __nv_bfloat16*>(v_src),
          static_cast<float*>(k_dst), static_cast<float*>(v_dst), rows, T, row_elems, sb, st);
    } else if (src_dtype == 1 && dst_dtype == 1) {
      append_kernel<__nv_bfloat16, __nv_bfloat16><<<B, threads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(k_src), static_cast<const __nv_bfloat16*>(v_src),
          static_cast<__nv_bfloat16*>(k_dst), static_cast<__nv_bfloat16*>(v_dst), rows, T,
          row_elems, sb, st);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
