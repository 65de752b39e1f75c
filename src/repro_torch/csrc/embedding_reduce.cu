// Weighted embedding-bag reduction for Hopper (sm_90a):
//     out[b, :] = sum_k w[b, k] * table[idx[b, k], :]
// in two forms that share one kernel body:
//  * the table form (`repro_embedding_reduce`): one table, global rows;
//  * the routed form (`repro_bag_reduce_routed`): the page shards of an
//    InterleavedTensor (at most MAX_SHARDS: the fast tier and the paper's
//    three CXL devices), global indices routed through the page maps in
//    the kernel, so one launch reduces every shard.
//
// Replaces the Pallas TPU kernel repro/kernels/embedding_reduce/kernel.py
// (`embedding_reduce`, body `_kernel`), which scalar-prefetches the bag's
// row indices and DMAs one table row per grid step into VMEM; the routed
// form also replaces the per-shard loop of repro's
// InterleavedTensor.bag_reduce around it.
//
// What bounds it: bytes.  Each lookup reads one row (256 B for a 64-wide
// fp32 table) at a random address and does two flops per element, so the
// kernel is bound by random-row read bandwidth: HBM for the fast shard,
// PCIe for a pinned host shard, which the same kernel reads in place
// through unified virtual addressing.  A bag's K lookups cannot be split
// across threads (the sum is in k order), so one thread owns 16 bytes of
// columns of one bag for the whole bag, and the bytes in flight per SM
// have to come from depth within that thread.
//
// Design:
//  * The bag is staged first.  A block owns ER_THREADS / lanes bags (lanes
//    = threads per bag, 16 bytes each).  In a prologue its threads load the
//    block's indices and weights with coalesced loads, round each weight to
//    the table dtype, route each lookup (the routed form: floor page, page
//    maps, clamps, exactly as InterleavedTensor._route) and keep (row,
//    weight, shard) per lookup in shared memory.  After the prologue no
//    row load waits on an index, weight or map load.  Bags longer than the
//    staging area go through it in chunks.
//  * A cp.async ring of rows.  Each thread keeps ER_S stages of ER_U
//    lookups in shared memory (16 bytes per lookup and thread); commit and
//    wait_group(ER_S - 1) keep ER_S - 1 stages in flight while the oldest
//    one is added in k order.  Rows cost shared memory, not registers.  HBM
//    rows are copied with .cg, pinned host rows with .ca (on an H100 .cg
//    read pinned memory at a third of .ca's rate; PERF.md).  Each thread
//    reads back only the slots it filled, so the ring needs no barrier.
//  * The sum is the Pallas body's: fp32, k in order, separate multiply
//    and add roundings (__fmul_rn/__fadd_rn, plus --fmad=false at build
//    time), then a cast to the table dtype: fp32 results are bit-identical
//    to the plain version.  The routed form keeps one fp32 accumulator per
//    shard (unrolled, predicated), rounds each to the table dtype and adds
//    them in shard order with one rounding per add, skipping shards of 0
//    rows: bit for bit the per-shard loop of table-form launches.
//  * A lookup whose weight is exactly 0 (after rounding) issues no row
//    read (cp.async with source size 0, which zero-fills) and no add.
//    Skipping the add is exact: the fp32 sum starts at +0.0 and adding
//    +/-0.0 changes nothing for a finite table.
//  * Indices are read as given, int32 or int64.  Rows are clamped into
//    [0, rows) of their shard, so a stray index cannot fault.
//  * D or alignments that are not multiples of 16 bytes take a scalar
//    path: one element per thread, plain loads ER_U lookups at a time.
//
// The staged path of the routed form (`repro_bag_reduce_staged`), for
// calls with a pinned shard and many lookups (the wrapper decides).
// Random rows spread over a large pinned shard are read from it at a
// fraction of the rate the same SM read path reaches on a sequential
// range: each row lands in another region of the host address space, and
// its translation is fetched anew (on an H100, the DLRM cell's 28.8 GiB
// shard gave 7.4 GB/s at random and 15.2 in address order; PERF.md).  So
// the rows are read in address order, into HBM, before the bag sums, in
// six kernels on the stream and with no host synchronisation (the first
// zeroes the region counters):
//  1. plan: route each lookup as the prologue does; a lookup of a pinned
//     shard with a weight that is not 0 (after rounding) counts itself in
//     its region's counter (regions of 2^region_log2 bytes of the pinned
//     shards, in shard order) and keeps its rank there;
//  2. scan: the counters become each region's first slot (one block);
//  3. scatter: each staged lookup's slot is its region's first slot plus
//     its rank, and the slot's source address is written in slot order;
//  4. gather: the rows are copied in slot order, so in region order, one
//     16-byte .ca load a thread, into a contiguous HBM staging buffer;
//  5. reduce: the bag kernel above, whose staged lookups read their slot
//     from HBM (.cg) instead of their row over PCIe.  The values are bit
//     copies and the sum is unchanged, so the results equal the one-launch
//     kernel's bit for bit.
// Order within a region is the atomics' (free); a row looked up twice is
// read twice.  The caller passes one workspace from its allocator: the
// counters, the keys, the slots, the source addresses and a row of
// staging per lookup (staged_bytes).  What bounds it: the gather's pinned
// reads, a translation per row where the rows are sparser than about one
// per 64 KiB (order then saves nothing); the plan, scan, scatter and
// reduce move a few bytes a lookup in HBM.
//
// ER_THREADS, ER_S and ER_U may be set at build time;
// tools/embedding_reduce_probe.py sweeps them.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#ifndef ER_THREADS
#define ER_THREADS 128
#endif
#ifndef ER_S
#define ER_S 4
#endif
#ifndef ER_U
#define ER_U 4
#endif

namespace {

constexpr int MAX_SHARDS = 4;
constexpr int MAX_LANES = 32;  // threads per bag and column tile
constexpr int PRO = 4;         // prologue lookups per thread per round
constexpr int STAGE = 2048;    // lookups staged per block (9 bytes each)
// s_dev holds the shard in its low bits, and STAGED for a lookup whose row
// the staged path copied to HBM (s_row is then its staging slot)
constexpr uint8_t SHARD_BITS = 0x7f, STAGED = 0x80;
// the staged path's plan and scatter blocks, its scan block, its gather
constexpr int PLAN_THREADS = 256, SCAN_THREADS = 1024, SCAN_ITEMS = 8;
constexpr int GATHER_THREADS = 256;

static_assert(ER_THREADS % MAX_LANES == 0 && ER_THREADS <= 1024, "block size");
static_assert(ER_S >= 2 && ER_U >= 1, "ring shape");

struct Shards {
  const char* base[MAX_SHARDS];
  int64_t rows[MAX_SHARDS];
  int host[MAX_SHARDS];  // 1: pinned host memory (.ca), 0: HBM (.cg)
  int n;
};

struct Route {
  const int8_t* page_device;
  const int64_t* page_local;
  int64_t page_rows, n_pages;
  int shift;  // log2(page_rows) when it is a power of two, else -1
};

// The staged path's buffers, carved from the caller's workspace.
struct Plan {
  int32_t* count;     // [nb + 1] lookups a region, then its first slot;
                      // count[nb]: the staged lookups
  int64_t* key;       // [n] (shard << 32 | row) of a staged lookup
  const char** src;   // [n] a slot's row address, in slot order
  int32_t* slot;      // [n] a lookup's rank in its region, then its slot;
                      // -1: not staged
  char* rows;         // [n * row_bytes] staging
  int64_t nb;         // regions
  int64_t region0[MAX_SHARDS];  // a pinned shard's first region
  int region_log2;
};

// a[d] for a runtime d, with constant indices only (no dynamic parameter
// reads, which would copy the array to local memory)
template <typename V>
__device__ __forceinline__ V pick(const V (&a)[MAX_SHARDS], int d) {
  V v = a[0];
#pragma unroll
  for (int s = 1; s < MAX_SHARDS; ++s)
    if (d == s) v = a[s];
  return v;
}

// the page of global row i (clamped into the map) and i's offset in it,
// taken from the unclamped page: floor division (C++ `/` truncates toward
// zero), as InterleavedTensor._route
__device__ __forceinline__ int64_t page_of(const Route& rt, int64_t i, int64_t& off) {
  int64_t q;
  if (rt.shift >= 0) {
    q = i >> rt.shift;  // arithmetic shift: floor
  } else {
    q = i / rt.page_rows;
    if (q * rt.page_rows > i) q -= 1;
  }
  off = i - q * rt.page_rows;
  return q < 0 ? 0 : (q >= rt.n_pages ? rt.n_pages - 1 : q);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// x rounded to T and back: the value a T tensor holds.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (sizeof(T) == 2) return __bfloat162float(__float2bfloat16_rn(x));
  else return x;
}

__device__ __forceinline__ void store_f32(float x, float* o) { *o = x; }
__device__ __forceinline__ void store_f32(float x, __nv_bfloat16* o) { *o = __float2bfloat16_rn(x); }

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&acc)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    alignas(16) T e[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) store_f32(acc[j], &e[j]);
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(e);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) store_f32(acc[j], p + j);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with ok false nothing is read and the slot is
// zero-filled (source size 0).
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

// weight i as fp32 (wcode 0), bf16 (1) or absent, meaning 1 (-1)
__device__ __forceinline__ float load_weight(const void* w, int wcode, int64_t i) {
  if (wcode == 0) return static_cast<const float*>(w)[i];
  if (wcode == 1) return __bfloat162float(static_cast<const __nv_bfloat16*>(w)[i]);
  return 1.0f;
}

// T: table dtype; VEC: elements per thread (16 bytes, or 1 for the scalar
// path); I: index dtype; ROUTED: route through the page maps over sh.n
// shards (else one table, global rows); STAGED_ROWS: the staged path's
// reduce, whose lookups with a slot in stage_slot read their row there.
template <typename T, int VEC, typename I, bool ROUTED, bool STAGED_ROWS>
__device__ __forceinline__ void
bag_body(Shards sh, Route rt, const I* __restrict__ idx,
         const void* __restrict__ w, int wcode, T* __restrict__ out, int64_t D, int64_t B,
         int64_t K, int lanes, int kc, const int32_t* __restrict__ stage_slot,
         const char* __restrict__ stage) {
  constexpr bool RING = VEC * sizeof(T) == 16;
  static_assert(RING || !STAGED_ROWS, "the staged path reads 16-byte rows");
  constexpr int NS = ROUTED ? MAX_SHARDS : 1;
  constexpr int RING_BYTES = RING ? ER_THREADS * ER_S * ER_U * 16 : 0;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ const char* s_base[MAX_SHARDS];
  __shared__ int64_t s_rows[MAX_SHARDS];
  __shared__ int s_host[MAX_SHARDS];

  const int tid = threadIdx.x;
  const int bags = ER_THREADS / lanes;
  const int slot = tid / lanes;
  const int64_t bag0 = (int64_t)blockIdx.x * bags;
  const int64_t bag = bag0 + slot;
  const int64_t n_chunks = D / VEC;
  const int64_t c = (int64_t)blockIdx.y * lanes + (tid & (lanes - 1));
  const bool active = bag < B && c < n_chunks;
  const int64_t row_bytes = D * (int64_t)sizeof(T);

  int32_t* s_row = reinterpret_cast<int32_t*>(smem + RING_BYTES);
  float* s_w = reinterpret_cast<float*>(s_row + bags * kc);
  uint8_t* s_dev = reinterpret_cast<uint8_t*>(s_w + bags * kc);

  if (tid < MAX_SHARDS) {  // constant indices only: no dynamic param reads
#pragma unroll
    for (int s = 0; s < MAX_SHARDS; ++s) {
      if (tid == s) {
        s_base[s] = sh.base[s];
        s_rows[s] = s < sh.n ? sh.rows[s] : 0;
        s_host[s] = sh.host[s];
      }
    }
  }

  __syncthreads();  // the shard table is written

  float acc[NS][VEC];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[s][j] = 0.0f;

  const uint32_t ring0 = smem_u32(smem) + tid * 16;
  for (int64_t k0 = 0; k0 < K; k0 += kc) {
    const int kcur = (int)(K - k0 < kc ? K - k0 : kc);
    const int n_stage = bags * kcur;
    if (k0 > 0) __syncthreads();  // every thread is done with the last chunk

    // -- prologue: stage (row, weight, shard) of the block's lookups ------
    for (int e0 = 0; e0 < n_stage; e0 += ER_THREADS * PRO) {
      int64_t iv[PRO];
      float wv[PRO];
      bool ok[PRO];
      int32_t sl[PRO];  // staging slot (STAGED_ROWS), else -1
#pragma unroll
      for (int u = 0; u < PRO; ++u) {
        const int e = e0 + u * ER_THREADS + tid;
        const int j = e / kcur;
        const int64_t b = bag0 + j;
        ok[u] = e < n_stage && b < B;
        const int64_t g = b * K + k0 + (e - j * kcur);
        iv[u] = ok[u] ? (int64_t)idx[g] : 0;
        wv[u] = ok[u] ? load_weight(w, wcode, g) : 0.0f;
        if constexpr (STAGED_ROWS) sl[u] = ok[u] ? stage_slot[g] : -1;
      }
      int64_t page[PRO], off[PRO];
      int dv[PRO];
      int64_t pl[PRO];
#pragma unroll
      for (int u = 0; u < PRO; ++u) {
        if constexpr (ROUTED) {
          page[u] = page_of(rt, iv[u], off[u]);
        } else {
          page[u] = 0;
          off[u] = iv[u];
        }
      }
#pragma unroll
      for (int u = 0; u < PRO; ++u) {
        if constexpr (ROUTED) {
          dv[u] = ok[u] ? (int)rt.page_device[page[u]] : -1;
          pl[u] = ok[u] ? rt.page_local[page[u]] : 0;
        } else {
          dv[u] = 0;
          pl[u] = 0;
        }
      }
#pragma unroll
      for (int u = 0; u < PRO; ++u) {
        const int e = e0 + u * ER_THREADS + tid;
        if (e < n_stage) {
          const int d = dv[u];
          // a lookup of an absent or empty shard adds nothing
          const bool owned = d >= 0 && d < MAX_SHARDS && s_rows[d] > 0;
          const int64_t n = owned ? s_rows[d] : 1;
          int64_t r = ROUTED ? pl[u] * rt.page_rows + off[u] : off[u];
          r = r < 0 ? 0 : (r >= n ? n - 1 : r);
          s_row[e] = (int32_t)r;
          s_w[e] = owned ? round_to<T>(wv[u]) : 0.0f;
          s_dev[e] = (uint8_t)(owned ? d : 0);
          if constexpr (STAGED_ROWS) {
            if (owned && sl[u] >= 0) {
              s_row[e] = sl[u];
              s_dev[e] = (uint8_t)(d | STAGED);
            }
          }
        }
      }
    }
    __syncthreads();

    // -- rows, k in order ---------------------------------------------------
    const int sb = slot * kcur;  // this bag's staged entries
    const int n_groups = (kcur + ER_U - 1) / ER_U;
    auto add = [&](int k, const T (&v)[VEC]) {
      const float wk = s_w[sb + k];
      if (wk == 0.0f) return;
      const int d = STAGED_ROWS ? s_dev[sb + k] & SHARD_BITS : s_dev[sb + k];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float p = __fmul_rn(to_f32(v[j]), wk);
#pragma unroll
        for (int s = 0; s < NS; ++s)
          if (NS == 1 || d == s) acc[s][j] = __fadd_rn(acc[s][j], p);
      }
    };
    if constexpr (RING) {
      auto issue = [&](int g) {
        if (g < n_groups) {
          const uint32_t dst = ring0 + (g % ER_S) * (ER_U * ER_THREADS * 16);
#pragma unroll
          for (int u = 0; u < ER_U; ++u) {
            const int k = g * ER_U + u;
            if (k < kcur) {
              const int dv = s_dev[sb + k];
              const int d = STAGED_ROWS ? dv & SHARD_BITS : dv;
              const bool staged = STAGED_ROWS && (dv & STAGED) != 0;
              const bool load = active && s_w[sb + k] != 0.0f;
              const char* src = (staged ? stage : s_base[d]) +
                                (int64_t)s_row[sb + k] * row_bytes + c * 16;
              cp_async16(dst + u * ER_THREADS * 16, load ? src : s_base[0], load,
                         !staged && s_host[d] != 0);
            }
          }
        }
        cp_commit();  // an empty group past the end keeps the count uniform
      };
#pragma unroll
      for (int g = 0; g < ER_S - 1; ++g) issue(g);
      for (int g = 0; g < n_groups; ++g) {
        issue(g + ER_S - 1);  // into the slot added in iteration g - 1
        cp_wait<ER_S - 1>();  // group g has landed
        const unsigned char* src = smem + (g % ER_S) * (ER_U * ER_THREADS * 16) + tid * 16;
#pragma unroll
        for (int u = 0; u < ER_U; ++u) {
          const int k = g * ER_U + u;
          if (k < kcur) {
            const uint4 raw = *reinterpret_cast<const uint4*>(src + u * ER_THREADS * 16);
            T v[VEC];
            const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
            for (int j = 0; j < VEC; ++j) v[j] = e[j];
            add(k, v);
          }
        }
      }
    } else {
      for (int g = 0; g < n_groups; ++g) {
        T v[ER_U][VEC];
#pragma unroll
        for (int u = 0; u < ER_U; ++u) {
          const int k = g * ER_U + u;
          v[u][0] = T(0.0f);
          if (active && k < kcur && s_w[sb + k] != 0.0f) {
            const int d = s_dev[sb + k];
            const T* src = reinterpret_cast<const T*>(
                s_base[d] + (int64_t)s_row[sb + k] * row_bytes);
            v[u][0] = src[c];
          }
        }
#pragma unroll
        for (int u = 0; u < ER_U; ++u)
          if (g * ER_U + u < kcur) add(g * ER_U + u, v[u]);
      }
    }
  }

  if (!active) return;
  // partials rounded to T and summed in shard order, empty shards skipped
  float o[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) o[j] = 0.0f;
  bool first = true;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    if (!ROUTED || s_rows[s] > 0) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float p = round_to<T>(acc[s][j]);
        o[j] = first ? p : round_to<T>(__fadd_rn(o[j], p));
      }
      first = false;
    }
  }
  store_vec<T, VEC>(out + bag * D + c * VEC, o);
}

template <typename T, int VEC, typename I, bool ROUTED>
__global__ void __launch_bounds__(ER_THREADS)
bag_kernel(Shards sh, Route rt, const I* __restrict__ idx, const void* __restrict__ w,
           int wcode, T* __restrict__ out, int64_t D, int64_t B, int64_t K, int lanes,
           int kc) {
  bag_body<T, VEC, I, ROUTED, false>(sh, rt, idx, w, wcode, out, D, B, K, lanes, kc,
                                     nullptr, nullptr);
}

// The staged path's reduce (step 5 in the header): the routed bag kernel
// whose staged lookups read their row from its staging slot in HBM.
template <typename T, typename I>
__global__ void __launch_bounds__(ER_THREADS)
bag_staged_kernel(Shards sh, Route rt, const I* __restrict__ idx, const void* __restrict__ w,
                  int wcode, T* __restrict__ out, int64_t D, int64_t B, int64_t K, int lanes,
                  int kc, const int32_t* __restrict__ stage_slot,
                  const char* __restrict__ stage) {
  bag_body<T, 16 / sizeof(T), I, true, true>(sh, rt, idx, w, wcode, out, D, B, K, lanes,
                                             kc, stage_slot, stage);
}

// The bag kernel (or, with plan, the staged path's reduce) on the stream.
template <typename T, int VEC, typename I, bool ROUTED>
int launch(const Shards& sh, const Route& rt, const void* idx, const void* w, int wcode,
           void* out, int64_t D, int64_t B, int64_t K, cudaStream_t stream,
           const Plan* plan = nullptr) {
  const void* kernel = plan ? reinterpret_cast<const void*>(bag_staged_kernel<T, I>)
                            : reinterpret_cast<const void*>(bag_kernel<T, VEC, I, ROUTED>);
  const int64_t n_chunks = D / VEC;
  int lanes = 1;
  while (lanes < n_chunks && lanes < MAX_LANES) lanes <<= 1;
  const int bags = ER_THREADS / lanes;
  int64_t kc = STAGE / bags;
  kc = K < kc ? K : kc;
  kc = kc < 1 ? 1 : kc;
  const size_t ring = VEC * sizeof(T) == 16 ? (size_t)ER_THREADS * ER_S * ER_U * 16 : 0;
  const size_t smem = ring + (size_t)bags * kc * (sizeof(int32_t) + sizeof(float) + 1);
  static size_t allowed[2] = {48 * 1024, 48 * 1024};  // per kernel
  if (smem > allowed[plan != nullptr]) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed[plan != nullptr] = smem;
  }
  const dim3 grid((unsigned)((B + bags - 1) / bags),
                  (unsigned)((n_chunks + lanes - 1) / lanes));
  if (plan)
    bag_staged_kernel<T, I><<<grid, ER_THREADS, smem, stream>>>(
        sh, rt, static_cast<const I*>(idx), w, wcode, static_cast<T*>(out), D, B, K,
        lanes, (int)kc, plan->slot, plan->rows);
  else
    bag_kernel<T, VEC, I, ROUTED><<<grid, ER_THREADS, smem, stream>>>(
        sh, rt, static_cast<const I*>(idx), w, wcode, static_cast<T*>(out), D, B, K,
        lanes, (int)kc);
  return (int)cudaGetLastError();
}

template <bool ROUTED>
int dispatch(const Shards& sh, const Route& rt, const void* idx, int idx64, const void* w,
             int wcode, void* out, int64_t D, int64_t B, int64_t K, int dtype, int vec,
             cudaStream_t s) {
  if (B <= 0 || D <= 0) return (int)cudaGetLastError();
  if (sh.n < 1 || sh.n > MAX_SHARDS || wcode < -1 || wcode > 1)
    return (int)cudaErrorInvalidValue;
#define ER_IDX(T, VEC)                                                                \
  return idx64 ? launch<T, VEC, int64_t, ROUTED>(sh, rt, idx, w, wcode, out, D, B, K, s) \
               : launch<T, VEC, int32_t, ROUTED>(sh, rt, idx, w, wcode, out, D, B, K, s)
  if (dtype == 0) {
    if (vec > 1) ER_IDX(float, 4);
    ER_IDX(float, 1);
  }
  if (dtype == 1) {
    if (vec > 1) ER_IDX(__nv_bfloat16, 8);
    ER_IDX(__nv_bfloat16, 1);
  }
#undef ER_IDX
  return (int)cudaErrorInvalidValue;
}

Shards make_shards(const void* const* parts, const int64_t* rows, const int* host,
                   int n_shards) {
  Shards sh = {};
  for (int i = 0; i < n_shards; ++i) {
    sh.base[i] = static_cast<const char*>(parts[i]);
    sh.rows[i] = rows[i];
    sh.host[i] = host[i];
  }
  for (int i = n_shards; i < MAX_SHARDS; ++i) sh.base[i] = sh.base[0];
  sh.n = n_shards;
  return sh;
}

Route make_route(const int8_t* page_device, const int64_t* page_local, int64_t page_rows,
                 int64_t n_pages) {
  Route rt = {page_device, page_local, page_rows, n_pages, -1};
  if ((page_rows & (page_rows - 1)) == 0) {
    rt.shift = 0;
    while ((int64_t(1) << rt.shift) < page_rows) ++rt.shift;
  }
  return rt;
}

// -- the staged path --------------------------------------------------------

// 1. plan: a lookup of a pinned shard whose weight is not 0 (after
// rounding to T) counts itself in its region and keeps its rank there.
template <typename T, typename I>
__global__ void __launch_bounds__(PLAN_THREADS)
plan_kernel(Shards sh, Route rt, const I* __restrict__ idx, const void* __restrict__ w,
            int wcode, int64_t n, int64_t row_bytes, Plan plan) {
  const int64_t g = (int64_t)blockIdx.x * PLAN_THREADS + threadIdx.x;
  if (g >= n) return;
  int64_t off;
  const int64_t page = page_of(rt, (int64_t)idx[g], off);
  const int d = rt.page_device[page];
  int32_t rank = -1;
  if (d >= 0 && d < MAX_SHARDS) {
    const int64_t rows = d < sh.n ? pick(sh.rows, d) : 0;
    if (pick(sh.host, d) && rows > 0 &&
        round_to<T>(load_weight(w, wcode, g)) != 0.0f) {
      int64_t r = rt.page_local[page] * rt.page_rows + off;
      r = r < 0 ? 0 : (r >= rows ? rows - 1 : r);
      const int64_t region = pick(plan.region0, d) + ((r * row_bytes) >> plan.region_log2);
      rank = atomicAdd(&plan.count[region], 1);
      plan.key[g] = (int64_t)d << 32 | r;
    }
  }
  plan.slot[g] = rank;
}

// 2. scan: count[i] becomes the exclusive prefix sum, count[nb] the total;
// one block walks the counters in tiles of SCAN_THREADS x SCAN_ITEMS.
__global__ void __launch_bounds__(SCAN_THREADS) scan_kernel(int32_t* count, int64_t nb) {
  __shared__ int32_t warp_sum[SCAN_THREADS / 32];
  __shared__ int32_t carry;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) carry = 0;
  __syncthreads();
  for (int64_t t0 = 0; t0 < nb; t0 += SCAN_THREADS * SCAN_ITEMS) {
    const int64_t i0 = t0 + (int64_t)tid * SCAN_ITEMS;
    int32_t v[SCAN_ITEMS], own = 0;
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j) {
      v[j] = i0 + j < nb ? count[i0 + j] : 0;
      own += v[j];
    }
    int32_t x = own;  // inclusive scan within the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sum[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int32_t y = warp_sum[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int32_t z = __shfl_up_sync(0xffffffffu, y, o);
        if (lane >= o) y += z;
      }
      warp_sum[lane] = y;
    }
    __syncthreads();
    int32_t run = carry + (warp > 0 ? warp_sum[warp - 1] : 0) + x - own;
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j) {
      if (i0 + j < nb) count[i0 + j] = run;
      run += v[j];
    }
    __syncthreads();  // carry and warp_sum are read
    if (tid == SCAN_THREADS - 1) carry = run;
    __syncthreads();
  }
  if (tid == 0) count[nb] = carry;
}

// 3. scatter: a staged lookup's slot, and its row's address at the slot.
__global__ void __launch_bounds__(PLAN_THREADS)
scatter_kernel(Shards sh, int64_t n, int64_t row_bytes, Plan plan) {
  const int64_t g = (int64_t)blockIdx.x * PLAN_THREADS + threadIdx.x;
  if (g >= n) return;
  const int32_t rank = plan.slot[g];
  if (rank < 0) return;
  const int64_t key = plan.key[g];
  const int d = (int)(key >> 32);
  const int64_t r = key & 0xffffffff;
  const int64_t region = pick(plan.region0, d) + ((r * row_bytes) >> plan.region_log2);
  const int32_t at = plan.count[region] + rank;
  plan.slot[g] = at;
  plan.src[at] = pick(sh.base, d) + r * row_bytes;
}

// 4. gather: the staged rows in slot order, one 16-byte .ca load a thread
// (deeper loads a thread read the cell's 28.8 GiB shard slower:
// tools/embedding_reduce_probe.py --pinned-order).
__global__ void __launch_bounds__(GATHER_THREADS)
gather_kernel(const char* const* __restrict__ src, const int32_t* __restrict__ total,
              uint4* __restrict__ rows, int64_t row_vecs) {
  const int64_t i = (int64_t)blockIdx.x * GATHER_THREADS + threadIdx.x;
  if (i >= (int64_t)*total * row_vecs) return;
  const int64_t at = i / row_vecs;
  rows[i] = __ldca(reinterpret_cast<const uint4*>(src[at]) + (i - at * row_vecs));
}

__global__ void clear_kernel(int32_t* a, int64_t n) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x)
    a[i] = 0;
}

int64_t align16(int64_t x) { return (x + 15) & ~int64_t(15); }

// the workspace of n lookups over nb regions (kernel.staged_bytes)
int64_t staged_bytes(int64_t nb, int64_t n, int64_t row_bytes) {
  return align16(4 * (nb + 1)) + 16 * n + align16(4 * n) + n * row_bytes;
}

template <typename T, typename I>
int staged(const Shards& sh, const Route& rt, const void* idx, const void* w, int wcode,
           void* out, int64_t D, int64_t B, int64_t K, Plan& plan, cudaStream_t s) {
  const int64_t n = B * K, row_bytes = D * (int64_t)sizeof(T);
  const unsigned blocks = (unsigned)((n + PLAN_THREADS - 1) / PLAN_THREADS);
  clear_kernel<<<(unsigned)((plan.nb + 1 + 1023) / 1024), 1024, 0, s>>>(plan.count, plan.nb + 1);
  plan_kernel<T, I><<<blocks, PLAN_THREADS, 0, s>>>(sh, rt, static_cast<const I*>(idx), w,
                                                    wcode, n, row_bytes, plan);
  scan_kernel<<<1, SCAN_THREADS, 0, s>>>(plan.count, plan.nb);
  scatter_kernel<<<blocks, PLAN_THREADS, 0, s>>>(sh, n, row_bytes, plan);
  const int64_t row_vecs = row_bytes / 16;
  gather_kernel<<<(unsigned)((n * row_vecs + GATHER_THREADS - 1) / GATHER_THREADS),
                  GATHER_THREADS, 0, s>>>(plan.src, plan.count + plan.nb,
                                          reinterpret_cast<uint4*>(plan.rows), row_vecs);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return launch<T, 16 / sizeof(T), I, true>(sh, rt, idx, w, wcode, out, D, B, K, s, &plan);
}

}  // namespace

// The table form.  dtype: 0 = float32, 1 = bfloat16 (table and output).
// idx64: indices are int64 (else int32).  wcode: weights are float32 (0)
// or bfloat16 (1); each is rounded to the table dtype.  host: the table
// lies in pinned host memory.  vec: 1 for the scalar path, else 16 bytes
// per load (the wrapper checks D and the pointers' alignment).  Returns
// cudaGetLastError().
extern "C" int repro_embedding_reduce(const void* table, int64_t V, int host,
                                      const void* idx, int idx64, const void* w,
                                      int wcode, void* out, int64_t D, int64_t B,
                                      int64_t K, int dtype, int vec, void* stream) {
  Shards sh = {};
  sh.base[0] = static_cast<const char*>(table);
  sh.rows[0] = V;
  sh.host[0] = host;
  sh.n = 1;
  Route rt = {};
  return dispatch<false>(sh, rt, idx, idx64, w, wcode, out, D, B, K, dtype, vec,
                         static_cast<cudaStream_t>(stream));
}

// The routed form over n_shards (1..4) shards: parts[i] with rows[i] rows
// (in pinned host memory where host[i]), the int8 page -> shard map and
// the int64 page -> shard-local page map of n_pages pages of page_rows
// rows.  w may be null (every weight 1, wcode -1).  The other arguments
// are the table form's.
extern "C" int repro_bag_reduce_routed(const void* const* parts, const int64_t* rows,
                                       const int* host, int n_shards,
                                       const int8_t* page_device,
                                       const int64_t* page_local, int64_t page_rows,
                                       int64_t n_pages, const void* idx, int idx64,
                                       const void* w, int wcode, void* out, int64_t D,
                                       int64_t B, int64_t K, int dtype, int vec,
                                       void* stream) {
  if (n_shards < 1 || n_shards > MAX_SHARDS || page_rows < 1 || n_pages < 1)
    return (int)cudaErrorInvalidValue;
  return dispatch<true>(make_shards(parts, rows, host, n_shards),
                        make_route(page_device, page_local, page_rows, n_pages), idx, idx64,
                        w, wcode, out, D, B, K, dtype, vec, static_cast<cudaStream_t>(stream));
}

// The staged path of the routed form (see the header): the routed form's
// arguments (16-byte rows and pointers only: vec > 1), then the
// workspace, work_bytes of it, at least staged_bytes of the regions of
// 2^region_log2 bytes of the pinned shards and B * K lookups.  Six kernels
// on the stream; no host synchronisation and no allocation.
extern "C" int repro_bag_reduce_staged(const void* const* parts, const int64_t* rows,
                                       const int* host, int n_shards,
                                       const int8_t* page_device,
                                       const int64_t* page_local, int64_t page_rows,
                                       int64_t n_pages, const void* idx, int idx64,
                                       const void* w, int wcode, void* out, int64_t D,
                                       int64_t B, int64_t K, int dtype, void* work,
                                       int64_t work_bytes, int region_log2, void* stream) {
  if (n_shards < 1 || n_shards > MAX_SHARDS || page_rows < 1 || n_pages < 1 ||
      wcode < -1 || wcode > 1 || dtype < 0 || dtype > 1 || region_log2 < 4 ||
      region_log2 > 62 || B < 1 || K < 1 || B * K >= (int64_t(1) << 31))
    return (int)cudaErrorInvalidValue;
  const int64_t item = dtype == 0 ? 4 : 2, row_bytes = D * item;
  if (D < 1 || row_bytes % 16 != 0) return (int)cudaErrorInvalidValue;
  const Shards sh = make_shards(parts, rows, host, n_shards);
  Plan plan = {};
  for (int i = 0; i < n_shards; ++i) {
    plan.region0[i] = plan.nb;
    if (host[i] && rows[i] > 0)
      plan.nb += ((rows[i] * row_bytes - 1) >> region_log2) + 1;
  }
  const int64_t n = B * K;
  if (plan.nb < 1 || work_bytes < staged_bytes(plan.nb, n, row_bytes))
    return (int)cudaErrorInvalidValue;
  char* p = static_cast<char*>(work);
  plan.count = reinterpret_cast<int32_t*>(p);
  p += align16(4 * (plan.nb + 1));
  plan.key = reinterpret_cast<int64_t*>(p);
  p += 8 * n;
  plan.src = reinterpret_cast<const char**>(p);
  p += 8 * n;
  plan.slot = reinterpret_cast<int32_t*>(p);
  p += align16(4 * n);
  plan.rows = p;
  plan.region_log2 = region_log2;
  const Route rt = make_route(page_device, page_local, page_rows, n_pages);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return idx64 ? staged<float, int64_t>(sh, rt, idx, w, wcode, out, D, B, K, plan, s)
                 : staged<float, int32_t>(sh, rt, idx, w, wcode, out, D, B, K, plan, s);
  return idx64 ? staged<__nv_bfloat16, int64_t>(sh, rt, idx, w, wcode, out, D, B, K, plan, s)
               : staged<__nv_bfloat16, int32_t>(sh, rt, idx, w, wcode, out, D, B, K, plan, s);
}
