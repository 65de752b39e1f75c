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
// shards (else one table, global rows).
template <typename T, int VEC, typename I, bool ROUTED>
__global__ void __launch_bounds__(ER_THREADS)
bag_kernel(Shards sh, Route rt, const I* __restrict__ idx, const void* __restrict__ w,
           int wcode, T* __restrict__ out, int64_t D, int64_t B, int64_t K, int lanes,
           int kc) {
  constexpr bool RING = VEC * sizeof(T) == 16;
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
#pragma unroll
      for (int u = 0; u < PRO; ++u) {
        const int e = e0 + u * ER_THREADS + tid;
        const int j = e / kcur;
        const int64_t b = bag0 + j;
        ok[u] = e < n_stage && b < B;
        const int64_t g = b * K + k0 + (e - j * kcur);
        iv[u] = ok[u] ? (int64_t)idx[g] : 0;
        wv[u] = ok[u] ? load_weight(w, wcode, g) : 0.0f;
      }
      int64_t page[PRO], off[PRO];
      int dv[PRO];
      int64_t pl[PRO];
#pragma unroll
      for (int u = 0; u < PRO; ++u) {
        if constexpr (ROUTED) {
          // floor division (C++ `/` truncates toward zero); offset from
          // the unclamped page, then the page clamped into the map
          int64_t q;
          if (rt.shift >= 0) {
            q = iv[u] >> rt.shift;  // arithmetic shift: floor
          } else {
            q = iv[u] / rt.page_rows;
            if (q * rt.page_rows > iv[u]) q -= 1;
          }
          off[u] = iv[u] - q * rt.page_rows;
          page[u] = q < 0 ? 0 : (q >= rt.n_pages ? rt.n_pages - 1 : q);
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
      const int d = s_dev[sb + k];
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
              const int d = s_dev[sb + k];
              const bool load = active && s_w[sb + k] != 0.0f;
              const char* src = s_base[d] + (int64_t)s_row[sb + k] * row_bytes + c * 16;
              cp_async16(dst + u * ER_THREADS * 16, load ? src : s_base[0], load,
                         s_host[d] != 0);
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
int launch(const Shards& sh, const Route& rt, const void* idx, const void* w, int wcode,
           void* out, int64_t D, int64_t B, int64_t K, cudaStream_t stream) {
  void (*kernel)(Shards, Route, const I*, const void*, int, T*, int64_t, int64_t, int64_t,
                 int, int) = bag_kernel<T, VEC, I, ROUTED>;
  const int64_t n_chunks = D / VEC;
  int lanes = 1;
  while (lanes < n_chunks && lanes < MAX_LANES) lanes <<= 1;
  const int bags = ER_THREADS / lanes;
  int64_t kc = STAGE / bags;
  kc = K < kc ? K : kc;
  kc = kc < 1 ? 1 : kc;
  const size_t ring = VEC * sizeof(T) == 16 ? (size_t)ER_THREADS * ER_S * ER_U * 16 : 0;
  const size_t smem = ring + (size_t)bags * kc * (sizeof(int32_t) + sizeof(float) + 1);
  static size_t allowed = 48 * 1024;  // per instantiation
  if (smem > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed = smem;
  }
  const dim3 grid((unsigned)((B + bags - 1) / bags),
                  (unsigned)((n_chunks + lanes - 1) / lanes));
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
  Shards sh = {};
  for (int i = 0; i < n_shards; ++i) {
    sh.base[i] = static_cast<const char*>(parts[i]);
    sh.rows[i] = rows[i];
    sh.host[i] = host[i];
  }
  for (int i = n_shards; i < MAX_SHARDS; ++i) sh.base[i] = sh.base[0];
  sh.n = n_shards;
  Route rt = {page_device, page_local, page_rows, n_pages, -1};
  if ((page_rows & (page_rows - 1)) == 0) {
    rt.shift = 0;
    while ((int64_t(1) << rt.shift) < page_rows) ++rt.shift;
  }
  return dispatch<true>(sh, rt, idx, idx64, w, wcode, out, D, B, K, dtype, vec,
                        static_cast<cudaStream_t>(stream));
}
