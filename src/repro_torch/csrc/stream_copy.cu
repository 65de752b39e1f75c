// Segment-list streaming copy with a fused dtype cast for Hopper (sm_90a):
//     dst_i[r, c] = cast(src_i[r, c])   for every segment i of one launch.
//
// Replaces the Pallas TPU kernel repro/kernels/stream_copy/kernel.py
// (`stream_copy`, body `_migrate_kernel`), which stages an (N, M) slab
// through three VMEM slots with double-buffered async DMAs.
//
// What bounds it: bytes.  It reads each element once and writes it once,
// with no arithmetic beyond the cast.  On the card's own memory the bound
// is HBM bandwidth; on the routes to and from page-locked host memory,
// which the kernel reads or writes in place through unified virtual
// addressing, it is the PCIe link.
//
// A segment is a source and a destination pointer, rows x cols elements,
// and one row stride on each side (a contiguous slab is one row; a row
// stride of 0 repeats one source row).  Either side may be HBM or pinned
// host memory.  One launch moves a whole list: a page move's gather of
// every run into a staging buffer, or its landing into every shard, is
// one launch instead of one per run.
//
// Design:
// * Work unit: 16 bytes of source (VEC elements).  The host gives the
//   prefix sum of each segment's units (rows x ceil(cols / VEC)).
// * A persistent grid of SC_BPS blocks an SM, or as many as fit (fewer
//   for a short list: about SPREAD units a thread).  Each block takes an equal range of
//   units across all segments; each thread finds the
//   segment of a unit by binary search over the prefix sum, and keeps it
//   while its next units stay inside it.
// * Bytes in flight: each thread issues SC_U independent 16-byte loads
//   (the unit at the thread's lane, then THREADS units further, ...)
//   before any of its stores; SC_BPS blocks an SM bound the registers.
//   Loads from host memory are ld.global.ca, loads from HBM
//   ld.global.nc (.cg and the L2 prefetch hints read no faster;
//   PERF.md).
// * A unit of a segment whose rows start 16-byte aligned on both sides
//   (the host's flag) moves as one vector; the last, partial unit of a
//   row and every unit of an unaligned segment move element by element.
//   Every result is bit-exact: fp32 -> bf16 rounds to nearest even
//   (__float2bfloat16_rn, as PyTorch's .to does), bf16 -> fp32 is exact.
// * Same dtype, when a block's range holds SC_BULK_RANGE bytes or more: a
//   row piece of SC_BULK bytes or more of an aligned segment moves
//   global -> shared -> global through cp.async.bulk on an mbarrier ring
//   of SC_STAGES x SC_CHUNK bytes, one thread driving it; the rest of the
//   range takes the path above, one unit a thread.
//
// The defaults (two loads in flight, 4 blocks an SM, the ring from 4 KiB
// pieces when a block holds 64 KiB) are the fastest build without spills
// that tools/stream_copy_probe.py measured; below 4 blocks an SM the ring
// read long pinned ranges several times slower.  The TPU kernel's VMEM
// staging pipeline has no counterpart beyond the ring and the registers
// that hold a thread's units between load and store.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#ifndef SC_U
#define SC_U 2
#endif
#ifndef SC_BPS
#define SC_BPS 4
#endif
#ifndef SC_BULK
#define SC_BULK 4096
#endif
#ifndef SC_STAGES
#define SC_STAGES 4
#endif
#ifndef SC_CHUNK
#define SC_CHUNK 8192
#endif
#ifndef SC_BULK_RANGE
#define SC_BULK_RANGE 65536
#endif

namespace {

constexpr int THREADS = 256;
constexpr int SPREAD = 2;

// One row of the segment table, as the host writes it (8 x int64).
struct Seg {
  const uint8_t* src;
  uint8_t* dst;
  int64_t rows, cols;  // elements of the source type (bytes for a copy)
  int64_t ss, ds;      // row strides, in elements of each side's type
  int64_t flags;       // SEG_VEC | SEG_SRC_HOST | SEG_DST_HOST
  int64_t pad;
};
static_assert(sizeof(Seg) == 64, "segment table row is 8 int64");
constexpr int64_t SEG_VEC = 1, SEG_SRC_HOST = 2, SEG_DST_HOST = 4;

// 16 bytes from pinned host memory (through L1) or from HBM (read-only).
template <bool HOST>
__device__ __forceinline__ uint4 load16(const void* p) {
  uint4 v;
  if constexpr (HOST) {
    asm volatile("ld.global.ca.v4.u32 {%0,%1,%2,%3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  } else {
    asm volatile("ld.global.nc.v4.u32 {%0,%1,%2,%3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  }
  return v;
}

// Element conversions: a copy moves bytes; the casts go through fp32.
template <typename To, typename Ti>
__device__ __forceinline__ To cvt(Ti x) {
  if constexpr (sizeof(Ti) == sizeof(To)) {
    return x;
  } else if constexpr (sizeof(To) == 2) {
    return __float2bfloat16_rn(x);
  } else {
    return __bfloat162float(x);
  }
}

// Store the VEC converted elements of one full unit.
template <typename Ti, typename To>
__device__ __forceinline__ void store_unit(To* d, uint4 v) {
  constexpr int VEC = 16 / sizeof(Ti);
  if constexpr (sizeof(Ti) == sizeof(To)) {
    *reinterpret_cast<uint4*>(d) = v;
  } else {
    const Ti* in = reinterpret_cast<const Ti*>(&v);
    alignas(16) To out[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) out[j] = cvt<To>(in[j]);
    if constexpr (VEC * sizeof(To) == 8) {
      *reinterpret_cast<uint2*>(d) = *reinterpret_cast<const uint2*>(out);
    } else {
      reinterpret_cast<uint4*>(d)[0] = reinterpret_cast<const uint4*>(out)[0];
      reinterpret_cast<uint4*>(d)[1] = reinterpret_cast<const uint4*>(out)[1];
    }
  }
}

// The segment a thread is in, with its unit range.
struct Cursor {
  Seg s;
  int64_t lo = 0, hi = 0, upr = 1;
};

template <int VEC>
__device__ __forceinline__ void locate(Cursor& c, int64_t u,
                                       const Seg* __restrict__ table,
                                       const int64_t* __restrict__ prefix,
                                       int n_seg) {
  if (u >= c.lo && u < c.hi) return;
  int lo = 0, hi = n_seg - 1;  // last i with prefix[i] <= u
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(prefix + mid) <= u) lo = mid; else hi = mid - 1;
  }
  c.s = table[lo];
  c.lo = __ldg(prefix + lo);
  c.upr = (c.s.cols + VEC - 1) / VEC;
  c.hi = c.lo + c.s.rows * c.upr;
}

// Where unit u of segment s (its units from lo, upr a row) lies: its
// source and destination element pointers and how many elements it holds
// (VEC, or fewer at a row's end).
template <typename Ti, typename To>
__device__ __forceinline__ int unit_at(const Seg& s, int64_t lo, int64_t upr,
                                       int64_t u, const Ti*& sp, To*& dp) {
  constexpr int VEC = 16 / sizeof(Ti);
  const int64_t local = u - lo;
  int64_t row = 0, k = local;
  if (s.rows != 1) {
    row = local / upr;
    k = local - row * upr;
  }
  const int64_t e0 = k * VEC;
  sp = reinterpret_cast<const Ti*>(s.src) + row * s.ss + e0;
  dp = reinterpret_cast<To*>(s.dst) + row * s.ds + e0;
  const int64_t left = s.cols - e0;
  return left < VEC ? (int)left : VEC;
}

// The thread path over units [u0, u1) of the block, U units a thread in
// flight: units u0 + j * THREADS + threadIdx.x, j < U, each loop step.
// A one-segment launch (SINGLE) reads its segment from the kernel's
// parameters and keeps no cursor.
template <typename Ti, typename To, bool SINGLE, int U>
__device__ __forceinline__ void move_units(int64_t u0, int64_t u1, Cursor& c,
                                           const Seg& one,
                                           const Seg* __restrict__ table,
                                           const int64_t* __restrict__ prefix,
                                           int n_seg) {
  constexpr int VEC = 16 / sizeof(Ti);
  const int64_t upr1 = SINGLE ? (one.cols + VEC - 1) / VEC : 0;
  for (int64_t base = u0; base < u1; base += (int64_t)THREADS * U) {
    uint4 v[U];
    To* dp[U];
    bool vec[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int64_t u = base + (int64_t)j * THREADS + threadIdx.x;
      vec[j] = false;
      if (u < u1) {
        const Ti* sp;
        int n;
        int64_t flags;
        if constexpr (SINGLE) {
          n = unit_at<Ti, To>(one, 0, upr1, u, sp, dp[j]);
          flags = one.flags;
        } else {
          locate<VEC>(c, u, table, prefix, n_seg);
          n = unit_at<Ti, To>(c.s, c.lo, c.upr, u, sp, dp[j]);
          flags = c.s.flags;
        }
        if ((flags & SEG_VEC) && n == VEC) {
          v[j] = (flags & SEG_SRC_HOST) ? load16<true>(sp)
                                        : load16<false>(sp);
          vec[j] = true;
        } else {
          // a partial or unaligned unit (rare): element by element, now
          for (int i = 0; i < n; ++i) dp[j][i] = cvt<To>(sp[i]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      if (vec[j]) store_unit<Ti, To>(dp[j], v[j]);
    }
  }
}

#if SC_BULK > 0
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// One thread moves nbytes (a multiple of 16, both ends 16-byte aligned)
// from src to dst through the ring; bit s of `phase` carries stage s's
// mbarrier parity across calls.
__device__ void bulk_copy(const uint8_t* src, uint8_t* dst, int64_t nbytes,
                          uint8_t* ring, uint64_t* bar, uint32_t& phase) {
  const int64_t nch = (nbytes + SC_CHUNK - 1) / SC_CHUNK;
  auto issue = [&](int64_t c) {
    const int s = (int)(c % SC_STAGES);
    const int64_t off = c * SC_CHUNK;
    const uint32_t len =
        (uint32_t)(nbytes - off < SC_CHUNK ? nbytes - off : SC_CHUNK);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem_addr(bar + s)), "r"(len) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];"
        :: "r"(smem_addr(ring + s * SC_CHUNK)), "l"(src + off), "r"(len),
           "r"(smem_addr(bar + s)) : "memory");
  };
  for (int64_t c = 0; c < nch && c < SC_STAGES; ++c) issue(c);
  for (int64_t c = 0; c < nch; ++c) {
    const int s = (int)(c % SC_STAGES);
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;"
          " selp.u32 %0, 1, 0, p; }"
          : "=r"(done) : "r"(smem_addr(bar + s)), "r"((phase >> s) & 1u)
          : "memory");
    }
    phase ^= 1u << s;
    const int64_t off = c * SC_CHUNK;
    const uint32_t len =
        (uint32_t)(nbytes - off < SC_CHUNK ? nbytes - off : SC_CHUNK);
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                 :: "l"(dst + off), "r"(smem_addr(ring + s * SC_CHUNK)),
                    "r"(len) : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    if (c + SC_STAGES < nch) {
      // the stage is refilled only after its store has read it
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      issue(c + SC_STAGES);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}
#endif

template <typename Ti, typename To, bool SINGLE>
__global__ void __launch_bounds__(THREADS, SC_BPS)
segments_kernel(Seg one, const Seg* __restrict__ table,
                const int64_t* __restrict__ prefix, int n_seg, int64_t total,
                int bulk) {
  const int64_t per = (total + gridDim.x - 1) / gridDim.x;
  const int64_t b0 = (int64_t)blockIdx.x * per;
  const int64_t b1 = b0 + per < total ? b0 + per : total;
  Cursor c;
#if SC_BULK > 0
  if constexpr (sizeof(Ti) == sizeof(To)) if (bulk) {
    // walk the block's range piece by piece (a piece: the range within
    // one row of one segment); long aligned pieces take the bulk ring
    __shared__ __align__(128) uint8_t ring[SC_STAGES * SC_CHUNK];
    __shared__ __align__(8) uint64_t bar[SC_STAGES];
    uint32_t phase = 0;
    if (threadIdx.x == 0) {
      for (int s = 0; s < SC_STAGES; ++s) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                     :: "r"(smem_addr(bar + s)) : "memory");
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if constexpr (SINGLE) {
      c.s = one;
      c.upr = (one.cols + 15) / 16;
      c.hi = one.rows * c.upr;
    }
    for (int64_t u = b0; u < b1;) {
      if constexpr (!SINGLE) locate<16>(c, u, table, prefix, n_seg);
      const int64_t local = u - c.lo;
      const int64_t row = local / c.upr, k = local - row * c.upr;
      const int64_t row_end = c.lo + (row + 1) * c.upr;
      const int64_t pe = row_end < b1 ? row_end : b1;
      // the row's last unit is partial unless cols is a multiple of 16
      const int64_t full = (pe == row_end && (c.s.cols & 15)) ? pe - 1 : pe;
      int64_t from = u;
      if ((c.s.flags & SEG_VEC) && (full - u) * 16 >= SC_BULK) {
        if (threadIdx.x == 0) {
          bulk_copy(c.s.src + row * c.s.ss + k * 16,
                    c.s.dst + row * c.s.ds + k * 16, (full - u) * 16, ring,
                    bar, phase);
        }
        from = full;
      }
      // the rest of the piece on the thread path (one unit a thread)
      move_units<Ti, To, false, 1>(from, pe, c, one, table, prefix, n_seg);
      __syncthreads();
      u = pe;
    }
    return;
  }
#endif
  move_units<Ti, To, SINGLE, SC_U>(b0, b1, c, one, table, prefix, n_seg);
}

int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0) {
    cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev);
    if (count[dev] <= 0) count[dev] = 132;
  }
  return count[dev];
}

// The persistent grid: SC_BPS blocks an SM, or as many as fit.
template <typename Ti, typename To, bool SINGLE>
int launch_as(const Seg& one, const Seg* table, const int64_t* prefix, int n,
              int64_t total, cudaStream_t stream) {
  static int fit = 0;
  if (fit == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &fit, segments_kernel<Ti, To, SINGLE>, THREADS, 0);
    if (fit < 1) fit = 1;
  }
  // small lists spread over more SMs: about SPREAD units a thread
  const int64_t want = (total + (int64_t)THREADS * SPREAD - 1) /
                       ((int64_t)THREADS * SPREAD);
  const int64_t cap = (int64_t)sm_count() * (fit < SC_BPS ? fit : SC_BPS);
  const unsigned blocks = (unsigned)(want < cap ? want : cap);
  // the bulk ring only when each block has SC_BULK_RANGE bytes or more
  const int64_t per = (total + blocks - 1) / blocks;
  const int bulk = SC_BULK > 0 && per * 16 >= SC_BULK_RANGE;
  segments_kernel<Ti, To, SINGLE><<<blocks, THREADS, 0, stream>>>(
      one, table, prefix, n, total, bulk);
  return (int)cudaGetLastError();
}

template <bool SINGLE>
int launch(const Seg& one, const Seg* table, const int64_t* prefix,
           int64_t n_seg, int64_t total, int src_dtype, int dst_dtype,
           cudaStream_t stream) {
  if (total <= 0) return (int)cudaGetLastError();
  const int n = (int)n_seg;
  if (src_dtype == dst_dtype) {
    return launch_as<uint8_t, uint8_t, SINGLE>(one, table, prefix, n, total,
                                               stream);
  } else if (src_dtype == 0 && dst_dtype == 1) {
    return launch_as<float, __nv_bfloat16, SINGLE>(one, table, prefix, n,
                                                   total, stream);
  } else if (src_dtype == 1 && dst_dtype == 0) {
    return launch_as<__nv_bfloat16, float, SINGLE>(one, table, prefix, n,
                                                   total, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// A list of n_seg segments in one launch.  `table` (device memory) holds
// n_seg rows of 8 int64: source address, destination address, rows, cols,
// source row stride, destination row stride (elements of each side's
// dtype; for equal dtypes, bytes), flags (1: both sides' rows start on
// 16-byte boundaries, 2: the source is host memory, 4: the destination
// is), unused.  `prefix` (device memory, n_seg + 1 int64) is the prefix
// sum of the segments' 16-byte source units, rows * ceil(cols / VEC) with
// VEC = 16 / source itemsize, and total_units its last entry.  dtypes:
// 0 = float32, 1 = bfloat16.  Returns cudaGetLastError().
extern "C" int repro_stream_copy_segments(const void* table,
                                          const int64_t* prefix, int64_t n_seg,
                                          int64_t total_units, int src_dtype,
                                          int dst_dtype, void* stream) {
  if (n_seg <= 0 || n_seg > (1ll << 30)) {
    return n_seg == 0 ? 0 : (int)cudaErrorInvalidValue;
  }
  return launch<false>(Seg{}, static_cast<const Seg*>(table), prefix, n_seg,
                       total_units, src_dtype, dst_dtype,
                       static_cast<cudaStream_t>(stream));
}

// A rows x cols slab, each row contiguous: source row stride ss and
// destination row stride ds, in elements (a contiguous slab of n elements
// is rows = 1, cols = n).  dtypes: 0 = float32, 1 = bfloat16; equal dtypes
// copy cols * itemsize bytes a row whatever the element type.  vec = 1 when
// both pointers and both row strides in bytes are multiples of 16, so that
// every row starts on a 16-byte boundary.  One segment of the launch
// above, passed by value.  Returns cudaGetLastError().
extern "C" int repro_stream_copy(const void* src, void* dst, int64_t rows,
                                 int64_t cols, int64_t ss, int64_t ds,
                                 int src_dtype, int dst_dtype, int itemsize,
                                 int vec, void* stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaGetLastError();
  Seg one{static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), rows,
          cols, ss, ds, vec ? SEG_VEC : 0, 0};
  int vec_elems = 16;
  if (src_dtype == dst_dtype) {
    one.cols *= itemsize;
    one.ss *= itemsize;
    one.ds *= itemsize;
  } else if (src_dtype == 0 && dst_dtype == 1) {
    vec_elems = 4;
  } else if (src_dtype == 1 && dst_dtype == 0) {
    vec_elems = 8;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaPointerAttributes attr;
  if (cudaPointerGetAttributes(&attr, src) == cudaSuccess &&
      attr.type == cudaMemoryTypeHost) {
    one.flags |= SEG_SRC_HOST;
  }
  if (cudaPointerGetAttributes(&attr, dst) == cudaSuccess &&
      attr.type == cudaMemoryTypeHost) {
    one.flags |= SEG_DST_HOST;
  }
  cudaGetLastError();  // an unregistered pointer is not an error here
  const int64_t total = rows * ((one.cols + vec_elems - 1) / vec_elems);
  return launch<true>(one, nullptr, nullptr, 1, total, src_dtype, dst_dtype,
                      static_cast<cudaStream_t>(stream));
}

// Blocks of the segment-list kernel an SM holds (the byte copy, or the
// fp32 -> bf16 cast): what the persistent grid is sized by.
extern "C" int repro_stream_copy_blocks_per_sm(int cast) {
  int fit = 0;
  if (cast) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &fit, segments_kernel<float, __nv_bfloat16, false>, THREADS, 0);
  } else {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &fit, segments_kernel<uint8_t, uint8_t, false>, THREADS, 0);
  }
  return fit;
}

// Unified-addressing check for a host or device pointer: writes the
// memory type (cudaMemoryType) and the pointer the device uses for it.
extern "C" int repro_pointer_info(const void* ptr, int* memory_type,
                                  void** device_pointer) {
  cudaPointerAttributes attr;
  cudaError_t err = cudaPointerGetAttributes(&attr, ptr);
  if (err != cudaSuccess) return (int)err;
  *memory_type = (int)attr.type;
  *device_pointer = attr.devicePointer;
  return 0;
}
