// MEMO's measure-mode probes for Hopper (sm_90a): sequential loads and
// stores over lanes, random-block loads and a dependent pointer chase,
// each over HBM or over page-locked host memory read in place through
// unified virtual addressing.
//
// Replaces the jitted XLA programs of repro/core/memo.py (`_seq_load`,
// `_seq_store`, `_random_block_load`, `_pointer_chase`), which have no
// device-side loop in PyTorch and no way to make the card read pinned
// host memory through an op.  `_seq_copy` needs no body here: the port
// times its stream_copy kernel.  No TPU kernel is replaced.
//
// What bounds it: the memory system, on purpose.  Each probe does one
// add a loaded element (the loads must not be dropped) and is built to
// show one property of the memory it reads:
// * seq_load: one block (a "lane") streams its contiguous slice with
//   16-byte loads, U of them in flight a thread before any add, and
//   writes the lane's fp32 sum.  A lane's rate is the bytes it keeps in
//   flight over the latency; the lane sweep finds where the tier stops
//   scaling (peak streams) and whether it falls after (collapse).
// * seq_store: one block a lane writes v[lane] over its slice with
//   16-byte stores.
// * random_block_load: one block a lane of starts visits its blocks in
//   order, each block read like a slice above; a block's loads issue
//   only after the previous block's have been added, so each block pays
//   one round trip (at 1 KiB, 64 threads of one 16-byte load), which is
//   what memo's latency fit inverts.  A start is placed as
//   lax.dynamic_slice places it: a negative one counts from the end,
//   then it is clamped into the table.
// * pointer_chase: one thread makes `steps` dependent loads p = perm[p]
//   from a given start (the reference starts at 0) with ld.global.cg, which bypasses L1 (each hop would otherwise be
//   free to hit a line an earlier hop brought in); L2 may still hold a
//   line, which a table several times the 50 MB L2 makes rare.
// Loads from host memory are ld.global.ca, from HBM ld.global.nc, the
// flavours stream_copy measured fastest (.cg reads pinned memory at a
// third of .ca's rate).  Every sum is fp32 in the thread's order, then
// across the block; a sum of integers below 2^24 is exact in any order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;  // 4 blocks an SM: 528 lanes fill the card once
constexpr int U = 4;          // 16-byte loads a thread keeps in flight
constexpr int STAGE = 2048;   // starts a block stages in shared memory

template <bool HOST>
__device__ __forceinline__ float4 load16(const float4* p) {
  float4 v;
  if constexpr (HOST) {
    asm volatile("ld.global.ca.v4.f32 {%0,%1,%2,%3}, [%4];"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
  } else {
    asm volatile("ld.global.nc.v4.f32 {%0,%1,%2,%3}, [%4];"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
  }
  return v;
}

__device__ __forceinline__ float add4(float4 v) {
  return (v.x + v.y) + (v.z + v.w);
}

// Elements before the first 16-byte boundary of p (p is 4-byte aligned).
__device__ __forceinline__ int64_t head_elems(const float* p, int64_t n) {
  const int64_t h = ((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) / 4;
  return h < n ? h : n;
}

// This thread's share of the sum of p[0, n): scalar head and tail, the
// aligned body in 16-byte loads, U in flight before their adds.
template <bool HOST>
__device__ __forceinline__ float sum_range(const float* p, int64_t n) {
  float acc = 0.f;
  const int64_t head = head_elems(p, n);
  const int64_t nvec = (n - head) / 4;
  const float4* v = reinterpret_cast<const float4*>(p + head);
  if (threadIdx.x < head) acc += p[threadIdx.x];
  int64_t i = threadIdx.x;
  for (; i + (U - 1) * THREADS < nvec; i += U * THREADS) {
    float4 r[U];
#pragma unroll
    for (int u = 0; u < U; ++u) r[u] = load16<HOST>(v + i + u * THREADS);
#pragma unroll
    for (int u = 0; u < U; ++u) acc += add4(r[u]);
  }
  for (; i < nvec; i += THREADS) acc += add4(load16<HOST>(v + i));
  for (int64_t j = head + nvec * 4 + threadIdx.x; j < n; j += THREADS) {
    acc += p[j];
  }
  return acc;
}

// The block's sum, valid in thread 0.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float part[THREADS / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  if (l == 0) part[w] = v;
  __syncthreads();
  v = 0.f;
  if (w == 0) {
    v = l < THREADS / 32 ? part[l] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  }
  return v;
}

template <bool HOST>
__global__ void __launch_bounds__(THREADS)
    seq_load_kernel(const float* x, int64_t per_lane, float* out) {
  const float acc = sum_range<HOST>(x + blockIdx.x * per_lane, per_lane);
  const float total = block_sum(acc);
  if (threadIdx.x == 0) out[blockIdx.x] = total;
}

__global__ void __launch_bounds__(THREADS)
    seq_store_kernel(float* x, int64_t per_lane, const float* v) {
  const float val = v[blockIdx.x];
  float* p = x + blockIdx.x * per_lane;
  const int64_t head = head_elems(p, per_lane);
  const int64_t nvec = (per_lane - head) / 4;
  float4* q = reinterpret_cast<float4*>(p + head);
  const float4 w = make_float4(val, val, val, val);
  if (threadIdx.x < head) p[threadIdx.x] = val;
  for (int64_t i = threadIdx.x; i < nvec; i += THREADS) q[i] = w;
  for (int64_t j = head + nvec * 4 + threadIdx.x; j < per_lane;
       j += THREADS) {
    p[j] = val;
  }
}

template <bool HOST>
__global__ void __launch_bounds__(THREADS)
    random_block_kernel(const float* x, int64_t n, const int32_t* starts,
                        int64_t per_lane, int64_t block_elems, float* out) {
  __shared__ int64_t st[STAGE];
  const int32_t* s = starts + blockIdx.x * per_lane;
  const int64_t hi = n - block_elems;
  float acc = 0.f;
#pragma unroll 1
  for (int64_t b0 = 0; b0 < per_lane; b0 += STAGE) {
    const int cnt = (int)(per_lane - b0 < STAGE ? per_lane - b0 : STAGE);
    __syncthreads();
#pragma unroll 1
    for (int i = threadIdx.x; i < cnt; i += THREADS) {
      int64_t a = s[b0 + i];
      a = a < 0 ? a + n : a;
      st[i] = a < 0 ? 0 : (a > hi ? hi : a);
    }
    __syncthreads();
#pragma unroll 1
    for (int b = 0; b < cnt; ++b) acc += sum_range<HOST>(x + st[b], block_elems);
  }
  const float total = block_sum(acc);
  if (threadIdx.x == 0) out[blockIdx.x] = total;
}

__global__ void pointer_chase_kernel(const int32_t* perm, int32_t start,
                                     int64_t steps, int32_t* out) {
  int32_t p = start;
#pragma unroll 1
  for (int64_t i = 0; i < steps; ++i) {
    asm volatile("ld.global.cg.s32 %0, [%1];" : "=r"(p) : "l"(perm + p));
  }
  *out = p;
}

}  // namespace

// Each lane's fp32 sum of its slice: x holds lanes * per_lane floats,
// lane l reads x[l * per_lane, (l + 1) * per_lane) into out[l].  host = 1
// when x is page-locked host memory.  Returns cudaGetLastError().
extern "C" int repro_memo_seq_load(const float* x, int64_t per_lane,
                                   int lanes, int host, float* out,
                                   void* stream) {
  if (lanes < 1 || per_lane < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (host) {
    seq_load_kernel<true><<<lanes, THREADS, 0, s>>>(x, per_lane, out);
  } else {
    seq_load_kernel<false><<<lanes, THREADS, 0, s>>>(x, per_lane, out);
  }
  return (int)cudaGetLastError();
}

// x[l * per_lane, (l + 1) * per_lane) = v[l] for every lane l, in place.
extern "C" int repro_memo_seq_store(float* x, int64_t per_lane, int lanes,
                                    const float* v, void* stream) {
  if (lanes < 1 || per_lane < 1) return (int)cudaErrorInvalidValue;
  seq_store_kernel<<<lanes, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, per_lane, v);
  return (int)cudaGetLastError();
}

// out[l] = sum over b of x[s, s + block_elems) with s = starts[l *
// per_lane + b] (plus n if negative) clamped into [0, n - block_elems];
// x holds n floats.
extern "C" int repro_memo_random_block_load(const float* x, int64_t n,
                                            const int32_t* starts,
                                            int64_t per_lane, int lanes,
                                            int64_t block_elems, int host,
                                            float* out, void* stream) {
  if (lanes < 1 || per_lane < 1 || block_elems < 1 || block_elems > n) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (host) {
    random_block_kernel<true><<<lanes, THREADS, 0, s>>>(
        x, n, starts, per_lane, block_elems, out);
  } else {
    random_block_kernel<false><<<lanes, THREADS, 0, s>>>(
        x, n, starts, per_lane, block_elems, out);
  }
  return (int)cudaGetLastError();
}

// p = perm[p], steps times from p = start, by one thread; *out = the
// last p.  perm must hold indices into itself.
extern "C" int repro_memo_pointer_chase(const int32_t* perm, int start,
                                        int64_t steps, int32_t* out,
                                        void* stream) {
  if (steps < 0 || start < 0) return (int)cudaErrorInvalidValue;
  pointer_chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      perm, start, steps, out);
  return (int)cudaGetLastError();
}
