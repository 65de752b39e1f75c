// Weighted embedding-bag reduction for Hopper (sm_90a):
//     out[b, :] = sum_k w[b, k] * table[idx[b, k], :]
//
// Replaces the Pallas TPU kernel repro/kernels/embedding_reduce/kernel.py
// (`embedding_reduce`, body `_kernel`), which scalar-prefetches the bag's
// row indices and DMAs one table row per grid step into VMEM.
//
// What bounds it: bytes.  Each lookup reads one row (256 B for a 64-wide
// fp32 table) at a random address and does two flops per element, so the
// kernel is bound by random-row read bandwidth: HBM for the fast shard,
// PCIe for the pinned host shard, which the same pointer argument reads in
// place through unified virtual addressing.
//
// Design:
//  * One thread owns a 16-byte vector of columns of one bag and walks k in
//    order, accumulating in fp32 registers, so the sum order is the Pallas
//    body's (and the plain version's) and fp32 results are bit-identical.
//    Multiply and add are separate roundings (__fmul_rn/__fadd_rn, plus
//    --fmad=false at build time): no FMA contraction.
//  * Loads are issued UNROLL lookups ahead of the adds, so every thread
//    keeps UNROLL independent 16-byte row loads in flight to cover the
//    latency of HBM or of the PCIe round trip.
//  * A lookup whose weight is exactly 0 issues no row load.  The tiered
//    container gives every lookup another shard owns weight 0, so the slow
//    shard is only read for the rows it owns.  Skipping the add is exact:
//    the fp32 sum starts at +0.0 and adding +/-0.0 changes nothing for a
//    finite table.
//  * Indices are int32, as the TPU kernel takes them (4 bytes of traffic
//    per lookup, not 8); the wrapper refuses tables of more than 2^31
//    rows.  They are clamped into [0, V) so a stray index cannot fault;
//    the caller clamps already.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int UNROLL = 16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_f32(float x, float* o) { *o = x; }
__device__ __forceinline__ void store_f32(float x, __nv_bfloat16* o) { *o = __float2bfloat16_rn(x); }

// VEC elements of T from p: one 16-byte load when VEC * sizeof(T) == 16.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, T (&v)[VEC]) {
  if constexpr (VEC * sizeof(T) == 16) {
    uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = e[j];
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = p[j];
  }
}

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

template <typename T, int VEC>
__global__ void embedding_reduce_kernel(const T* __restrict__ table,
                                        const int32_t* __restrict__ idx,
                                        const T* __restrict__ w,
                                        T* __restrict__ out,
                                        int64_t V, int64_t D, int64_t B, int64_t K) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
  if (b >= B) return;
  const int64_t n_chunks = D / VEC;
  const int32_t* bidx = idx + b * K;
  const T* bw = w + b * K;
  for (int64_t c = threadIdx.x; c < n_chunks; c += blockDim.x) {
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.0f;
    for (int64_t k0 = 0; k0 < K; k0 += UNROLL) {
      T rows[UNROLL][VEC];
      float wk[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int64_t k = k0 + u;
        wk[u] = k < K ? to_f32(bw[k]) : 0.0f;
        if (wk[u] != 0.0f) {
          int64_t r = bidx[k];
          r = r < 0 ? 0 : (r >= V ? V - 1 : r);
          load_vec<T, VEC>(table + r * D + c * VEC, rows[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (wk[u] != 0.0f) {
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            acc[j] = __fadd_rn(acc[j], __fmul_rn(to_f32(rows[u][j]), wk[u]));
        }
      }
    }
    store_vec<T, VEC>(out + b * D + c * VEC, acc);
  }
}

template <typename T, int VEC>
void launch(const void* table, const int32_t* idx, const void* w, void* out,
            int64_t V, int64_t D, int64_t B, int64_t K, cudaStream_t stream) {
  const int64_t n_chunks = D / VEC;
  int tx = 1;
  while (tx < n_chunks && tx < 128) tx <<= 1;
  const int ty = 128 / tx;
  const dim3 block(tx, ty);
  const dim3 grid((unsigned)((B + ty - 1) / ty));
  embedding_reduce_kernel<T, VEC><<<grid, block, 0, stream>>>(
      static_cast<const T*>(table), idx, static_cast<const T*>(w),
      static_cast<T*>(out), V, D, B, K);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (table, weights and output share it).
// vec: 1 for the scalar path, else 16 bytes per load (the wrapper checks
// D and the pointers' alignment).  Returns cudaGetLastError().
extern "C" int repro_embedding_reduce(const void* table, const int32_t* idx,
                                      const void* w, void* out, int64_t V,
                                      int64_t D, int64_t B, int64_t K,
                                      int dtype, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B > 0 && D > 0) {
    if (dtype == 0) {
      if (vec > 1) launch<float, 4>(table, idx, w, out, V, D, B, K, s);
      else launch<float, 1>(table, idx, w, out, V, D, B, K, s);
    } else if (dtype == 1) {
      if (vec > 1) launch<__nv_bfloat16, 8>(table, idx, w, out, V, D, B, K, s);
      else launch<__nv_bfloat16, 1>(table, idx, w, out, V, D, B, K, s);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
