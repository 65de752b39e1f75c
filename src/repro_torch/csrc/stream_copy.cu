// Streaming copy with a fused dtype cast for Hopper (sm_90a):
//     dst[i] = cast(src[i]) over a contiguous slab of n elements.
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
// The slab may be row-strided (N rows of M contiguous elements, each side
// with its own row stride): one layer-row of a KV page run, or a run of
// rows inside a pool, moves without a gather.
//
// Design: along each row (blockIdx.y), a grid-stride loop in which each
// thread moves 16-byte vectors (the widest single load and store), so a
// warp touches 512 contiguous bytes per step; any element count works, the
// ragged end goes through a scalar tail.  A contiguous slab is one row.  The cast rounds fp32 to bf16 to nearest even
// (__float2bfloat16_rn, as PyTorch's .to does) and widens bf16 to fp32
// exactly.  The TPU kernel's VMEM staging pipeline has no counterpart:
// the loads of many resident warps keep enough bytes in flight.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float cvt_f32(float x) { return x; }
__device__ __forceinline__ float cvt_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void put(float x, float* o) { *o = x; }
__device__ __forceinline__ void put(float x, __nv_bfloat16* o) { *o = __float2bfloat16_rn(x); }

// Every kernel walks rows r = blockIdx.y, blockIdx.y + gridDim.y, ... of a
// row-strided slab (row r of the source starts ss units after row r-1, of
// the destination ds units; a contiguous slab is one row) and, within a
// row, runs a grid-stride loop over blockIdx.x.

// Same dtype: a byte copy in 16-byte vectors plus a byte tail.
__global__ void copy_bytes_kernel(const uint8_t* __restrict__ src,
                                  uint8_t* __restrict__ dst, int64_t rows,
                                  int64_t n_bytes, int64_t ss, int64_t ds,
                                  int vec) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    const uint8_t* s = src + r * ss;
    uint8_t* d = dst + r * ds;
    int64_t done = 0;
    if (vec) {
      const int64_t n_vec = n_bytes / 16;
      const uint4* sv = reinterpret_cast<const uint4*>(s);
      uint4* dv = reinterpret_cast<uint4*>(d);
      for (int64_t i = tid; i < n_vec; i += stride) dv[i] = sv[i];
      done = n_vec * 16;
    }
    for (int64_t i = done + tid; i < n_bytes; i += stride) d[i] = s[i];
  }
}

// Cast: VEC elements per step, sized so the wider side moves 16 bytes.
template <typename Ti, typename To, int VEC>
__global__ void cast_kernel(const Ti* __restrict__ src, To* __restrict__ dst,
                            int64_t rows, int64_t n, int64_t ss, int64_t ds,
                            int vec) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    const Ti* s = src + r * ss;
    To* d = dst + r * ds;
    int64_t done = 0;
    if (vec) {
      const int64_t n_vec = n / VEC;
      for (int64_t i = tid; i < n_vec; i += stride) {
        alignas(16) Ti in[VEC];
        alignas(16) To out[VEC];
        if constexpr (VEC * sizeof(Ti) == 16) {
          *reinterpret_cast<uint4*>(in) = reinterpret_cast<const uint4*>(s)[i];
        } else {
          *reinterpret_cast<uint2*>(in) = reinterpret_cast<const uint2*>(s)[i];
        }
#pragma unroll
        for (int j = 0; j < VEC; ++j) put(cvt_f32(in[j]), &out[j]);
        if constexpr (VEC * sizeof(To) == 16) {
          reinterpret_cast<uint4*>(d)[i] = *reinterpret_cast<const uint4*>(out);
        } else if constexpr (VEC * sizeof(To) == 32) {
          reinterpret_cast<uint4*>(d)[2 * i] = reinterpret_cast<const uint4*>(out)[0];
          reinterpret_cast<uint4*>(d)[2 * i + 1] = reinterpret_cast<const uint4*>(out)[1];
        } else {
          reinterpret_cast<uint2*>(d)[i] = *reinterpret_cast<const uint2*>(out);
        }
      }
      done = n_vec * VEC;
    }
    for (int64_t i = done + tid; i < n; i += stride) put(cvt_f32(s[i]), &d[i]);
  }
}

dim3 grid_for(int64_t work_per_row, int64_t rows) {
  int64_t blocks = (work_per_row + THREADS - 1) / THREADS;
  if (blocks > 132 * 16) blocks = 132 * 16;
  return dim3((unsigned)(blocks < 1 ? 1 : blocks),
              (unsigned)(rows < 65535 ? rows : 65535));
}

}  // namespace

// A rows x cols slab, each row contiguous: source row stride ss and
// destination row stride ds, in elements (a contiguous slab of n elements
// is rows = 1, cols = n).  dtypes: 0 = float32, 1 = bfloat16; equal dtypes
// copy cols * itemsize bytes a row whatever the element type.  vec = 1 when
// both pointers and both row strides in bytes are multiples of 16, so that
// every row starts on a 16-byte boundary.  Returns cudaGetLastError().
extern "C" int repro_stream_copy(const void* src, void* dst, int64_t rows,
                                 int64_t cols, int64_t ss, int64_t ds,
                                 int src_dtype, int dst_dtype, int itemsize,
                                 int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows > 0 && cols > 0) {
    if (src_dtype == dst_dtype) {
      const int64_t n_bytes = cols * itemsize;
      copy_bytes_kernel<<<grid_for(vec ? n_bytes / 16 : n_bytes, rows), THREADS, 0, s>>>(
          static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), rows, n_bytes,
          ss * itemsize, ds * itemsize, vec);
    } else if (src_dtype == 0 && dst_dtype == 1) {
      cast_kernel<float, __nv_bfloat16, 4><<<grid_for(vec ? cols / 4 : cols, rows), THREADS, 0, s>>>(
          static_cast<const float*>(src), static_cast<__nv_bfloat16*>(dst), rows, cols, ss, ds,
          vec);
    } else if (src_dtype == 1 && dst_dtype == 0) {
      cast_kernel<__nv_bfloat16, float, 8><<<grid_for(vec ? cols / 8 : cols, rows), THREADS, 0, s>>>(
          static_cast<const __nv_bfloat16*>(src), static_cast<float*>(dst), rows, cols, ss, ds,
          vec);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
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
