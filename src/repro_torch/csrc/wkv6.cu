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
// What bounds it: bytes, narrowly.  Per (b, t, h) the kernel reads r, k,
// v (bf16 on the model's path) and w (fp32) and writes y (fp32): 14·hd
// bytes against ~4·hd² fp32 operations (the dot product r·S, the decay
// and rank-1 update of S).  At hd = 64 that is 18 operations per byte,
// below the 20 per byte (67 TFLOP/s over 3.35 TB/s) at which the fp32
// pipes outside the tensor cores would bind.  The state is read once
// and written once per launch, so device-memory traffic is one pass over
// the inputs, as on the TPU.
//
// Design:
// * One block per (b, h); the loop over t inside the block takes the
//   place of the TPU's sequential grid axis, and blocks share nothing.
// * hd threads: thread j keeps column S[:, j] (hd fp32 values) in
//   registers for the whole sequence, so the state never touches shared
//   or device memory between the first read and the last write.
// * Time is staged CT steps at a time: each thread loads element j of r,
//   k, v and w for CT steps (consecutive threads on consecutive elements:
//   coalesced, read in place through the (B, T, H, hd) strides, cast to
//   fp32 on the way into shared memory), then one thread per step forms
//   the bonus sum_i r_i u_i k_i, so a block synchronises three times per
//   CT steps instead of once per step.  Each step then reads r, k, w as
//   shared-memory broadcasts (float4), four partial sums break the
//   dot product's dependence chain, and y is stored coalesced.
// * state_in and state_out may be the same buffer: each thread reads its
//   own column before the loop and writes it after.
//
// Left for later (PERF.md): B·H blocks of hd threads fill 132 SMs only
// at large B·H, and a block waits for each staged chunk; a chunked form
// on `mma` over time, more blocks per (b, h) through a split of the
// v-columns, and a register prefetch of the next chunk are the next steps.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int CT = 16;  // time steps staged per chunk (<= the smallest hd)

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
  int T, H;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }

template <typename RKV, typename WT, int HD>
__global__ void __launch_bounds__(HD) wkv6_kernel(Args a) {
  static_assert(HD % 4 == 0 && CT <= HD, "head dim");
  __shared__ __align__(16) float sr[CT][HD];
  __shared__ __align__(16) float sk[CT][HD];
  __shared__ __align__(16) float sw[CT][HD];
  __shared__ float sv[CT][HD];
  __shared__ float su[HD];
  __shared__ float sbonus[CT];

  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const int j = threadIdx.x;
  const RKV* rp = static_cast<const RKV*>(a.r) + b * a.sb + h * a.sh + j;
  const RKV* kp = static_cast<const RKV*>(a.k) + b * a.sb + h * a.sh + j;
  const RKV* vp = static_cast<const RKV*>(a.v) + b * a.sb + h * a.sh + j;
  const WT* wp = static_cast<const WT*>(a.w) + b * a.wsb + h * a.wsh + j;
  su[j] = a.u[h * HD + j];

  float s[HD];  // column j of the state
  const float* s_in = a.s_in + (int64_t)bh * HD * HD + j;
#pragma unroll
  for (int i = 0; i < HD; ++i) s[i] = s_in[i * HD];

  float* yp = a.y + ((int64_t)b * a.T * a.H + h) * HD + j;
  const int64_t y_st = (int64_t)a.H * HD;

  for (int t0 = 0; t0 < a.T; t0 += CT) {
    const int n = min(CT, a.T - t0);
    __syncthreads();  // the previous chunk is consumed (and su is written)
    for (int c = 0; c < n; ++c) {
      const int64_t t = t0 + c;
      sr[c][j] = ld(rp + t * a.st);
      sk[c][j] = ld(kp + t * a.st);
      sv[c][j] = ld(vp + t * a.st);
      sw[c][j] = ld(wp + t * a.wst);
    }
    __syncthreads();
    if (j < n) {
      // bonus of step j: sum_i r_i u_i k_i, columns rotated by j so that
      // the CT threads hit distinct banks
      float bonus = 0.f;
#pragma unroll 8
      for (int ii = 0; ii < HD; ++ii) {
        const int i = (ii + j) % HD;
        bonus = fmaf(sr[j][i] * su[i], sk[j][i], bonus);
      }
      sbonus[j] = bonus;
    }
    __syncthreads();
    for (int c = 0; c < n; ++c) {
      const float vj = sv[c][j];
      float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
#pragma unroll
      for (int i = 0; i < HD; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&sr[c][i]);
        acc0 = fmaf(r4.x, s[i], acc0);
        acc1 = fmaf(r4.y, s[i + 1], acc1);
        acc2 = fmaf(r4.z, s[i + 2], acc2);
        acc3 = fmaf(r4.w, s[i + 3], acc3);
      }
      yp[(int64_t)(t0 + c) * y_st] = ((acc0 + acc1) + (acc2 + acc3)) + vj * sbonus[c];
#pragma unroll
      for (int i = 0; i < HD; i += 4) {
        const float4 w4 = *reinterpret_cast<const float4*>(&sw[c][i]);
        const float4 k4 = *reinterpret_cast<const float4*>(&sk[c][i]);
        s[i] = fmaf(w4.x, s[i], k4.x * vj);
        s[i + 1] = fmaf(w4.y, s[i + 1], k4.y * vj);
        s[i + 2] = fmaf(w4.z, s[i + 2], k4.z * vj);
        s[i + 3] = fmaf(w4.w, s[i + 3], k4.w * vj);
      }
    }
  }

  float* s_out = a.s_out + (int64_t)bh * HD * HD + j;
#pragma unroll
  for (int i = 0; i < HD; ++i) s_out[i * HD] = s[i];
}

template <typename RKV, typename WT>
cudaError_t launch_hd(const Args& a, int blocks, int hd, cudaStream_t s) {
  switch (hd) {
    case 16: wkv6_kernel<RKV, WT, 16><<<blocks, 16, 0, s>>>(a); break;
    case 32: wkv6_kernel<RKV, WT, 32><<<blocks, 32, 0, s>>>(a); break;
    case 64: wkv6_kernel<RKV, WT, 64><<<blocks, 64, 0, s>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

template <typename RKV>
cudaError_t launch_w(const Args& a, int w_dtype, int blocks, int hd, cudaStream_t s) {
  if (w_dtype == 0) return launch_hd<RKV, float>(a, blocks, hd, s);
  if (w_dtype == 1) return launch_hd<RKV, __nv_bfloat16>(a, blocks, hd, s);
  return cudaErrorInvalidValue;
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
  const Args a{r, k, v, sb, st, sh, w, wsb, wst, wsh, u, s_in, s_out, y, T, H};
  const int blocks = B * H;
  cudaError_t err = rkv_dtype == 0 ? launch_w<float>(a, w_dtype, blocks, hd, s)
                  : rkv_dtype == 1 ? launch_w<__nv_bfloat16>(a, w_dtype, blocks, hd, s)
                                   : cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
