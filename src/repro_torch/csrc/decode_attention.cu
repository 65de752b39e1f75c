// GQA flash decode for Hopper (sm_90a): one new query token per sequence
// against a KV cache that lies in HBM or in page-locked host memory.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention/kernel.py
// (`decode_attention`, body `_kernel`), which walks KV blocks of `block_t`
// in order on one core, keeps the online-softmax state (m, l, acc) in VMEM
// and skips blocks past `lengths[b]`.  Two entry points share one body:
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
// at G = 12, below the 20 per byte (67 TFLOP/s over 3.35 TB/s) at which
// fp32 arithmetic outside the tensor cores would be the limit.  From HBM
// the bound is 3.35 TB/s; from pinned host memory, read in place through
// unified virtual addressing, it is the PCIe link.
//
// Design:
// * One block of 256 threads per (sequence, KV head, split of T).  The
//   positions of one sequence are cut into `splits` contiguous pieces so
//   that B·K·splits blocks fill the 132 SMs when B·K alone would not; a
//   second small kernel merges the pieces with the same (acc, m, l)
//   algebra (and normalises, in the normalised form).
// * The block walks its positions in tiles of 32.  Each tile's K and V
//   rows are loaded in 16-byte chunks by consecutive threads (coalesced)
//   into registers while the previous tile computes, then staged in
//   shared memory (rows padded by 16 bytes: conflict-free row reads).
//   Scores take one (head, position) pair per thread; the online softmax
//   takes one warp per head and one lane per position, so each exp is
//   computed once; P·V gives each thread four columns of up to two heads.
//   The G heads of a KV head share every K/V byte.
// * A masked position issues no K/V load (its shared row is zeroed) and a
//   tile with no valid position is skipped whole (partial form); in the
//   normalised form positions at or past lengths[b] are never visited.
//   Only a pool's own valid rows cross PCIe.  A sequence with no valid
//   position returns m = -1e30, l = 0, acc = 0 (the plain version returns
//   l = T and the sum of V there; both merge with weight
//   exp(-1e30 - m_all) = 0).
// * Scores are the fp32 dot product (fused multiply-adds, in another
//   order than the reference) divided by sqrt(hd), masked with the finite
//   NEG_INF = -1e30; every reduction runs in a fixed order, so results do
//   not change from run to run.
//
// The same source holds the append scatter of the decode step: one new
// K and V row per sequence, written at a per-sequence row of a pool layer
// (HBM or pinned) with the cast to the pool's dtype fused in; rows out of
// range are dropped.  It replaces the `.at[...].set(mode="drop")` scatter
// of repro/serving/kv_cache.py `append_layer` without a host sync.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int TP = 32;      // positions per tile: one per lane in the softmax
constexpr int MAX_G = 16;   // query heads per KV head

struct Args {
  const float* q;            // (B, H, hd) fp32, contiguous
  const void* k;             // (B, T, K, hd), last dim contiguous
  const void* v;             // same shape and strides as k
  int64_t sb, st, sk;        // element strides of k and v
  const uint8_t* valid;      // (B, T) mask (partial form) or null
  int64_t valid_sb;
  const int32_t* lengths;    // (B,) (normalised form) or null
  int B, T, K, G, splits;
  float* acc;                // (B, K, splits, G, hd)
  float* m;                  // (B, K, splits, G)
  float* l;                  // (B, K, splits, G)
};

// 16 bytes of K or V as floats: 4 fp32 or 8 bf16.
__device__ __forceinline__ void to_float(const uint4& raw, float* out, float) {
  out[0] = __uint_as_float(raw.x); out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z); out[3] = __uint_as_float(raw.w);
}

__device__ __forceinline__ void to_float(const uint4& raw, float* out, __nv_bfloat16) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Four consecutive elements of a V row in shared memory, as floats.
__device__ __forceinline__ void quad(const uint8_t* p, float* out, float) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void quad(const uint8_t* p, float* out, __nv_bfloat16) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}

template <typename KV, int HD>
__global__ void __launch_bounds__(THREADS)
decode_kernel(Args a) {
  constexpr int ROW = HD * (int)sizeof(KV);  // bytes of one K or V row
  constexpr int CH = ROW / 16;               // 16-byte chunks per row
  constexpr int EPC = 16 / (int)sizeof(KV);  // elements per chunk
  constexpr int PITCH = ROW + 16;            // padded: conflict-free row reads
  constexpr int NCH = (TP * CH + THREADS - 1) / THREADS;
  constexpr int QD = HD / 4;                 // quads of one row
  constexpr int NG = THREADS / QD;           // head groups of the P·V pass
  constexpr int JH = (MAX_G + NG - 1) / NG;  // heads per thread in that pass

  __shared__ __align__(16) uint8_t sk[TP * PITCH];
  __shared__ __align__(16) uint8_t sv[TP * PITCH];
  __shared__ __align__(16) float sq[MAX_G * HD];
  __shared__ float sp[MAX_G * TP];
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
    sq[i] = a.q[((int64_t)b * a.K * G + kh * G) * HD + i];
  if (tid < G) { sm[tid] = NEG_INF; sl[tid] = 0.f; }
  const uint8_t* kb = reinterpret_cast<const uint8_t*>(
      static_cast<const KV*>(a.k) + b * a.sb + kh * a.sk);
  const uint8_t* vb = reinterpret_cast<const uint8_t*>(
      static_cast<const KV*>(a.v) + b * a.sb + kh * a.sk);
  const int64_t row_stride = a.st * (int64_t)sizeof(KV);
  const uint8_t* vm = a.valid != nullptr ? a.valid + b * a.valid_sb : nullptr;
  const float sqrt_hd = sqrtf((float)HD);
  const int dq = tid % QD, hg = tid / QD;

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
      if (i < TP * CH) {
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
  for (int base = t0; base < t1; base += TP) {
    __syncthreads();  // the previous tile is done with shared memory
    bool mine = false;
    const uint4 zero = make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int i = tid + j * THREADS;
      if (i < TP * CH) {
        const int p = i / CH, c = i % CH;
        *reinterpret_cast<uint4*>(sk + p * PITCH + c * 16) = rok[j] ? rk[j] : zero;
        *reinterpret_cast<uint4*>(sv + p * PITCH + c * 16) = rok[j] ? rv[j] : zero;
        mine |= rok[j];
      }
    }
    const bool any = __syncthreads_or(mine);
    if (base + TP < t1) fetch(base + TP);
    if (!any) continue;  // a tile with no valid position costs no math

    // scores: one (head, position) pair per thread and step
    for (int i = tid; i < G * TP; i += THREADS) {
      const int g = i / TP, p = i % TP, t = base + p;
      float s = NEG_INF;
      if (t < t1 && (vm == nullptr || vm[t])) {
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          float kf[EPC];
          to_float(*reinterpret_cast<const uint4*>(sk + p * PITCH + c * 16), kf, KV());
#pragma unroll
          for (int e = 0; e < EPC; ++e) dot = fmaf(sq[g * HD + c * EPC + e], kf[e], dot);
        }
        s = dot / sqrt_hd;
      }
      sp[g * TP + p] = s;
    }
    __syncthreads();

    // online softmax over the tile: one warp per head, one lane per position
    for (int g = warp; g < G; g += NWARPS) {
      const float s = sp[g * TP + lane];
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = sm[g];
      const float m_new = fmaxf(m_old, mx);
      const float pv = s == NEG_INF ? 0.f : expf(s - m_new);
      float sum = pv;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      sp[g * TP + lane] = pv;
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
      if (g < G) {
        const float alpha = salpha[g];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] *= alpha;
#pragma unroll 4
        for (int p = 0; p < TP; ++p) {
          const float w = sp[g * TP + p];
          float vf[4];
          quad(sv + p * PITCH + dq * 4 * (int)sizeof(KV), vf, KV());
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = fmaf(w, vf[e], acc[j][e]);
        }
      }
    }
  }
  __syncthreads();

  const int64_t out = ((int64_t)bk * a.splits + split) * G;
#pragma unroll
  for (int j = 0; j < JH; ++j) {
    const int g = hg + j * NG;
    if (g < G) {
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

template <typename KV, int HD>
cudaError_t launch_g(const Args& a, cudaStream_t s) {
  if (a.G < 1 || a.G > MAX_G) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)(a.B * a.K), (unsigned)a.splits);
  decode_kernel<KV, HD><<<grid, THREADS, 0, s>>>(a);
  return cudaSuccess;
}

template <typename KV>
cudaError_t launch_hd(const Args& a, int hd, cudaStream_t s) {
  switch (hd) {
    case 16: return launch_g<KV, 16>(a, s);
    case 32: return launch_g<KV, 32>(a, s);
    case 64: return launch_g<KV, 64>(a, s);
    case 128: return launch_g<KV, 128>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

int run(Args a, int hd, int kv_dtype, float* acc_out, float* m_out, float* l_out,
        float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.B > 0 && a.K > 0) {
    cudaError_t err = kv_dtype == 0 ? launch_hd<float>(a, hd, s)
                    : kv_dtype == 1 ? launch_hd<__nv_bfloat16>(a, hd, s)
                                    : cudaErrorInvalidValue;
    if (err != cudaSuccess) return (int)err;
    if (out != nullptr || a.splits > 1) {
      const int64_t bk = (int64_t)a.B * a.K;
      combine_kernel<<<grid_for(bk * a.G * hd), THREADS, 0, s>>>(
          a.acc, a.m, a.l, bk, a.splits, a.G, hd, acc_out, m_out, l_out, out);
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

// Partial form.  q (B, H, hd) fp32 contiguous; k, v (B, T, K, hd) fp32 or
// bf16 (kv_dtype 0 / 1) with element strides sb, st, sk and a contiguous
// last dim, rows 16-byte (fp32) or 8-byte (bf16) aligned; valid (B, T)
// bytes with row stride valid_sb.  Scratch acc (B, K, splits, G, hd), m
// and l (B, K, splits, G); outputs acc_out (B, H, hd), m_out and l_out
// (B, H).  With splits == 1 the scratch may be the output itself, and no
// merge runs.  hd is 16, 32, 64 or 128 and G = H / K at most 16.
// Returns cudaGetLastError().
extern "C" int repro_decode_attention_partial(
    const float* q, const void* k, const void* v, int kv_dtype, int64_t sb, int64_t st,
    int64_t sk, const uint8_t* valid, int64_t valid_sb, int B, int T, int K, int G,
    int hd, int splits, float* acc, float* m, float* l, float* acc_out, float* m_out,
    float* l_out, void* stream) {
  Args a{q, k, v, sb, st, sk, valid, valid_sb, nullptr, B, T, K, G, splits, acc, m, l};
  return run(a, hd, kv_dtype, acc_out, m_out, l_out, nullptr, stream);
}

// Normalised form: as above with lengths (B,) int32 in place of the mask;
// out (B, H, hd) fp32 gets acc / max(l, 1e-30) (0 where lengths[b] <= 0).
extern "C" int repro_decode_attention(
    const float* q, const void* k, const void* v, int kv_dtype, int64_t sb, int64_t st,
    int64_t sk, const int32_t* lengths, int B, int T, int K, int G, int hd, int splits,
    float* acc, float* m, float* l, float* out, void* stream) {
  Args a{q, k, v, sb, st, sk, nullptr, 0, lengths, B, T, K, G, splits, acc, m, l};
  return run(a, hd, kv_dtype, nullptr, nullptr, nullptr, out, stream);
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
