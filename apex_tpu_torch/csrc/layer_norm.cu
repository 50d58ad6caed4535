// LayerNorm forward for Hopper (sm_90a).
//
// Replaces: apex_tpu/ops/layer_norm_pallas.py `_ln_fwd_kernel`
// (launcher `layer_norm_fwd_pallas`), forward only, affine LayerNorm.
//
// Computes, per row of x (R, H): mean = sum(x) / H in fp32, then the
// centred variance var = sum((x - mean)^2) / H (two passes, the jnp
// spec in apex_tpu/normalization/fused_layer_norm.py, not a one-pass
// E[x^2] - mean^2), rstd = rsqrt(var + eps), and
// y = (x - mean) * rstd * w + b cast to x's dtype.  mean and rstd are
// written as fp32 (R,).
//
// Bound on the H100: memory bytes.  The row is read once and written
// once (2 * R * H * sizeof(x)); the arithmetic is a few flops per
// element.  At the decode shapes (R = 8, H = 768: 24 KB) the launch
// latency (a few microseconds) is far above the byte time, so the
// kernel is latency-bound there.
//
// Design: one block per row.  The row is read from device memory once
// into shared memory as fp32; both reductions and the epilogue then
// run over shared memory, so the second (centred) pass costs no device
// memory traffic.  Reductions are warp shuffles plus one shared-memory
// step across warps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch and XLA
}

// Sum over the block; every thread gets the result.
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  if (warp == 0) {
    t = lane < (kThreads >> 5) ? red[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (lane == 0) red[0] = t;
  }
  __syncthreads();
  t = red[0];
  __syncthreads();  // red is reused by the next reduction
  return t;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ b, T* __restrict__ y,
              float* __restrict__ mean_out, float* __restrict__ rstd_out,
              int H, float eps) {
  extern __shared__ float row[];  // H floats
  __shared__ float red[kThreads / 32];
  const int64_t r = blockIdx.x;
  const T* xr = x + r * H;
  T* yr = y + r * H;

  float s = 0.f;
  for (int i = threadIdx.x; i < H; i += kThreads) {
    const float v = to_f32(xr[i]);
    row[i] = v;
    s += v;
  }
  const float mean = block_sum(s, red) / (float)H;

  float s2 = 0.f;
  for (int i = threadIdx.x; i < H; i += kThreads) {
    const float c = row[i] - mean;
    s2 += c * c;
  }
  const float var = block_sum(s2, red) / (float)H;
  const float rstd = rsqrtf(var + eps);

  for (int i = threadIdx.x; i < H; i += kThreads) {
    const float xhat = (row[i] - mean) * rstd;
    yr[i] = from_f32<T>(xhat * w[i] + b[i]);
  }
  if (threadIdx.x == 0) {
    mean_out[r] = mean;
    rstd_out[r] = rstd;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and y).  w, b: float32 (H,).
extern "C" int apex_layer_norm_fwd(const void* x, const void* w, const void* b,
                                   void* y, void* mean, void* rstd, int rows,
                                   int hidden, float eps, int dtype,
                                   void* stream) {
  const size_t smem = (size_t)hidden * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    ln_fwd_kernel<float><<<rows, kThreads, smem, st>>>(
        (const float*)x, (const float*)w, (const float*)b, (float*)y,
        (float*)mean, (float*)rstd, hidden, eps);
  } else if (dtype == 1) {
    ln_fwd_kernel<__nv_bfloat16><<<rows, kThreads, smem, st>>>(
        (const __nv_bfloat16*)x, (const float*)w, (const float*)b,
        (__nv_bfloat16*)y, (float*)mean, (float*)rstd, hidden, eps);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
