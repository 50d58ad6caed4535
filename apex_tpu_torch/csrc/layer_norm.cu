// LayerNorm and RMSNorm forward and backward for Hopper (sm_90a), with
// or without the affine weight and bias: the Pallas kernels' `rms`,
// `affine` and `with_bias` flags.  `rms` is a runtime flag; a null
// weight means no affine, a null bias no bias.
//
// Forward.  Replaces: apex_tpu/ops/layer_norm_pallas.py `_ln_fwd_kernel`
// (launcher `layer_norm_fwd_pallas`).
//
// Computes, per row of x (R, H): mean = sum(x) / H in fp32, then the
// centred variance var = sum((x - mean)^2) / H (two passes, the jnp
// spec in apex_tpu/normalization/fused_layer_norm.py, not a one-pass
// E[x^2] - mean^2), rstd = rsqrt(var + eps), and
// y = (x - mean) * rstd * w + b cast to x's dtype.  RMS: mean = 0 and
// var = sum(x^2) / H.  Without weight y = (x - mean) * rstd (+ b).
// mean and rstd are written as fp32 (R,).
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
              int H, float eps, int rms) {
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
  const float mean = rms ? 0.f : block_sum(s, red) / (float)H;

  float s2 = 0.f;
  for (int i = threadIdx.x; i < H; i += kThreads) {
    const float c = row[i] - mean;
    s2 += c * c;
  }
  const float var = block_sum(s2, red) / (float)H;
  const float rstd = rsqrtf(var + eps);

  for (int i = threadIdx.x; i < H; i += kThreads) {
    float v = (row[i] - mean) * rstd;
    if (w) v = v * w[i];
    if (b) v = v + b[i];
    yr[i] = from_f32<T>(v);
  }
  if (threadIdx.x == 0) {
    mean_out[r] = mean;
    rstd_out[r] = rstd;
  }
}

// ---------------------------------------------------------------- backward
// Replaces: apex_tpu/ops/layer_norm_pallas.py `_ln_bwd_kernel` (launcher
// `layer_norm_bwd_pallas`); the numerics are `_ln_bwd_jnp` in
// apex_tpu/normalization/fused_layer_norm.py.  Per row, in fp32:
//   xhat = (x - mean) * rstd,  gw = dy * w (dy without weight),
//   m1 = sum(gw) / H,  m2 = sum(gw * xhat) / H,
//   dx = (gw - m1 - xhat * m2) * rstd   (cast to x's dtype),
//   RMS: mean = 0 and dx = (gw - xhat * m2) * rstd,
// and over all rows dw = sum(dy * xhat), db = sum(dy) (fp32), each only
// where the caller gives its partial buffer (affine; db: with a bias).
//
// Bound on the H100: memory bytes.  x and dy are read once, dx written
// once (3 * R * H * sizeof(x)); at R = 8192, H = 768 in bf16 that is
// 37.8 MB, 11.3 us at 3.35 TB/s.
//
// Design: the two stages of apex's cuComputePartGradGammaBeta, with no
// atomics, so the result does not depend on block scheduling.  Stage 1:
// one block per kBwdRows rows; each thread owns the columns tid,
// tid + kThreads, ...; it keeps its columns' xhat and dy for the current
// row, and its columns' running dw/db partial, in shared memory that no
// other thread touches (so only the two row sums need barriers).  The
// block writes its (H,) dw/db partial to a (G, H) buffer.  Stage 2: each
// column sums the G partials in a fixed order (8 strided lanes, then a
// fixed tree), deterministic run to run.
constexpr int kBwdRows = 32;

// Sums a and b over the block; every thread gets both results.
__device__ void block_sum2(float& a, float& b, float* red) {
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  constexpr int kWarps = kThreads >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    red[warp] = a;
    red[kWarps + warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    float ta = lane < kWarps ? red[lane] : 0.f;
    float tb = lane < kWarps ? red[kWarps + lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) {
      ta += __shfl_xor_sync(0xffffffffu, ta, o);
      tb += __shfl_xor_sync(0xffffffffu, tb, o);
    }
    if (lane == 0) {
      red[2 * kWarps] = ta;
      red[2 * kWarps + 1] = tb;
    }
  }
  __syncthreads();
  a = red[2 * kWarps];
  b = red[2 * kWarps + 1];
  __syncthreads();  // red is reused by the next row
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
              const T* __restrict__ dy, const float* __restrict__ mean,
              const float* __restrict__ rstd, T* __restrict__ dx,
              float* __restrict__ part_w, float* __restrict__ part_b, int R,
              int H, int rms) {
  extern __shared__ float sm[];  // xhat, dy, dw partial, db partial: 4 * H
  float* s_xhat = sm;
  float* s_dy = sm + H;
  float* s_dw = sm + 2 * H;
  float* s_db = sm + 3 * H;
  __shared__ float red[2 * (kThreads / 32) + 2];
  for (int i = threadIdx.x; i < H; i += kThreads) {
    s_dw[i] = 0.f;
    s_db[i] = 0.f;
  }
  const int r_end = min(R, (int)(blockIdx.x + 1) * kBwdRows);
  for (int r = blockIdx.x * kBwdRows; r < r_end; ++r) {
    const T* xr = x + (int64_t)r * H;
    const T* gr = dy + (int64_t)r * H;
    const float mu = rms ? 0.f : mean[r], rs = rstd[r];
    float s1 = 0.f, s2 = 0.f;
    for (int i = threadIdx.x; i < H; i += kThreads) {
      const float xhat = (to_f32(xr[i]) - mu) * rs;
      const float g = to_f32(gr[i]);
      const float gw = w ? g * w[i] : g;
      s_xhat[i] = xhat;
      s_dy[i] = g;
      s1 += gw;
      s2 += gw * xhat;
    }
    block_sum2(s1, s2, red);
    const float m1 = s1 / (float)H, m2 = s2 / (float)H;
    T* dxr = dx + (int64_t)r * H;
    for (int i = threadIdx.x; i < H; i += kThreads) {
      const float xhat = s_xhat[i], g = s_dy[i];
      const float gw = w ? g * w[i] : g;
      dxr[i] = from_f32<T>((rms ? gw - xhat * m2 : gw - m1 - xhat * m2) * rs);
      s_dw[i] += g * xhat;
      s_db[i] += g;
    }
  }
  for (int i = threadIdx.x; i < H; i += kThreads) {
    if (part_w) part_w[(int64_t)blockIdx.x * H + i] = s_dw[i];
    if (part_b) part_b[(int64_t)blockIdx.x * H + i] = s_db[i];
  }
}

// dw[c] = sum_g part_w[g, c], db likewise (where db is given); 32
// columns x 8 lanes a block.
__global__ void __launch_bounds__(256)
ln_bwd_reduce_kernel(const float* __restrict__ part_w,
                     const float* __restrict__ part_b, float* __restrict__ dw,
                     float* __restrict__ db, int G, int H) {
  __shared__ float sw[8][33], sb[8][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + tx;
  float aw = 0.f, ab = 0.f;
  if (c < H) {
    for (int g = ty; g < G; g += 8) {
      aw += part_w[(int64_t)g * H + c];
      if (db) ab += part_b[(int64_t)g * H + c];
    }
  }
  sw[ty][tx] = aw;
  sb[ty][tx] = ab;
  __syncthreads();
  if (ty == 0 && c < H) {
    float tw = 0.f, tb = 0.f;
    for (int k = 0; k < 8; ++k) {
      tw += sw[k][tx];
      tb += sb[k][tx];
    }
    dw[c] = tw;
    if (db) db[c] = tb;
  }
}

template <typename T>
cudaError_t launch_ln_bwd(const void* x, const void* w, const void* dy,
                          const void* mean, const void* rstd, void* dx,
                          void* part_w, void* part_b, int R, int H, int G, int rms,
                          cudaStream_t st) {
  const size_t smem = 4 * (size_t)H * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ln_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  ln_bwd_kernel<T><<<G, kThreads, smem, st>>>(
      (const T*)x, (const float*)w, (const T*)dy, (const float*)mean,
      (const float*)rstd, (T*)dx, (float*)part_w, (float*)part_b, R, H, rms);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and y).  w, b: float32 (H,), or
// null for none.  rms: 1 = RMSNorm (mean written as 0).
extern "C" int apex_layer_norm_fwd(const void* x, const void* w, const void* b,
                                   void* y, void* mean, void* rstd, int rows,
                                   int hidden, float eps, int rms, int dtype,
                                   void* stream) {
  const size_t smem = (size_t)hidden * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    ln_fwd_kernel<float><<<rows, kThreads, smem, st>>>(
        (const float*)x, (const float*)w, (const float*)b, (float*)y,
        (float*)mean, (float*)rstd, hidden, eps, rms);
  } else if (dtype == 1) {
    ln_fwd_kernel<__nv_bfloat16><<<rows, kThreads, smem, st>>>(
        (const __nv_bfloat16*)x, (const float*)w, (const float*)b,
        (__nv_bfloat16*)y, (float*)mean, (float*)rstd, hidden, eps, rms);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Number of row blocks, G: the rows of the (G, H) dw/db partial buffers
// the caller allocates for apex_layer_norm_bwd.
extern "C" int apex_layer_norm_bwd_blocks(int rows) {
  return (rows + kBwdRows - 1) / kBwdRows;
}

// dtype: 0 = float32, 1 = bfloat16 (x, dy and dx).  w, mean, rstd, the
// partials, dw and db: float32.  w null: no affine (part_w, part_b, dw,
// db null too); part_b and db null: no bias.  rms: 1 = RMSNorm (mean is
// not read).  Launches stage 1, and stage 2 when there is a weight.
extern "C" int apex_layer_norm_bwd(const void* x, const void* w, const void* dy,
                                   const void* mean, const void* rstd, void* dx,
                                   void* part_w, void* part_b, void* dw,
                                   void* db, int rows, int hidden, int rms,
                                   int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int G = apex_layer_norm_bwd_blocks(rows);
  cudaError_t e;
  if (dtype == 0) {
    e = launch_ln_bwd<float>(x, w, dy, mean, rstd, dx, part_w, part_b, rows,
                             hidden, G, rms, st);
  } else if (dtype == 1) {
    e = launch_ln_bwd<__nv_bfloat16>(x, w, dy, mean, rstd, dx, part_w, part_b,
                                     rows, hidden, G, rms, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess || !w) return (int)e;
  ln_bwd_reduce_kernel<<<(hidden + 31) / 32, 256, 0, st>>>(
      (const float*)part_w, (const float*)part_b, (float*)dw, (float*)db, G,
      hidden);
  return (int)cudaGetLastError();
}
