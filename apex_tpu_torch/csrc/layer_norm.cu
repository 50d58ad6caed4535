// LayerNorm and RMSNorm forward and backward for Hopper (sm_90a), with
// or without the affine weight and bias: the Pallas kernels' `rms`,
// `affine` and `with_bias` flags.  `rms` is a runtime flag; a null
// weight means no affine, a null bias no bias.
//
// Replaces: apex_tpu/ops/layer_norm_pallas.py `_ln_fwd_kernel` (launcher
// `layer_norm_fwd_pallas`) and `_ln_bwd_kernel` (`layer_norm_bwd_pallas`).
//
// Forward, per row of x (R, H): mean = sum(x) / H in fp32, then the
// centred variance var = sum((x - mean)^2) / H (two passes, the jnp spec
// in apex_tpu/normalization/fused_layer_norm.py, not a one-pass
// E[x^2] - mean^2), rstd = rsqrt(var + eps), and
// y = (x - mean) * rstd * w + b cast to x's dtype.  RMS: mean = 0 and
// var = sum(x^2) / H.  Without weight y = (x - mean) * rstd (+ b).
// mean and rstd are written as fp32 (R,).
//
// Backward (`_ln_bwd_jnp` / `_rms_bwd_jnp`), per row in fp32:
//   xhat = (x - mean) * rstd,  gw = dy * w (dy without weight),
//   m1 = sum(gw) / H,  m2 = sum(gw * xhat) / H,
//   dx = (gw - m1 - xhat * m2) * rstd   (cast to x's dtype),
//   RMS: mean = 0 and dx = (gw - xhat * m2) * rstd,
// and over all rows dw = sum(dy * xhat), db = sum(dy) (fp32), each only
// where the caller gives its partial buffer (affine; db: with a bias).
//
// Bound on the H100: memory bytes.  The forward reads x once and writes
// y once (2 * R * H * sizeof(x)), the backward reads x and dy and writes
// dx (3 * R * H * sizeof(x): 37.8 MB, 11.3 us at 3.35 TB/s for R = 8192,
// H = 768 in bf16); the arithmetic is a few flops an element.  At the
// decode shapes (R = 8, H = 768: 24 KB) the launch latency is far above
// the byte time.
//
// Two paths, chosen by shape alone (ln_plan below; ops/layer_norm.py
// `ln_plan` states the same and chip_smoke.py holds the two equal):
//
// Fast path (H a multiple of 8 for bf16 or 4 for fp32, at most 1024
// 16-byte vectors a row, x, dy, y, dx, w and b 16-byte aligned).  A row
// group of WR warps (1 up to 128 vectors a row, 1024 bf16 values, then 2,
// 4, 8) owns a row; lane l of it holds the row's 16-byte vectors l, l + 32 WR, ... in
// registers (NVL <= 4 of them, a template parameter; H = 768 and 1024 are
// compile-time widths), so a warp's loads and stores are contiguous
// 16-byte accesses.  The row sums are xor-shuffle butterflies (every lane
// gets the same value), then, for WR > 1, the WR warps' sums added in
// warp order through shared memory behind a named barrier of the group's
// own.  No block barrier a row, and the centred second pass reads
// registers.
//   Forward: a block holds LnFwdTiles::kWarps / WR rows (one at least),
//   one a row group.
//   Backward stage 1: a block holds kWarps / WR row groups (one at
//   least); group g walks rows base + g, base + g + groups, ..., so that
//   a block walks kWarps * kRowsWarp rows at every WR.  A group issues
//   the next row's loads before this row's sums (two rows in flight a
//   warp) and keeps its columns' dw/db partials in registers.  At the end
//   the groups' partials are added in group order through shared memory
//   and the block writes one (H,) row of partials.  The number of blocks
//   G = ceil(R / 32) depends on R alone, as on the general path, never
//   on the card, so dx, dw and db are bitwise the same run to run.
//   Stage 2 (`ln_bwd_reduce_vec`) sums each column's G partials in a
//   fixed order with 16-byte loads.
//
// General path (every other H up to MAX_HIDDEN, any alignment): one
// 256-thread block a row (forward) or 32 rows (backward), scalar loads,
// the row staged in shared memory; see its kernels below.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

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

// ============================================================ general path
// Forward: one block of kThreads a row; the row is read once into shared
// memory as fp32, both reductions and the epilogue run over shared
// memory (warp shuffles plus one shared-memory step across warps).

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

// Backward, general path: the two stages of apex's
// cuComputePartGradGammaBeta.  Stage 1: one block per kBwdRows rows; each
// thread owns the columns tid, tid + kThreads, ...; it keeps its columns'
// xhat and dy for the current row, and its columns' running dw/db
// partial, in shared memory that no other thread touches (so only the two
// row sums need barriers).  The block writes its (H,) dw/db partial to a
// (G, H) buffer.  Stage 2: each column sums the G partials in a fixed
// order (8 strided lanes, then a fixed tree).
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


// ============================================================ fast path
// The tile plan.  `python -m apex_tpu_torch.ln_tiles` builds this file
// with other values of these constants and times them in turns; the
// values here were the fastest at R = 8192, H = 768 bf16 on an H100
// (PERF.md).  The backward's partials hold 2 * NVL * E registers a lane
// (48 at H = 768 bf16, 167 registers in all): 4-warp blocks with no
// register cap keep 3 blocks an SM resident without a spill, where a
// cap of 128 spills and runs slower.  ops/layer_norm.py holds the same.
struct LnFwdTiles {
  static constexpr int kWarps = 8;  // warps a block
};
struct LnBwdTiles {
  static constexpr int kWarps = 4;         // warps a block
  static constexpr int kRowsWarp = 8;      // rows a block walks, per warp of kWarps
  static constexpr bool kPrefetch = true;  // next row's loads before this row's sums
  static constexpr int kMinBlocks = 1;     // blocks an SM asked of ptxas (a register cap)
};
constexpr int kMaxVectors = 4;   // 16-byte vectors a lane holds, at most
constexpr int kMaxWarpsRow = 8;  // warps a row, at most
constexpr int kReduceLanes = 64;  // row lanes of a stage-2 block (4 column quads each)

// Warps a row for a row of nv 16-byte vectors: the fewest (1, 2, 4, 8)
// that leave a lane at most kMaxVectors of them; > kMaxWarpsRow: too wide.
__host__ __device__ constexpr int row_warps(int nv) {
  int wr = 1;
  while (wr <= kMaxWarpsRow && nv > 32 * wr * kMaxVectors) wr *= 2;
  return wr;
}
__host__ __device__ constexpr int lane_vectors(int nv, int wr) {
  return (nv + 32 * wr - 1) / (32 * wr);
}
// Row groups of WR warps in a block of `warps` warps (one at least).
__host__ __device__ constexpr int row_groups(int warps, int wr) {
  return warps > wr ? warps / wr : 1;
}

// The 16 / sizeof(T) values of one 16-byte vector, as fp32 and back.
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int kE = 4;
  __device__ __forceinline__ static void unpack(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int kE = 8;
  __device__ __forceinline__ static void unpack(const uint4& v, float* f) {
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(u[i] << 16);
      f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static uint32_t pack2(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // round to nearest even
    return *reinterpret_cast<uint32_t*>(&h);
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                      pack2(f[6], f[7]));
  }
};

__device__ __forceinline__ uint4 ld16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// Multiplies f[0..E) by w[c..c+E) (and adds b[c..c+E) with add) by float4.
template <int E>
__device__ __forceinline__ void times4(float* f, const float* __restrict__ w, int c) {
#pragma unroll
  for (int q = 0; q < E / 4; ++q) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(w + c) + q);
    f[4 * q] *= t.x;
    f[4 * q + 1] *= t.y;
    f[4 * q + 2] *= t.z;
    f[4 * q + 3] *= t.w;
  }
}
template <int E>
__device__ __forceinline__ void plus4(float* f, const float* __restrict__ b, int c) {
#pragma unroll
  for (int q = 0; q < E / 4; ++q) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(b + c) + q);
    f[4 * q] += t.x;
    f[4 * q + 1] += t.y;
    f[4 * q + 2] += t.z;
    f[4 * q + 3] += t.w;
  }
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Sums over a row group of WR warps; every lane of the group gets the
// same value: a butterfly in each warp, then (WR > 1) the warps' sums in
// warp order through shared memory behind the group's named barrier
// (1 + group; 0 is __syncthreads').  SLOT tells apart the calls of one
// kernel, each with its own buffer; PAIR sums a and b together, with the
// buffer doubled by row parity so that a warp's next row cannot overwrite
// a sum another warp of the group has yet to read.
template <int WR, int NG, int SLOT, bool PAIR>
__device__ __forceinline__ void group_sum(float& a, float& b, int group, int wr, int parity) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    if (PAIR) b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  if constexpr (WR > 1) {
    __shared__ float2 red[PAIR ? 2 : 1][NG][WR];
    float2* r = red[PAIR ? parity : 0][group];
    if ((threadIdx.x & 31) == 0) r[wr] = make_float2(a, b);
    bar_sync(1 + group, 32 * WR);
    float2 t = r[0];
#pragma unroll
    for (int i = 1; i < WR; ++i) {
      t.x += r[i].x;
      if (PAIR) t.y += r[i].y;
    }
    a = t.x;
    b = t.y;
  }
}

template <typename T, int WR, int NVL, int HC>
__global__ void __launch_bounds__(row_groups(LnFwdTiles::kWarps, WR) * WR * 32)
ln_fwd_warp(const T* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ b, T* __restrict__ y,
            float* __restrict__ mean_out, float* __restrict__ rstd_out, int R,
            int H_arg, float eps, int rms) {
  using V = Vec16<T>;
  constexpr int E = V::kE, NG = row_groups(LnFwdTiles::kWarps, WR);
  // every lane's every vector lies in the row: no bounds test
  constexpr bool kFull = HC > 0 && HC / E == 32 * WR * NVL;
  const int H = HC > 0 ? HC : H_arg, NV = H / E;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = warp / WR, wr = warp % WR, gl = wr * 32 + lane;
  const int64_t r = (int64_t)blockIdx.x * NG + group;
  if (r >= R) return;  // the whole row group leaves together
  const T* xr = x + r * H;
  float v[NVL][E];
#pragma unroll
  for (int k = 0; k < NVL; ++k) {
    const int vi = gl + 32 * WR * k;
    if (kFull || vi < NV) {
      V::unpack(ld16(xr + vi * E), v[k]);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) v[k][e] = 0.f;
    }
  }
  float mean = 0.f, unused = 0.f;
  if (!rms) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < NVL; ++k)
#pragma unroll
      for (int e = 0; e < E; ++e) s += v[k][e];  // zeros past the row add nothing
    group_sum<WR, NG, 0, false>(s, unused, group, wr, 0);
    mean = s / (float)H;
  }
  float s2 = 0.f;
#pragma unroll
  for (int k = 0; k < NVL; ++k) {
    if (kFull || gl + 32 * WR * k < NV) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float c = v[k][e] - mean;
        s2 += c * c;
      }
    }
  }
  group_sum<WR, NG, 1, false>(s2, unused, group, wr, 0);
  const float rstd = rsqrtf(s2 / (float)H + eps);
  T* yr = y + r * H;
#pragma unroll
  for (int k = 0; k < NVL; ++k) {
    const int vi = gl + 32 * WR * k;
    if (kFull || vi < NV) {
      float o[E];
#pragma unroll
      for (int e = 0; e < E; ++e) o[e] = (v[k][e] - mean) * rstd;
      if (w) times4<E>(o, w, vi * E);
      if (b) plus4<E>(o, b, vi * E);
      *reinterpret_cast<uint4*>(yr + vi * E) = V::pack(o);
    }
  }
  if (gl == 0) {
    mean_out[r] = mean;
    rstd_out[r] = rstd;
  }
}

template <typename T, int WR, int NVL, int HC>
__global__ void __launch_bounds__(row_groups(LnBwdTiles::kWarps, WR) * WR * 32,
                                  LnBwdTiles::kMinBlocks)
ln_bwd_warp(const T* __restrict__ x, const float* __restrict__ w,
            const T* __restrict__ dy, const float* __restrict__ mean,
            const float* __restrict__ rstd, T* __restrict__ dx,
            float* __restrict__ part_w, float* __restrict__ part_b, int R,
            int H_arg, int rms) {
  using V = Vec16<T>;
  constexpr int E = V::kE, NG = row_groups(LnBwdTiles::kWarps, WR);
  // rows a group walks: a block walks kWarps * kRowsWarp rows at every WR
  constexpr int RW = LnBwdTiles::kWarps * LnBwdTiles::kRowsWarp / NG;
  constexpr bool kFull = HC > 0 && HC / E == 32 * WR * NVL;
  const int H = HC > 0 ? HC : H_arg, NV = H / E;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = warp / WR, wr = warp % WR, gl = wr * 32 + lane;
  // the group's rows: first, first + NG, ..., RW of them
  const int64_t first = (int64_t)blockIdx.x * NG * RW + group;

  uint4 cx[NVL], cg[NVL];  // this row's x and dy, as loaded
  float cmu = 0.f, crs = 0.f;
  auto load = [&](int64_t r, uint4* vx, uint4* vg, float& mu, float& rs) {
#pragma unroll
    for (int k = 0; k < NVL; ++k) {
      const int vi = gl + 32 * WR * k;
      if (kFull || vi < NV) {
        vx[k] = ld16(x + r * H + vi * E);
        vg[k] = ld16(dy + r * H + vi * E);
      }
    }
    mu = rms ? 0.f : __ldg(mean + r);
    rs = __ldg(rstd + r);
  };
  float pw[NVL][E], pb[NVL][E];  // this group's dw, db partials of its columns
#pragma unroll
  for (int k = 0; k < NVL; ++k)
#pragma unroll
    for (int e = 0; e < E; ++e) pw[k][e] = pb[k][e] = 0.f;

  if (first < R) load(first, cx, cg, cmu, crs);
#pragma unroll 1
  for (int i = 0; i < RW; ++i) {
    const int64_t r = first + (int64_t)i * NG;
    if (r >= R) break;  // the whole row group leaves together
    const int64_t rn = r + NG;
    const bool more = i + 1 < RW && rn < R;
    uint4 nx[NVL], ng[NVL];
    float nmu = 0.f, nrs = 0.f;
    if (LnBwdTiles::kPrefetch && more) load(rn, nx, ng, nmu, nrs);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < NVL; ++k) {
      const int vi = gl + 32 * WR * k;
      if (kFull || vi < NV) {
        float xf[E], gw[E];
        V::unpack(cx[k], xf);
        V::unpack(cg[k], gw);
        if (w) times4<E>(gw, w, vi * E);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float xhat = (xf[e] - cmu) * crs;
          s1 += gw[e];
          s2 += gw[e] * xhat;
        }
      }
    }
    group_sum<WR, NG, 0, true>(s1, s2, group, wr, i & 1);
    const float m1 = rms ? 0.f : s1 / (float)H, m2 = s2 / (float)H;
    T* dxr = dx + r * H;
#pragma unroll
    for (int k = 0; k < NVL; ++k) {
      const int vi = gl + 32 * WR * k;
      if (kFull || vi < NV) {
        float xf[E], g[E], gw[E], o[E];
        V::unpack(cx[k], xf);
        V::unpack(cg[k], g);
#pragma unroll
        for (int e = 0; e < E; ++e) gw[e] = g[e];
        if (w) times4<E>(gw, w, vi * E);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float xhat = (xf[e] - cmu) * crs;
          o[e] = (rms ? gw[e] - xhat * m2 : gw[e] - m1 - xhat * m2) * crs;
          pw[k][e] += g[e] * xhat;
          pb[k][e] += g[e];
        }
        *reinterpret_cast<uint4*>(dxr + vi * E) = V::pack(o);
      }
    }
    if (!more) break;
    if (LnBwdTiles::kPrefetch) {
#pragma unroll
      for (int k = 0; k < NVL; ++k) {
        cx[k] = nx[k];
        cg[k] = ng[k];
      }
      cmu = nmu;
      crs = nrs;
    } else {
      load(rn, cx, cg, cmu, crs);
    }
  }

  if (!part_w) return;  // no affine: no partials (uniform over the block)
  if constexpr (NG > 1) {
    // groups 0 .. NG - 2 add their partials into shared memory in group
    // order; the last group adds its own and writes the block's row
    extern __shared__ float4 ln_cmb4[];
    float* cw = reinterpret_cast<float*>(ln_cmb4);
    float* cb = cw + H;
    for (int g = 0; g < NG - 1; ++g) {
      if (group == g) {
#pragma unroll
        for (int k = 0; k < NVL; ++k) {
          const int vi = gl + 32 * WR * k;
          if (kFull || vi < NV) {
#pragma unroll
            for (int e = 0; e < E; ++e) {
              cw[vi * E + e] = g ? cw[vi * E + e] + pw[k][e] : pw[k][e];
              cb[vi * E + e] = g ? cb[vi * E + e] + pb[k][e] : pb[k][e];
            }
          }
        }
      }
      __syncthreads();
    }
    if (group != NG - 1) return;
#pragma unroll
    for (int k = 0; k < NVL; ++k) {
      const int vi = gl + 32 * WR * k;
      if (kFull || vi < NV) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          pw[k][e] = cw[vi * E + e] + pw[k][e];
          pb[k][e] = cb[vi * E + e] + pb[k][e];
        }
      }
    }
  }
  const int64_t row = (int64_t)blockIdx.x * H;
#pragma unroll
  for (int k = 0; k < NVL; ++k) {
    const int vi = gl + 32 * WR * k;
    if (kFull || vi < NV) {
#pragma unroll
      for (int q = 0; q < E / 4; ++q) {
        const int c = vi * E + 4 * q;
        *reinterpret_cast<float4*>(part_w + row + c) =
            make_float4(pw[k][4 * q], pw[k][4 * q + 1], pw[k][4 * q + 2], pw[k][4 * q + 3]);
        if (part_b)
          *reinterpret_cast<float4*>(part_b + row + c) =
              make_float4(pb[k][4 * q], pb[k][4 * q + 1], pb[k][4 * q + 2], pb[k][4 * q + 3]);
      }
    }
  }
}

// Stage 2 of the fast path: dw[c] = sum_g part_w[g, c] (db likewise, where
// given) for H a multiple of 4.  A block holds 16 columns, as 4 quads, and
// kReduceLanes row lanes: lane t sums rows t, t + kReduceLanes, ... with
// 16-byte loads, then the lanes of a warp by an xor butterfly and the
// warps in warp order.  The order is fixed: bitwise the same run to run.
__global__ void __launch_bounds__(4 * kReduceLanes)
ln_bwd_reduce_vec(const float* __restrict__ part_w, const float* __restrict__ part_b,
                  float* __restrict__ dw, float* __restrict__ db, int G, int H) {
  constexpr int kWarps = 4 * kReduceLanes / 32;
  const int q = threadIdx.x & 3, t = threadIdx.x >> 2;
  const int c = (blockIdx.x * 4 + q) * 4;
  float4 aw = make_float4(0.f, 0.f, 0.f, 0.f), ab = aw;
  if (c < H) {
    for (int g = t; g < G; g += kReduceLanes) {
      const float4 u = __ldg(reinterpret_cast<const float4*>(part_w + (int64_t)g * H + c));
      aw.x += u.x;
      aw.y += u.y;
      aw.z += u.z;
      aw.w += u.w;
      if (db) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(part_b + (int64_t)g * H + c));
        ab.x += v.x;
        ab.y += v.y;
        ab.z += v.z;
        ab.w += v.w;
      }
    }
  }
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    aw.x += __shfl_xor_sync(0xffffffffu, aw.x, o);
    aw.y += __shfl_xor_sync(0xffffffffu, aw.y, o);
    aw.z += __shfl_xor_sync(0xffffffffu, aw.z, o);
    aw.w += __shfl_xor_sync(0xffffffffu, aw.w, o);
    ab.x += __shfl_xor_sync(0xffffffffu, ab.x, o);
    ab.y += __shfl_xor_sync(0xffffffffu, ab.y, o);
    ab.z += __shfl_xor_sync(0xffffffffu, ab.z, o);
    ab.w += __shfl_xor_sync(0xffffffffu, ab.w, o);
  }
  __shared__ float4 sw[kWarps][4], sb[kWarps][4];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane < 4) {
    sw[warp][lane] = aw;
    sb[warp][lane] = ab;
  }
  __syncthreads();
  if (threadIdx.x < 4 && c < H) {
    float4 tw = sw[0][q], tb = sb[0][q];
#pragma unroll
    for (int i = 1; i < kWarps; ++i) {
      tw.x += sw[i][q].x;
      tw.y += sw[i][q].y;
      tw.z += sw[i][q].z;
      tw.w += sw[i][q].w;
      tb.x += sb[i][q].x;
      tb.y += sb[i][q].y;
      tb.z += sb[i][q].z;
      tb.w += sb[i][q].w;
    }
    *reinterpret_cast<float4*>(dw + c) = tw;
    if (db) *reinterpret_cast<float4*>(db + c) = tb;
  }
}

// ================================================================== plan
struct LnPlan {
  int fast;            // 1: the fast path, 0: the general path
  int warps_row;       // warps a row (general: the block's 8)
  int vectors_lane;    // 16-byte vectors a lane holds (general: 0)
  int fwd_rows_block;  // rows a forward block holds
  int fwd_blocks;      // forward grid
  int bwd_rows_block;  // rows a backward stage-1 block walks
  int bwd_blocks;      // G: stage-1 grid, rows of the dw/db partials
  int fwd_smem;        // shared bytes of a forward block (static + dynamic)
  int bwd_smem;        // shared bytes of a stage-1 block (static + dynamic)
};
constexpr int kPlanFields = 9;

// dtype: 0 = float32, 1 = bfloat16.  aligned: x, dy, y, dx, w and b all
// start on 16 bytes.  Depends on the shape alone.
LnPlan ln_plan(int R, int H, int dtype, int aligned) {
  LnPlan p{};
  const int E = dtype == 1 ? 8 : 4;
  const int nv = H / E, wr = row_warps(nv);
  if (aligned && H % E == 0 && wr <= kMaxWarpsRow) {
    const int ngf = row_groups(LnFwdTiles::kWarps, wr);
    const int ngb = row_groups(LnBwdTiles::kWarps, wr);
    p.fast = 1;
    p.warps_row = wr;
    p.vectors_lane = lane_vectors(nv, wr);
    p.fwd_rows_block = ngf;
    p.bwd_rows_block = LnBwdTiles::kWarps * LnBwdTiles::kRowsWarp;
    p.fwd_smem = wr > 1 ? 2 * ngf * wr * 8 : 0;
    p.bwd_smem = (wr > 1 ? 2 * ngb * wr * 8 : 0) + (ngb > 1 ? 2 * H * 4 : 0);
  } else {
    p.fast = 0;
    p.warps_row = kThreads / 32;
    p.vectors_lane = 0;
    p.fwd_rows_block = 1;
    p.bwd_rows_block = kBwdRows;
    p.fwd_smem = H * 4 + (kThreads / 32) * 4;
    p.bwd_smem = 4 * H * 4 + (2 * (kThreads / 32) + 2) * 4;
  }
  p.fwd_blocks = (R + p.fwd_rows_block - 1) / p.fwd_rows_block;
  p.bwd_blocks = (R + p.bwd_rows_block - 1) / p.bwd_rows_block;
  return p;
}

bool aligned16(std::initializer_list<const void*> ptrs) {
  uintptr_t u = 0;
  for (const void* p : ptrs) u |= (uintptr_t)p;
  return u % 16 == 0;
}

// Runs f.run<WR, NVL, HC>() for the fast plan's instantiation: H = 768 and
// 1024 at compile-time widths, every other H at its (WR, NVL).
template <typename T, typename F>
cudaError_t dispatch(const LnPlan& p, int H, const F& f) {
  constexpr int E = 16 / (int)sizeof(T);
  constexpr int W768 = row_warps(768 / E), W1024 = row_warps(1024 / E);
  if (H == 768) return f.template run<W768, lane_vectors(768 / E, W768), 768>();
  if (H == 1024) return f.template run<W1024, lane_vectors(1024 / E, W1024), 1024>();
  switch (p.warps_row * 16 + p.vectors_lane) {
#define LN_CASE(WR, NVL) \
  case WR * 16 + NVL:    \
    return f.template run<WR, NVL, 0>();
    LN_CASE(1, 1) LN_CASE(1, 2) LN_CASE(1, 3) LN_CASE(1, 4)
    LN_CASE(2, 3) LN_CASE(2, 4) LN_CASE(4, 3) LN_CASE(4, 4) LN_CASE(8, 3) LN_CASE(8, 4)
#undef LN_CASE
  }
  return cudaErrorInvalidValue;
}

template <typename T>
struct FwdLaunch {
  const LnPlan& p;
  const void *x, *w, *b;
  void *y, *mean, *rstd;
  int R, H;
  float eps;
  int rms;
  cudaStream_t st;
  template <int WR, int NVL, int HC>
  cudaError_t run() const {
    ln_fwd_warp<T, WR, NVL, HC>
        <<<p.fwd_blocks, row_groups(LnFwdTiles::kWarps, WR) * WR * 32, 0, st>>>(
            (const T*)x, (const float*)w, (const float*)b, (T*)y, (float*)mean,
            (float*)rstd, R, H, eps, rms);
    return cudaGetLastError();
  }
};

template <typename T>
struct BwdLaunch {
  const LnPlan& p;
  const void *x, *w, *dy, *mean, *rstd;
  void *dx, *part_w, *part_b;
  int R, H, rms;
  cudaStream_t st;
  template <int WR, int NVL, int HC>
  cudaError_t run() const {
    constexpr int NG = row_groups(LnBwdTiles::kWarps, WR);
    const int smem = NG > 1 ? 2 * H * 4 : 0;  // the groups' partials
    auto* kernel = ln_bwd_warp<T, WR, NVL, HC>;
    if (smem > 48 * 1024) {
      cudaError_t e =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return e;
    }
    kernel<<<p.bwd_blocks, NG * WR * 32, smem, st>>>(
        (const T*)x, (const float*)w, (const T*)dy, (const float*)mean, (const float*)rstd,
        (T*)dx, (float*)part_w, (float*)part_b, R, H, rms);
    return cudaGetLastError();
  }
};

}  // namespace

// The launch plan of rows x hidden in dtype (0 = float32, 1 = bfloat16),
// with aligned = 1 when every pointer starts on 16 bytes: the LnPlan
// fields in order into out (int64 x 9).  The launches below use it.
extern "C" int apex_layer_norm_plan(int rows, int hidden, int dtype, int aligned,
                                    int64_t* out) {
  if (rows < 0 || hidden <= 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  const LnPlan p = ln_plan(rows, hidden, dtype, aligned);
  const int f[kPlanFields] = {p.fast, p.warps_row, p.vectors_lane,
                              p.fwd_rows_block, p.fwd_blocks, p.bwd_rows_block,
                              p.bwd_blocks, p.fwd_smem, p.bwd_smem};
  for (int i = 0; i < kPlanFields; ++i) out[i] = f[i];
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16 (x and y).  w, b: float32 (H,), or
// null for none.  rms: 1 = RMSNorm (mean written as 0).
extern "C" int apex_layer_norm_fwd(const void* x, const void* w, const void* b,
                                   void* y, void* mean, void* rstd, int rows,
                                   int hidden, float eps, int rms, int dtype,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const LnPlan p = ln_plan(rows, hidden, dtype, aligned16({x, w, b, y}));
  if (p.fast) {
    return dtype == 0
               ? (int)dispatch<float>(p, hidden, FwdLaunch<float>{p, x, w, b, y, mean, rstd,
                                                                  rows, hidden, eps, rms, st})
               : (int)dispatch<__nv_bfloat16>(
                     p, hidden, FwdLaunch<__nv_bfloat16>{p, x, w, b, y, mean, rstd, rows,
                                                          hidden, eps, rms, st});
  }
  const size_t smem = (size_t)hidden * sizeof(float);
  if (dtype == 0) {
    ln_fwd_kernel<float><<<rows, kThreads, smem, st>>>(
        (const float*)x, (const float*)w, (const float*)b, (float*)y,
        (float*)mean, (float*)rstd, hidden, eps, rms);
  } else {
    ln_fwd_kernel<__nv_bfloat16><<<rows, kThreads, smem, st>>>(
        (const __nv_bfloat16*)x, (const float*)w, (const float*)b,
        (__nv_bfloat16*)y, (float*)mean, (float*)rstd, hidden, eps, rms);
  }
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16 (x, dy and dx).  w, mean, rstd, the
// partials, dw and db: float32; the partials hold the plan's bwd_blocks
// rows of H (apex_layer_norm_plan with aligned as x, dy, dx and w give
// it).  w null: no affine (part_w, part_b, dw, db null too); part_b and
// db null: no bias.  rms: 1 = RMSNorm (mean is not read).  Launches
// stage 1, and stage 2 when there is a weight.
extern "C" int apex_layer_norm_bwd(const void* x, const void* w, const void* dy,
                                   const void* mean, const void* rstd, void* dx,
                                   void* part_w, void* part_b, void* dw,
                                   void* db, int rows, int hidden, int rms,
                                   int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const LnPlan p = ln_plan(rows, hidden, dtype, aligned16({x, dy, dx, w}));
  cudaError_t e;
  if (p.fast) {
    e = dtype == 0
            ? dispatch<float>(p, hidden, BwdLaunch<float>{p, x, w, dy, mean, rstd, dx, part_w,
                                                          part_b, rows, hidden, rms, st})
            : dispatch<__nv_bfloat16>(
                  p, hidden, BwdLaunch<__nv_bfloat16>{p, x, w, dy, mean, rstd, dx, part_w,
                                                       part_b, rows, hidden, rms, st});
  } else if (dtype == 0) {
    e = launch_ln_bwd<float>(x, w, dy, mean, rstd, dx, part_w, part_b, rows,
                             hidden, p.bwd_blocks, rms, st);
  } else {
    e = launch_ln_bwd<__nv_bfloat16>(x, w, dy, mean, rstd, dx, part_w, part_b,
                                     rows, hidden, p.bwd_blocks, rms, st);
  }
  if (e != cudaSuccess || !w) return (int)e;
  if (p.fast) {
    ln_bwd_reduce_vec<<<(hidden + 15) / 16, 4 * kReduceLanes, 0, st>>>(
        (const float*)part_w, (const float*)part_b, (float*)dw, (float*)db, p.bwd_blocks,
        hidden);
  } else {
    ln_bwd_reduce_kernel<<<(hidden + 31) / 32, 256, 0, st>>>(
        (const float*)part_w, (const float*)part_b, (float*)dw, (float*)db, p.bwd_blocks,
        hidden);
  }
  return (int)cudaGetLastError();
}
