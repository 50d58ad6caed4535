// Fused sampling head for Hopper (sm_90a): hidden state -> token.
//
// Replaces: apex_tpu/ops/decode_sampling_pallas.py `_sample_kernel`
// (launcher `fused_sample_pallas`).
//
// Computes, per row n of x (N, H):
//   s_v    = x[n] . embed[v]            (fp32: bf16 x widened, fp32 embed)
//   cand_v = s_v / T + gumbel(seed[n], v)   (T > 0), or s_v (T == 0)
//   top_k > 0: cand_v = -1e30 where s_v < k-th largest s (ties kept)
//   token  = argmax_v cand_v, the lowest index on equal values
// with the counter-hash Gumbel noise of `_hash_u32` / `gumbel_from_seed`
// in native uint32, so the kernel and the plain version draw from the
// same stream.
//
// Bound on the H100: memory bytes.  The head reads the whole fp32
// embedding once per call (50304 x 768 x 4 B = 154.5 MB, ~46 us at
// 3.35 TB/s) and does 2 * N * V * H flops, ~0.6 GFLOP at N = 8: 0.5
// flop per byte, so tensor cores buy nothing.
//
// Design:
// - `score_kernel`: the vocab is cut into contiguous chunks, one per
//   block (a few blocks per SM).  Each warp takes one vocab row at a
//   time, streams it with 16-byte loads, and dots it against up to 8 x
//   rows held in shared memory (fp32), so each embed row is read once
//   for all rows of the tile.  Sampling mode keeps a running (value,
//   index) per row per warp (strict >, rows visited in increasing
//   order), merges the warps, and writes one candidate per block and
//   row.  The (N, V) logits never reach device memory in this mode.
// - `reduce_kernel`: one block per row merges the block candidates;
//   on equal values the lower index wins, as argmax's first hit.
// - top_k: `score_kernel` in logits mode writes the (N, V) fp32 scores
//   (1.6 MB at N = 8, against the 154.5 MB embed read), `kth_kernel`
//   finds each row's k-th largest score by a 4-pass 8-bit radix select
//   in shared memory, and `logits_sample_kernel` draws from the stored
//   scores above that threshold; then `reduce_kernel`.  No limit on k.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowTile = 8;
constexpr float kNegInf = -1e30f;

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ uint32_t hash_u32(uint32_t z) {
  z *= 2654435761u;
  z ^= z >> 16;
  z *= 0x45D9F3Bu;
  z ^= z >> 16;
  z *= 0x45D9F3Bu;
  z ^= z >> 16;
  return z;
}

__device__ __forceinline__ float gumbel(uint32_t seed, uint32_t col) {
  const uint32_t z = hash_u32(seed ^ (col * 0x9E3779B9u));
  const float u = ((float)(z >> 8) + 0.5f) * (1.0f / 16777216.0f);
  return -logf(-logf(u));
}

// (value, index) order: larger value first, lower index on a tie
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

template <typename XT, bool kLogitsOnly>
__global__ void __launch_bounds__(kThreads)
score_kernel(const XT* __restrict__ x, const float* __restrict__ embed,
             const long long* __restrict__ seeds, float* __restrict__ logits,
             float* __restrict__ part_v, int* __restrict__ part_i, int N,
             int H, int V, int chunk, float temperature) {
  extern __shared__ float xs[];  // kRowTile * H
  __shared__ float wv[kWarps][kRowTile];
  __shared__ int wi[kWarps][kRowTile];
  const int n0 = blockIdx.y * kRowTile;
  const int nrows = min(kRowTile, N - n0);
  for (int i = threadIdx.x; i < kRowTile * H; i += kThreads) {
    const int r = i / H;
    xs[i] = r < nrows ? to_f32(x[(int64_t)(n0 + r) * H + (i - r * H)]) : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int v0 = blockIdx.x * chunk;
  const int v1 = min(V, v0 + chunk);
  const int h4 = H >> 2;
  const bool greedy = temperature <= 0.f;
  uint32_t seed[kRowTile];
  float best_v[kRowTile];
  int best_i[kRowTile];
#pragma unroll
  for (int r = 0; r < kRowTile; ++r) {
    seed[r] = r < nrows ? (uint32_t)seeds[n0 + r] : 0u;
    best_v[r] = kNegInf;
    best_i[r] = 0;
  }

  for (int v = v0 + warp; v < v1; v += kWarps) {
    const float4* er = reinterpret_cast<const float4*>(embed + (int64_t)v * H);
    float acc[kRowTile];
#pragma unroll
    for (int r = 0; r < kRowTile; ++r) acc[r] = 0.f;
#pragma unroll 2
    for (int c = lane; c < h4; c += 32) {
      const float4 e = __ldg(er + c);
#pragma unroll
      for (int r = 0; r < kRowTile; ++r) {
        const float4 xv = reinterpret_cast<const float4*>(xs + r * H)[c];
        acc[r] += e.x * xv.x + e.y * xv.y + e.z * xv.z + e.w * xv.w;
      }
    }
#pragma unroll
    for (int r = 0; r < kRowTile; ++r) {
      for (int o = 16; o > 0; o >>= 1) acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], o);
    }
    if (kLogitsOnly) {
      if (lane == 0) {
        for (int r = 0; r < nrows; ++r) logits[(int64_t)(n0 + r) * V + v] = acc[r];
      }
    } else {
#pragma unroll
      for (int r = 0; r < kRowTile; ++r) {
        const float cand = greedy ? acc[r] : acc[r] / temperature + gumbel(seed[r], (uint32_t)v);
        if (cand > best_v[r]) {
          best_v[r] = cand;
          best_i[r] = v;
        }
      }
    }
  }
  if (kLogitsOnly) return;

  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < kRowTile; ++r) {
      wv[warp][r] = best_v[r];
      wi[warp][r] = best_i[r];
    }
  }
  __syncthreads();
  if (threadIdx.x < nrows) {
    const int r = threadIdx.x;
    float bv = wv[0][r];
    int bi = wi[0][r];
    for (int w = 1; w < kWarps; ++w) {
      if (better(wv[w][r], wi[w][r], bv, bi)) {
        bv = wv[w][r];
        bi = wi[w][r];
      }
    }
    part_v[(int64_t)blockIdx.x * N + n0 + r] = bv;
    part_i[(int64_t)blockIdx.x * N + n0 + r] = bi;
  }
}

__device__ __forceinline__ uint32_t f2key(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float key2f(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// k-th largest of each row of logits (N, V), k in [1, V]: radix select
// over the order-preserving uint32 keys, 8 bits a pass from the top.
__global__ void __launch_bounds__(kThreads)
kth_kernel(const float* __restrict__ logits, float* __restrict__ tau, int V, int k) {
  __shared__ unsigned int hist[256];
  __shared__ uint32_t s_prefix;
  __shared__ int s_remaining;
  const float* row = logits + (int64_t)blockIdx.x * V;
  uint32_t prefix = 0, mask = 0;
  int remaining = k;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = threadIdx.x; i < 256; i += kThreads) hist[i] = 0;
    __syncthreads();
    for (int v = threadIdx.x; v < V; v += kThreads) {
      const uint32_t key = f2key(row[v]);
      if ((key & mask) == prefix) atomicAdd(&hist[(key >> shift) & 255u], 1u);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int d = 255; d >= 0; --d) {
        const int c = (int)hist[d];
        if (c >= remaining) {
          prefix |= (uint32_t)d << shift;
          break;
        }
        remaining -= c;
      }
      s_prefix = prefix;
      s_remaining = remaining;
    }
    __syncthreads();
    prefix = s_prefix;
    remaining = s_remaining;
    mask |= 255u << shift;
  }
  if (threadIdx.x == 0) tau[blockIdx.x] = key2f(prefix);
}

// sampling from stored scores under the top-k threshold; grid (blocks, N)
__global__ void __launch_bounds__(kThreads)
logits_sample_kernel(const float* __restrict__ logits, const float* __restrict__ tau,
                     const long long* __restrict__ seeds, float* __restrict__ part_v,
                     int* __restrict__ part_i, int N, int V, int chunk,
                     float temperature) {
  __shared__ float wv[kWarps];
  __shared__ int wi[kWarps];
  const int n = blockIdx.y;
  const float* row = logits + (int64_t)n * V;
  const float t = tau[n];
  const uint32_t seed = (uint32_t)seeds[n];
  const int v0 = blockIdx.x * chunk;
  const int v1 = min(V, v0 + chunk);
  float bv = kNegInf;
  int bi = 0;
  for (int v = v0 + threadIdx.x; v < v1; v += kThreads) {
    const float s = row[v];
    if (s >= t) {
      const float cand = s / temperature + gumbel(seed, (uint32_t)v);
      if (cand > bv) {
        bv = cand;
        bi = v;
      }
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    wv[warp] = bv;
    wi[warp] = bi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      if (better(wv[w], wi[w], bv, bi)) {
        bv = wv[w];
        bi = wi[w];
      }
    }
    part_v[(int64_t)blockIdx.x * N + n] = bv;
    part_i[(int64_t)blockIdx.x * N + n] = bi;
  }
}

// one block per row: merge the per-block candidates into the token
__global__ void __launch_bounds__(kThreads)
reduce_kernel(const float* __restrict__ part_v, const int* __restrict__ part_i,
              int* __restrict__ tokens, int N, int nblocks) {
  __shared__ float wv[kWarps];
  __shared__ int wi[kWarps];
  const int n = blockIdx.x;
  float bv = kNegInf;
  int bi = 0x7fffffff;
  for (int b = threadIdx.x; b < nblocks; b += kThreads) {
    const float v = part_v[(int64_t)b * N + n];
    const int i = part_i[(int64_t)b * N + n];
    if (better(v, i, bv, bi)) {
      bv = v;
      bi = i;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    wv[warp] = bv;
    wi[warp] = bi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      if (better(wv[w], wi[w], bv, bi)) {
        bv = wv[w];
        bi = wi[w];
      }
    }
    tokens[n] = bi;
  }
}

}  // namespace

// x (N, H) float32 (x_dtype 0) or bfloat16 (1); embed (V, H) float32
// with H % 4 == 0 and 16-byte aligned rows; seeds (N,) int64 holding
// uint32 values; tokens (N,) int32.  part_v / part_i: (nblocks, N)
// scratch.  top_k in (0, V) with temperature > 0 also needs logits
// (N, V) and tau (N,) scratch; otherwise those may be null.
extern "C" int apex_fused_sample(const void* x, const void* embed,
                                 const void* seeds, void* tokens, void* part_v,
                                 void* part_i, void* logits, void* tau, int N,
                                 int H, int V, int nblocks, float temperature,
                                 int top_k, int x_dtype, void* stream) {
  if (N <= 0 || V <= 0 || nblocks <= 0 || (H & 3) != 0) return (int)cudaErrorInvalidValue;
  if (x_dtype != 0 && x_dtype != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int chunk = (V + nblocks - 1) / nblocks;
  const size_t smem = (size_t)kRowTile * H * sizeof(float);
  // 48 KB a block, less 1 KB for the static wv / wi buffers: H <= 1504
  if (smem > 47 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid(nblocks, (N + kRowTile - 1) / kRowTile);
  const bool use_top_k = temperature > 0.f && top_k > 0 && top_k < V;
  const long long* sd = (const long long*)seeds;
  float* pv = (float*)part_v;
  int* pi = (int*)part_i;
  if (!use_top_k) {
    if (x_dtype == 0) {
      score_kernel<float, false><<<grid, kThreads, smem, st>>>(
          (const float*)x, (const float*)embed, sd, nullptr, pv, pi, N, H, V, chunk, temperature);
    } else {
      score_kernel<__nv_bfloat16, false><<<grid, kThreads, smem, st>>>(
          (const __nv_bfloat16*)x, (const float*)embed, sd, nullptr, pv, pi, N, H, V, chunk, temperature);
    }
  } else {
    if (logits == nullptr || tau == nullptr) return (int)cudaErrorInvalidValue;
    if (x_dtype == 0) {
      score_kernel<float, true><<<grid, kThreads, smem, st>>>(
          (const float*)x, (const float*)embed, sd, (float*)logits, pv, pi, N, H, V, chunk, temperature);
    } else {
      score_kernel<__nv_bfloat16, true><<<grid, kThreads, smem, st>>>(
          (const __nv_bfloat16*)x, (const float*)embed, sd, (float*)logits, pv, pi, N, H, V, chunk, temperature);
    }
    kth_kernel<<<N, kThreads, 0, st>>>((const float*)logits, (float*)tau, V, top_k);
    logits_sample_kernel<<<dim3(nblocks, N), kThreads, 0, st>>>(
        (const float*)logits, (const float*)tau, sd, pv, pi, N, V, chunk, temperature);
  }
  reduce_kernel<<<N, kThreads, 0, st>>>(pv, pi, (int*)tokens, N, nblocks);
  return (int)cudaGetLastError();
}
