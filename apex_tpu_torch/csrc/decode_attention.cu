// Paged single-query decode attention for Hopper (sm_90a).
//
// Replaces: apex_tpu/ops/decode_attention_pallas.py `_decode_attn_kernel`
// (launcher `paged_decode_attention_pallas`), for width = 1 (one query
// per sequence).
//
// Computes, for each sequence b and query head h:
//   out[b, h] = softmax(q[b, h] . K_b^T / sqrt(D)) . V_b
// where K_b, V_b are the first lengths[b] positions of the sequence's
// pages in the pool, page ids read from page_table[b] and clamped into
// [0, num_pages).  Online softmax in fp32 with a -1e30 mask, exp
// re-masked to 0 for masked positions, probabilities cast to v's dtype
// before P.V, l clamped to >= 1e-30, so a length-0 sequence gives a
// zero row.  Output in the pool's dtype.
//
// Bound on the H100: memory bytes.  Per (sequence, kv head) the kernel
// reads lengths[b] * D k and v values once and does 4 * group * D flops
// per position: about 2 flops per byte in bf16, far below the card's
// ~295 flops/byte ridge.  At the serve shapes (8 sequences, under 100
// positions) the whole read is ~2 MB per layer, so launch latency and
// the serial page loop dominate.
//
// Design: one block per (sequence, kv head).  The block walks the
// sequence's pages up to ceil(length / page_size), loading each page's
// k and v rows of this kv head once into shared memory (widened to
// fp32), and scores all H / H_kv query heads of the GQA group against
// that one read.  Scores are one warp per (head, position) pair with a
// shuffle reduction over D; the running max, sum and accumulator live
// in shared memory.  8 x 12 = 96 blocks at the serve shape is fewer
// than the 132 SMs: splitting each sequence over several blocks
// (flash-decoding, with a second reduction pass) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
// round through T and back: the "probabilities cast to v's dtype" step
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32<T>(from_f32<T>(v));
}

template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads)
paged_decode_attn_kernel(const QT* __restrict__ q, const KT* __restrict__ k_pool,
                         const KT* __restrict__ v_pool,
                         const int* __restrict__ page_table,
                         const int* __restrict__ lengths, KT* __restrict__ out,
                         int H, int HKV, int D, int num_pages, int PS, int P,
                         float denom) {
  const int b = blockIdx.x / HKV;
  const int g = blockIdx.x % HKV;
  const int group = H / HKV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int nwarps = kThreads / 32;

  extern __shared__ float sm[];
  float* qs = sm;                 // group * D
  float* ks = qs + group * D;     // PS * D
  float* vs = ks + PS * D;        // PS * D
  float* ps = vs + PS * D;        // group * PS: scores, then exp
  float* acc = ps + group * PS;   // group * D
  float* m = acc + group * D;     // group
  float* l = m + group;           // group
  float* corr = l + group;        // group

  const int len = lengths[b];
  int n_pages = len <= 0 ? 0 : (len + PS - 1) / PS;
  if (n_pages > P) n_pages = P;

  const int64_t q_row0 = ((int64_t)b * H + (int64_t)g * group) * D;
  for (int i = threadIdx.x; i < group * D; i += kThreads) {
    qs[i] = to_f32(q[q_row0 + i]);
    acc[i] = 0.f;
  }
  for (int h = threadIdx.x; h < group; h += kThreads) {
    m[h] = kNegInf;
    l[h] = 0.f;
  }
  __syncthreads();

  for (int p = 0; p < n_pages; ++p) {
    int page = page_table[(int64_t)b * P + p];
    page = page < 0 ? 0 : (page >= num_pages ? num_pages - 1 : page);
    const int64_t base = (int64_t)page * PS * HKV * D;
    for (int i = threadIdx.x; i < PS * D; i += kThreads) {
      const int j = i / D, d = i - j * D;
      const int64_t off = base + ((int64_t)j * HKV + g) * D + d;
      ks[i] = to_f32(k_pool[off]);
      vs[i] = to_f32(v_pool[off]);
    }
    __syncthreads();

    // scores: one warp per (head, position), lanes over D
    for (int pair = warp; pair < group * PS; pair += nwarps) {
      const int h = pair / PS, j = pair - h * PS;
      float s = 0.f;
      for (int d = lane; d < D; d += 32) s += qs[h * D + d] * ks[j * D + d];
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) {
        s = s / denom;
        ps[pair] = (p * PS + j < len) ? s : kNegInf;
      }
    }
    __syncthreads();

    // online-softmax update, one thread per head
    for (int h = threadIdx.x; h < group; h += kThreads) {
      float mx = kNegInf;
      for (int j = 0; j < PS; ++j) mx = fmaxf(mx, ps[h * PS + j]);
      const float m_prev = m[h];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = 0; j < PS; ++j) {
        const float s = ps[h * PS + j];
        const float e = s > kNegInf / 2 ? expf(s - m_new) : 0.f;
        ps[h * PS + j] = e;
        sum += e;
      }
      const float c = expf(m_prev - m_new);
      l[h] = l[h] * c + sum;
      m[h] = m_new;
      corr[h] = c;
    }
    __syncthreads();

    // acc = acc * corr + P.V, P rounded to v's dtype first
    for (int i = threadIdx.x; i < group * D; i += kThreads) {
      const int h = i / D, d = i - h * D;
      float pv = 0.f;
      for (int j = 0; j < PS; ++j) pv += round_to<KT>(ps[h * PS + j]) * vs[j * D + d];
      acc[i] = acc[i] * corr[h] + pv;
    }
    __syncthreads();  // ks / vs / ps are overwritten by the next page
  }

  for (int i = threadIdx.x; i < group * D; i += kThreads) {
    const int h = i / D;
    out[q_row0 + i] = from_f32<KT>(acc[i] / fmaxf(l[h], 1e-30f));
  }
}

template <typename QT, typename KT>
void launch(const void* q, const void* k, const void* v, const int* pt,
            const int* len, void* out, int B, int H, int HKV, int D,
            int num_pages, int PS, int P, float denom, size_t smem,
            cudaStream_t st) {
  paged_decode_attn_kernel<QT, KT><<<B * HKV, kThreads, smem, st>>>(
      (const QT*)q, (const KT*)k, (const KT*)v, pt, len, (KT*)out, H, HKV, D,
      num_pages, PS, P, denom);
}

}  // namespace

// Shared-memory bytes the kernel needs at these sizes (the wrapper
// checks it against the 48 KB default limit).
extern "C" int apex_paged_decode_attention_smem(int group, int D, int PS) {
  return (int)sizeof(float) * (2 * group * D + 2 * PS * D + group * PS + 3 * group);
}

// q_dtype / kv_dtype: 0 = float32, 1 = bfloat16.  page_table (B, P) and
// lengths (B,) are int32; out (B, H, D) has the pools' dtype.
extern "C" int apex_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* lengths, void* out, int B, int H,
    int HKV, int D, int num_pages, int PS, int P, float denom, int q_dtype,
    int kv_dtype, void* stream) {
  if (HKV <= 0 || H % HKV != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = apex_paged_decode_attention_smem(H / HKV, D, PS);
  const int* pt = (const int*)page_table;
  const int* len = (const int*)lengths;
  cudaStream_t st = (cudaStream_t)stream;
  if (q_dtype == 0 && kv_dtype == 0) {
    launch<float, float>(q, k_pool, v_pool, pt, len, out, B, H, HKV, D, num_pages, PS, P, denom, smem, st);
  } else if (q_dtype == 0 && kv_dtype == 1) {
    launch<float, __nv_bfloat16>(q, k_pool, v_pool, pt, len, out, B, H, HKV, D, num_pages, PS, P, denom, smem, st);
  } else if (q_dtype == 1 && kv_dtype == 0) {
    launch<__nv_bfloat16, float>(q, k_pool, v_pool, pt, len, out, B, H, HKV, D, num_pages, PS, P, denom, smem, st);
  } else if (q_dtype == 1 && kv_dtype == 1) {
    launch<__nv_bfloat16, __nv_bfloat16>(q, k_pool, v_pool, pt, len, out, B, H, HKV, D, num_pages, PS, P, denom, smem, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
