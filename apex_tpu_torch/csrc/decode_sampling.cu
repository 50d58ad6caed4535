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
// Bound on the H100: the bytes of one read of the fp32 embed (50304 x
// 768 x 4 B = 154.5 MB, 46 us at 3.35 TB/s).  In fp32 FMAs the 2 N V H
// flops (3.09 GFLOP at N = 40, 46 us at 67 TFLOP/s) would catch up with
// the bytes at about 40 rows, so the products run on the tensor cores in
// TF32, made exact in effect by a split (below); a plain TF32 product
// would round the embed to 11 bits, and the greedy tokens are held
// exactly against the full forward's fp32 argmax.
//
// Design:
// - `score_kernel` reads the embed once for every row of a call, up to
//   64 rows a pass (larger N takes more passes, one launch each).  The
//   vocabulary is cut into tiles of 128 rows, taken by about 3 blocks an
//   SM (393 blocks of one tile each at V = 50304 on 132 SMs); a block
//   brings its tiles' 32-column chunks of the embed and of the pass's x
//   rows by cp.async through a two-stage ring, so x takes no shared
//   memory beyond its chunks and H has no cap (H % 4 == 0).  Each of the
//   8 warps owns 16 vocab rows of the tile and every n-tile of 8 x rows:
//   mma.sync m16n8k8 in TF32 with fp32 accumulation, each embed value
//   split into hi + lo in TF32 (hi = rna(e), lo = rna(e - hi): the rest is
//   under 2^-22 of e), a bf16 x exact in TF32, so S = E_hi X + E_lo X (an
//   fp32 x is split too: E_hi X_hi + E_hi X_lo + E_lo X_hi).  The thread
//   that holds a finished score computes its Gumbel noise, once for each
//   (row, column) and only for real rows.
// - Sampling mode keeps each thread's best (value, index) of each of its
//   x rows; the lanes, then the warps of a block merge theirs once at the
//   end in a fixed order and write one candidate per block and row.
//   The (N, V) logits never reach device memory in this mode.
// - `reduce_kernel`: one block per row merges the block candidates;
//   on equal values the lower index wins, as argmax's first hit.
// - top_k: `score_kernel` in logits mode writes the (N, V) fp32 scores
//   (1.6 MB at N = 8, against the 154.5 MB embed read), `kth_kernel`
//   finds each row's k-th largest score by a 4-pass 8-bit radix select
//   in shared memory, and `logits_sample_kernel` draws from the stored
//   scores above that threshold; then `reduce_kernel`.  No limit on k.
// ops/decode_sampling.py states the launch plan (`sample_plan`), and
// apex_sample_plan reports what the launches use.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using apex_mma::cp_async16;
using apex_mma::cp_async8;
using apex_mma::cp_async_commit;
using apex_mma::cp_async_wait;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

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

// ---------------------------------------------------------------- scoring
// The head's tile plan: vocab rows a tile (16 a warp), columns of H a ring
// stage holds, ring stages, blocks an SM the grid aims at, x rows a pass.
struct SampleTiles {
  static constexpr int kVocabTile = 128;
  static constexpr int kChunk = 32;
  static constexpr int kStages = 2;
  static constexpr int kBlocksPerSm = 3;
  static constexpr int kRowCap = 64;
};

// Shared memory of a block of `rows` x rows (a multiple of 8): the ring,
// each stage the vocab tile's chunk and the x rows' chunk in fp32 (row
// stride chunk + 4: the mma fragments' loads hit 32 banks) and a bf16 x
// chunk's landing area (reserved for either dtype); then each warp's
// best (value, index) of every row of a pass.
__host__ __device__ constexpr size_t sample_smem(int rows) {
  using T = SampleTiles;
  return (size_t)T::kStages *
             ((size_t)(T::kVocabTile + rows) * (T::kChunk + 4) + (size_t)rows * T::kChunk / 2) *
             sizeof(float) +
         (size_t)(T::kVocabTile / 16) * T::kRowCap * (sizeof(float) + sizeof(int));
}

// The TF32 value nearest f (round half away), as mma.sync reads it.
__device__ __forceinline__ uint32_t tf32_rna(float f) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(f));
  return r;
}

// f = hi + lo + r, hi and lo TF32, |r| <= 2^-22 |f|.
__device__ __forceinline__ void split_tf32(float f, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(f);
  lo = tf32_rna(f - __uint_as_float(hi));
}

// d += a . b (16 x 8 by 8 x 8), tf32 in, fp32 accumulate.  Fragments
// (lane = 4 g + t): a[0] (g, t), a[1] (g + 8, t), a[2] (g, t + 4), a[3]
// (g + 8, t + 4); b0 (k t, n g), b1 (k t + 4, n g); d as m16n8k16's.
__device__ __forceinline__ void mma1688(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// s / T plus the noise of (seed, column).
__device__ __forceinline__ float noisy(float s, float temperature, uint32_t seed, uint32_t v) {
  return s / temperature + gumbel(seed, v);
}

// One pass of up to kRowCap x rows (NT = ceil(n / 8) n-tiles).  Block b
// scores vocab tiles b, b + gridDim.x, ... against every row of the pass:
// S = E X^T on the tensor cores, mma.sync m16n8k8 in TF32 with fp32
// accumulation, made exact in effect by a split: each embed value is hi +
// lo in TF32 (the rest under 2^-22 of it), and a bf16 x is exact in TF32,
// so S = E_hi X + E_lo X; an fp32 x is split too and S = E_hi X_hi +
// E_hi X_lo + E_lo X_hi.  Warp w owns the tile's rows 16 w .. 16 w + 15
// and every n-tile, so each embed fragment it splits feeds 2 (or 3) mma
// for each n-tile.  NT is a template parameter, so a thread holds 4 NT
// accumulators and no more: three blocks of 8 warps fit an SM up to 5
// n-tiles (the verify step's 40 rows), two above (at the 80 registers of
// three, 6 to 8 n-tiles spill).  A bf16 x chunk lands as bf16 and is
// widened once into the stage's fp32 rows.
// Sampling mode: when a tile's scores are whole, the thread that holds a
// score draws its noise (rows < n, columns < V only), the 8 lanes that
// share an x row merge their best (value, index), and lane 0 folds it
// into the warp's best of that row in shared memory; at the end the 8
// warps' bests are merged in warp order (the lower index on a tie), and
// the block's candidate of each row goes to part[b * N + n].  Logits mode
// writes the scores into logits[n * V + v] instead.
template <typename XT, int NT>
__global__ void __launch_bounds__(32 * SampleTiles::kVocabTile / 16, NT <= 5 ? 3 : 2)
score_kernel(const XT* __restrict__ x, const float* __restrict__ embed,
             const long long* __restrict__ seeds, float* __restrict__ logits,
             float* __restrict__ part_v, int* __restrict__ part_i, int n, int N, int H, int V,
             float temperature, int logits_mode) {
  using T = SampleTiles;
  constexpr int VT = T::kVocabTile, KC = T::kChunk, LD = KC + 4, G4 = KC / 4;
  constexpr int kBlock = 32 * VT / 16, rows = 8 * NT;  // threads; x rows of a stage
  constexpr int stage = (VT + rows) * LD + rows * KC / 2;  // floats of a stage
  constexpr bool kWiden = sizeof(XT) == 2;
  static_assert(VT % 16 == 0 && KC % 8 == 0 && NT * 8 <= T::kRowCap, "whole m16n8k8 tiles");
  extern __shared__ __align__(16) float ring[];
  float* best_v = ring + T::kStages * stage;  // [warp][x row]
  int* best_i = reinterpret_cast<int*>(best_v + (VT / 16) * T::kRowCap);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ntiles = (V + VT - 1) / VT, KCn = (H + KC - 1) / KC;
  const int my_tiles = (ntiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int steps = my_tiles * KCn;

  // chunk c (tile blockIdx.x + (c / KCn) gridDim.x, columns (c % KCn) KC..)
  // into stage c % kStages: the embed rows by 16-byte cp.async, the x rows
  // by 16 (fp32, into the fp32 rows) or 8 bytes (bf16, into the landing
  // area); rows past V or n and columns past H are zeros
  auto issue = [&](int c) {
    if (c < steps) {
      const int v0 = ((int)blockIdx.x + c / KCn * (int)gridDim.x) * VT;  // V < 2^31
      const int k0 = (c % KCn) * KC;
      float* se = ring + (c % T::kStages) * stage;
      float* sx = se + VT * LD;
      XT* sraw = reinterpret_cast<XT*>(kWiden ? sx + rows * LD : sx);
      for (int i = threadIdx.x; i < (VT + rows) * G4; i += kBlock) {
        const int r = i / G4, q = i % G4, k = k0 + 4 * q;
        if (r < VT) {
          const bool ok = k < H && v0 + r < V;
          cp_async16(se + r * LD + 4 * q, ok ? embed + (int64_t)(v0 + r) * H + k : embed,
                     ok ? 16 : 0);
        } else {
          const int xr = r - VT;
          const bool ok = k < H && xr < n;
          const XT* src = ok ? x + (int64_t)xr * H + k : x;
          if constexpr (kWiden)
            cp_async8(sraw + xr * KC + 4 * q, src, ok ? 8 : 0);
          else
            cp_async16(sraw + xr * LD + 4 * q, src, ok ? 16 : 0);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int c = 0; c < T::kStages - 1; ++c) issue(c);

  // this lane's x rows: 8 j + 2 t + q of n-tile j; its vocab rows of a
  // tile: 16 warp + g + 8 h (acc[j][2 h + q])
  const bool greedy = temperature <= 0.f;
  for (int i = threadIdx.x; i < (VT / 16) * T::kRowCap; i += kBlock)
    best_v[i] = kNegInf, best_i[i] = 0;  // seen after the walk's first barrier
  float acc[NT][4];
  for (int c = 0; c < steps; ++c) {
    cp_async_wait<T::kStages - 2>();
    __syncthreads();  // chunk c landed; every warp is done with chunk c - 1's stage
    issue(c + T::kStages - 1);
    const float* se = ring + (c % T::kStages) * stage;
    const float* sx = se + VT * LD;
    if constexpr (kWiden) {  // bf16 -> fp32 is exact: the high half of the word
      const uint32_t* raw = reinterpret_cast<const uint32_t*>(sx + rows * LD);
      float* wide = ring + (c % T::kStages) * stage + VT * LD;
      for (int i = threadIdx.x; i < rows * KC / 2; i += kBlock) {
        const uint32_t u = raw[i];
        const int r = i / (KC / 2), k = 2 * (i % (KC / 2));
        *reinterpret_cast<float2*>(wide + r * LD + k) =
            make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
      }
      __syncthreads();  // the chunk's x rows are fp32
    }
    const int kc = c % KCn;
    if (kc == 0) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
    }
    const float* sa = se + (16 * warp + g) * LD + t;
    const float* sb = sx + g * LD + t;
#pragma unroll
    for (int k0 = 0; k0 < KC; k0 += 8) {
      uint32_t ah[4], al[4];
      split_tf32(sa[k0], ah[0], al[0]);
      split_tf32(sa[8 * LD + k0], ah[1], al[1]);
      split_tf32(sa[k0 + 4], ah[2], al[2]);
      split_tf32(sa[8 * LD + k0 + 4], ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float b0 = sb[8 * j * LD + k0], b1 = sb[8 * j * LD + k0 + 4];
        if constexpr (kWiden) {  // x is exact in TF32
          mma1688(acc[j], ah, __float_as_uint(b0), __float_as_uint(b1));
          mma1688(acc[j], al, __float_as_uint(b0), __float_as_uint(b1));
        } else {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(b0, bh0, bl0);
          split_tf32(b1, bh1, bl1);
          mma1688(acc[j], ah, bh0, bh1);
          mma1688(acc[j], ah, bl0, bl1);
          mma1688(acc[j], al, bh0, bh1);
        }
      }
    }
    if (kc == KCn - 1) {  // the tile's scores are whole
      const int v0 = ((int)blockIdx.x + c / KCn * (int)gridDim.x) * VT + 16 * warp + g;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int xr = 8 * j + 2 * t + q;
          float bv = kNegInf;
          int bi = 0;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int v = v0 + 8 * h;
            if (v >= V || xr >= n) continue;
            const float s = acc[j][2 * h + q];
            if (logits_mode) {
              logits[(int64_t)xr * V + v] = s;
            } else {
              const uint32_t sd = (uint32_t)seeds[xr];
              const float cand = greedy ? s : noisy(s, temperature, sd, (uint32_t)v);
              if (better(cand, v, bv, bi)) bv = cand, bi = v;
            }
          }
          if (logits_mode) continue;
          for (int o = 4; o < 32; o <<= 1) {  // the 8 lanes (g) that hold this x row
            const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
            const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
            if (better(ov, oi, bv, bi)) bv = ov, bi = oi;
          }
          const int slot = warp * T::kRowCap + xr;
          if (g == 0 && xr < n && better(bv, bi, best_v[slot], best_i[slot]))
            best_v[slot] = bv, best_i[slot] = bi;
        }
    }
  }
  cp_async_wait<0>();
  if (logits_mode) return;
  __syncthreads();  // every warp's bests are in
  for (int xr = threadIdx.x; xr < n; xr += kBlock) {
    float bv = best_v[xr];
    int bi = best_i[xr];
    for (int w = 1; w < VT / 16; ++w)
      if (better(best_v[w * T::kRowCap + xr], best_i[w * T::kRowCap + xr], bv, bi))
        bv = best_v[w * T::kRowCap + xr], bi = best_i[w * T::kRowCap + xr];
    part_v[(int64_t)blockIdx.x * N + xr] = bv;
    part_i[(int64_t)blockIdx.x * N + xr] = bi;
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


// The launch plan of a call: passes of at most kRowCap rows; the first
// pass's n-tiles of 8 x rows; warps a block (16 vocab rows each), vocab
// rows a tile, columns a chunk, ring stages; blocks (one tile each at
// most, about kBlocksPerSm an SM); the first pass's shared memory.
struct SamplePlan {
  int passes, row_cap, n_tiles, warps, vocab_tile, chunk, stages, blocks;
  size_t smem;
};
SamplePlan sample_plan(int N, int V, int sm_count) {
  using T = SampleTiles;
  SamplePlan p;
  const int n = N < T::kRowCap ? N : T::kRowCap;
  p.passes = (N + T::kRowCap - 1) / T::kRowCap;
  p.row_cap = T::kRowCap;
  p.n_tiles = (n + 7) / 8;
  p.warps = T::kVocabTile / 16;
  p.vocab_tile = T::kVocabTile;
  p.chunk = T::kChunk;
  p.stages = T::kStages;
  const int ntiles = (V + T::kVocabTile - 1) / T::kVocabTile;
  const int cap = T::kBlocksPerSm * sm_count;
  p.blocks = ntiles < cap ? ntiles : cap;
  p.smem = sample_smem(8 * p.n_tiles);
  return p;
}

bool bad_shape(int N, int H, int V, int sm_count) {
  return N <= 0 || V <= 0 || H <= 0 || (H & 3) != 0 || sm_count <= 0;
}

// Every pass of the score kernel: rows [r0, r0 + n) of x, seeds, logits
// and the candidates' columns.
template <typename XT, int NT>
cudaError_t score_t(const XT* x, const float* embed, const long long* seeds, float* logits,
                    float* pv, int* pi, int n, int N, int H, int V, int blocks, float temperature,
                    int logits_mode, cudaStream_t st) {
  auto kernel = score_kernel<XT, NT>;
  const size_t smem = sample_smem(8 * NT);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, 32 * SampleTiles::kVocabTile / 16, smem, st>>>(
      x, embed, seeds, logits, pv, pi, n, N, H, V, temperature, logits_mode);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t score(const XT* x, const float* embed, const long long* seeds, float* logits,
                  float* pv, int* pi, int N, int H, int V, int blocks, float temperature,
                  int logits_mode, cudaStream_t st) {
  constexpr int cap = SampleTiles::kRowCap;
  static_assert(cap == 64, "the n-tile counts below cover 64 rows");
  for (int r0 = 0; r0 < N; r0 += cap) {
    const int n = N - r0 < cap ? N - r0 : cap;
    const XT* xp = x + (int64_t)r0 * H;
    float* lp = logits_mode ? logits + (int64_t)r0 * V : nullptr;
    cudaError_t err;
#define APEX_SCORE(NT)                                                                     \
  case NT:                                                                                 \
    err = score_t<XT, NT>(xp, embed, seeds + r0, lp, pv + r0, pi + r0, n, N, H, V, blocks, \
                          temperature, logits_mode, st);                                   \
    break;
    switch ((n + 7) / 8) {
      APEX_SCORE(1)
      APEX_SCORE(2)
      APEX_SCORE(3)
      APEX_SCORE(4)
      APEX_SCORE(5)
      APEX_SCORE(6)
      APEX_SCORE(7)
      default: APEX_SCORE(8)
    }
#undef APEX_SCORE
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// The launch plan into out[9]: passes, rows a pass, the first pass's
// n-tiles of 8 x rows, warps a block, vocab rows a tile, columns a chunk,
// ring stages, blocks, the first pass's shared memory bytes.
extern "C" int apex_sample_plan(int N, int H, int V, int sm_count, int64_t* out) {
  if (bad_shape(N, H, V, sm_count)) return (int)cudaErrorInvalidValue;
  const SamplePlan p = sample_plan(N, V, sm_count);
  out[0] = p.passes;
  out[1] = p.row_cap;
  out[2] = p.n_tiles;
  out[3] = p.warps;
  out[4] = p.vocab_tile;
  out[5] = p.chunk;
  out[6] = p.stages;
  out[7] = p.blocks;
  out[8] = (int64_t)p.smem;
  return 0;
}

// x (N, H) float32 (x_dtype 0) or bfloat16 (1), aligned to 4 elements;
// embed (V, H) float32, 16-byte aligned; H % 4 == 0; seeds (N,) int64 holding
// uint32 values; tokens (N,) int32.  part_v / part_i: (nblocks, N)
// scratch, nblocks the plan's blocks (at most one a vocab tile).  top_k
// in (0, V) with temperature > 0 also needs logits (N, V) and tau (N,)
// scratch; otherwise those may be null.
extern "C" int apex_fused_sample(const void* x, const void* embed,
                                 const void* seeds, void* tokens, void* part_v,
                                 void* part_i, void* logits, void* tau, int N,
                                 int H, int V, int nblocks, float temperature,
                                 int top_k, int x_dtype, void* stream) {
  if (bad_shape(N, H, V, 1) || x_dtype < 0 || x_dtype > 1) return (int)cudaErrorInvalidValue;
  const int ntiles = (V + SampleTiles::kVocabTile - 1) / SampleTiles::kVocabTile;
  if (nblocks <= 0 || nblocks > ntiles) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool use_top_k = temperature > 0.f && top_k > 0 && top_k < V;
  if (use_top_k && (logits == nullptr || tau == nullptr)) return (int)cudaErrorInvalidValue;
  const long long* sd = (const long long*)seeds;
  float* pv = (float*)part_v;
  int* pi = (int*)part_i;
  cudaError_t err =
      x_dtype == 0
          ? score((const float*)x, (const float*)embed, sd, (float*)logits, pv, pi, N, H, V,
                  nblocks, temperature, use_top_k, st)
          : score((const __nv_bfloat16*)x, (const float*)embed, sd, (float*)logits, pv, pi, N,
                  H, V, nblocks, temperature, use_top_k, st);
  if (err != cudaSuccess) return (int)err;
  if (use_top_k) {
    const int chunk = (V + nblocks - 1) / nblocks;
    kth_kernel<<<N, kThreads, 0, st>>>((const float*)logits, (float*)tau, V, top_k);
    logits_sample_kernel<<<dim3(nblocks, N), kThreads, 0, st>>>(
        (const float*)logits, (const float*)tau, sd, pv, pi, N, V, chunk, temperature);
  }
  reduce_kernel<<<N, kThreads, 0, st>>>(pv, pi, (int*)tokens, N, nblocks);
  return (int)cudaGetLastError();
}
