// Fused LM-head cross entropy for Hopper (sm_90a): forward, dx, dembed.
//
// Replaces apex_tpu/ops/fused_ce_pallas.py:
//   ce_fwd_kernel (+ ce_fwd_combine) <- `_fwd_kernel`    (launcher `fused_ce_fwd_pallas`)
//   ce_bwd_kernel<..., false> (dx)   <- `_dx_kernel`     (launcher `fused_ce_bwd_pallas`)
//   ce_bwd_kernel<..., true> (dembed) <- `_dembed_kernel` (launcher `fused_ce_bwd_pallas`)
//
// Inputs: x (N, H) fp32 or bf16, embed (V, H) fp32 or bf16, t (N,) int32
// target ids, lse and g (N,) fp32.  Outputs: m, l, tgt (N,) fp32 (the
// row max of the logits, the sum of exp at that max, the raw target
// logit), dx (N, H) in x's dtype, dembed (V, H) fp32.  H % 16 == 0,
// H <= 1024.
//
// Numerics, as the Pallas kernels with their default bf16 dot dtype:
// x and embed are rounded to bf16 (nearest even) before x . e^T, which
// accumulates in fp32 on the tensor cores (mma.sync.m16n8k16).  Columns
// past V weigh 0 and a target hit counts only on a valid column.
// Forward, per vocab tile: m_new = max(m, max s), l = l * exp(m -
// m_new) + sum exp(s - m_new), tgt += s[t].  Backward: p = exp(s - lse)
// (as exp2(s log2 e - lse log2 e)), d = (p - onehot(t)) * g in fp32, d
// rounded to bf16 before d . e (dx) and d^T . x (dembed); rows past N
// and V are zeroed in the tiles and in d before any product (0 * garbage
// = NaN otherwise).
//
// Bound on the H100 at GPT-124M training shapes (N = 8192, H = 768,
// V = 50304): tensor-core operations.  The forward is 2 N V H = 0.633
// TFLOP (0.64 ms at 989 TFLOP/s); dx and dembed recompute s and do one
// more product each, 1.27 TFLOP (1.28 ms) each.  The bytes that must
// move (x, the fp32 embed once, the outputs) are 167 MB forward.
//
// Forward: a GEMM tiling with the softmax statistics as its epilogue.
// Both operands come to the kernel as bf16: an fp32 x or embed is
// converted once a call by `ce_to_bf16` into the caller's scratch, with
// the tiles' rounding (nearest even), so no bit of s moves; the embed's
// copy halves the bytes every block streams and takes the conversion out
// of the tile loop.  A block (FwdTiles: 8 warps) owns a 128-row x tile
// and walks its vocab split in 256-row tiles; the tiles' 64-column
// chunks of x and of the embed come by 16-byte cp.async straight into
// the padded layout ldmatrix reads (row stride 72), through a ring of
// two chunks that runs on across tile edges, so the next chunk's loads
// are in flight during a tile's epilogue.  One block barrier a chunk.
// Each warp owns a 64 x 64 piece of s in registers (128 fp32 a thread):
// every ldmatrix feeds four mma (8 ldmatrix for 32 mma a 16-deep step,
// where 16 x 64 pieces took 5 for 8).  When a tile's s is whole, each
// lane folds its 16 columns of each of its 8 rows into its own running
// (m, l, tgt) in base 2 (exp2(s log2 e - m log2 e) on the SFU's
// ex2.approx), with no shuffle;
// after the walk the 16 lanes of a row are merged in lane order through
// shared memory.  The 64 row tiles of N = 8192 are split over the vocab
// by gridDim.y to fill 132 SMs (128 blocks of 98-99 tiles), and
// `ce_fwd_combine` merges the splits in split order with the tp formula
// of ops/fused_ce.py (m = max m_s, l = sum l_s exp(m_s - m), tgt = sum
// tgt_s).  L2 traffic at GPT-124M: the x tile again for every vocab
// tile and the embed copy once for every row tile, 7.4 GB (the fp32
// stream of the earlier design read 9.9).  The width is a run-time
// argument: the chunks take any H % 16 == 0.  One apex_ce_fwd call (the
// copies, the split kernel, the combine) is one launch in the counter
// of the wrapper.
//
// dx and dembed: one kernel template of W warps (BwdH768: 8 warps, 64
// own rows, K = 4; BwdH1024, above H = 768: 12 warps, 32 own rows, K =
// 6).  A block owns ROWS rows of one operand (x for dx, embed for
// dembed), converted to bf16 once as its tile loads, and streams the
// other operand in tiles of SR = 32 rows x all of H; the accumulator
// (ROWS x H fp32) lives in registers, each warp owning the 16-column
// groups warp, warp + W, ... of H (192 registers a thread at ROWS = 64,
// H = 768, W = 8), which caps ROWS at 64 (32 above H = 768, where the
// own tile and two streamed tiles would not fit in shared memory).
//  - The streamed operand is read whole by every block (N / 64 blocks
//    of dx each read the embed), so it is bf16: an fp32 streamed operand
//    (the embed of dx in training, x of dembed on the fp32 path) is
//    converted once a call by `ce_to_bf16` into scratch the wrapper
//    allocates, with the rounding of the tiles (dx's L2 traffic is 9.9
//    GB at GPT-124M, not the 19.8 of an fp32 stream).  One wrapper call
//    is still one launch in its counter.
//  - Streamed tiles come by 16-byte cp.async straight into the padded
//    row-major tile (row stride H + 8) that ldmatrix reads, through a
//    two-stage ring: the next tile is in flight while this one is
//    multiplied.  dembed's lse, g and t of a tile come with it by 4-byte
//    cp.async.
//  - s = own . tile^T (ROWS x SR) is split over H: the warps form KG
//    groups, each computing a partial s over a contiguous slice of the
//    16-column steps of H, so a warp's piece of s is larger (32 x 32 at
//    W = 8, K = 4) and each ldmatrix feeds two products (48 ldmatrix for
//    96 mma a warp a tile; unsplit, 16 x 16 pieces took 96).  Each
//    fragment tile of s has one owner group, which adds the other groups'
//    partials (staged in shared memory) to its own in group order 0, 1,
//    ..., never in the order they finish, computes d and stages it as
//    bf16.  The split moves the last bits of s from the unsplit sum,
//    never from run to run.
//  - d stays staged in shared memory (ROWS x (SR + 8) bf16) for d . tile:
//    every warp reads d for all own rows once per 16 streamed rows and
//    reuses it across its column groups of H (20 ldmatrix for 96 mma a
//    warp).  Keeping d in registers would save the 5 KB stage but give up
//    that reuse.
//  - Three block-wide barriers a streamed tile: the ring's head (the tile
//    landed, the other stage and d free), after the partials, after d.
//  - The widths of the repo's GPT configurations (768, 1024) are
//    compile-time constants of their own instantiations: the score loop
//    unrolls, tile addresses fold to constant offsets, and the K = 4
//    kernel at 768 fits its 254 registers without a spill.  Other widths
//    take H at run time.
// What bounds it (GPT-124M, bf16 x, fp32 embed, an H100 80GB HBM3 at
// 700 W; `python -m apex_tpu_torch.ce_bwd_tiles`, whose ablations take
// parts of the tile loop out): dx 6.0 ms and dembed 5.9, 4.6x their
// bound.  The loop with both products taken out is the stream alone,
// 2.7 ms (9.9 GB from L2 at about 3.7 TB/s); with the copies taken out,
// the products alone, 4.6 ms (1.27 TFLOP at about 275 TFLOP/s, 28 % of
// the tensor cores' peak).  So the copies are only partly hidden, and
// the products are slow on their own: fewer ldmatrix (K = 4 against 1:
// 11 %) and the fixed width (9-11 %) helped, more warps a scheduler (12
// or 16) did not.  The next steps are wgmma, with a producer warp taking
// the copies off the consumers, and TMA.  K = 4 ran 6-7 % faster than K
// = 2, and 16-row tiles 20 % slower.  At H = 1024
// every block streams the whole table for 32 own rows (26 GB from L2 at
// V = 50304); there 12 warps and K = 6 ran 7-11 % faster than 8 warps
// and K = 4.
// Each output element is summed by one block in a fixed order (no
// atomics), so two backward passes give bitwise-equal dx and dembed.
// ops/fused_ce_kernels states the tile plan for the CPU tests
// (`ce_bwd_plan`), and apex_ce_bwd_plan reports what the launches use.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using apex_mma::bf16;
using apex_mma::cp_async16;
using apex_mma::cp_async4;
using apex_mma::cp_async_commit;
using apex_mma::cp_async_wait;
using apex_mma::ld_a;
using apex_mma::ld_b_kn;
using apex_mma::ld_b_nk;
using apex_mma::ld_b_nk1;
using apex_mma::mma16816;
using apex_mma::pack2;

constexpr int kMaxHidden = 1024;
constexpr int kSms = 132;           // the H100's SMs: the forward's grid aims at them
constexpr float kNegInf = -1e30f;
constexpr float kMasked = -2e30f;   // a column past V: below every running max
constexpr float kLog2e = 1.4426950408889634f;

// ------------------------------------------------------------------ forward
// The forward's tile plan: x rows and vocab rows of a block tile, the
// columns of H a ring stage holds, ring stages, the warps' layout (kWarpsM
// down the rows by kWarpsN across the vocab: each warp owns a (kRows /
// kWarpsM) x (kCols / kWarpsN) piece of s) and the blocks an SM holds.
struct FwdTiles {
  static constexpr int kRows = 128;
  static constexpr int kCols = 256;
  static constexpr int kChunk = 64;
  static constexpr int kStages = 2;
  static constexpr int kWarpsM = 2;
  static constexpr int kWarpsN = 4;
  static constexpr int kBlocksPerSm = 1;
};

// 2^x by the SFU alone (ex2.approx.ftz: relative error under 2^-22; a
// very negative x gives 0), for the forward's N x V exponentials.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Shared memory of a forward block: the ring (each stage the x rows and
// the vocab rows of a chunk, bf16, row stride chunk + 8) and the rows'
// target ids.  The rows' partial (m, l, tgt) of every lane are merged
// through the ring's memory after the walk.
__host__ __device__ constexpr size_t fwd_smem(int rows, int cols, int chunk, int stages) {
  return (size_t)stages * (rows + cols) * (chunk + 8) * sizeof(bf16) + (size_t)rows * sizeof(int);
}

// Block (row tile blockIdx.x, vocab split blockIdx.y): the partial (m, l,
// tgt) of its rows over vocab tiles [y * tps, (y + 1) * tps) into
// part[(k * S + y) * N + n], k = 0 (m), 1 (l), 2 (tgt), S = gridDim.y.
// x and e are bf16 (the wrapper's copies of fp32 operands).  The block
// walks its tiles' chunks (vocab tile c / KC, columns (c % KC) BK..) through
// a ring of STAGES chunks; each warp holds its MW x NW piece of s in
// registers over H, then folds it into its lanes' running (m, l, tgt):
// each lane keeps its own for its columns, merged once at the end.
template <int BM, int BN, int BK, int STAGES, int WM, int WN, int MINB>
__global__ void __launch_bounds__(32 * WM * WN, MINB)
ce_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ e, const int* __restrict__ tid,
              float* __restrict__ part, int N, int H, int V, int tps) {
  constexpr int kThreads = 32 * WM * WN, LD = BK + 8, VPR = BK / 8;
  constexpr int MW = BM / WM, NW = BN / WN, MT = MW / 16, NT = NW / 8;
  constexpr int kStage = (BM + BN) * LD;  // elements of a stage
  constexpr int kLanes = 4 * WN;          // lanes that hold a part of one row
  static_assert(MW % 16 == 0 && NW % 16 == 0 && BK % 16 == 0 && STAGES >= 2,
                "a warp's piece of s is whole 16 x 16 tiles");
  static_assert((size_t)3 * BM * kLanes * sizeof(float) <= (size_t)STAGES * kStage * sizeof(bf16),
                "the merge of the lanes' partials fits the ring");
  extern __shared__ __align__(128) char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  int* sT = reinterpret_cast<int*>(ring + STAGES * kStage);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const int64_t n0 = (int64_t)blockIdx.x * BM;
  const int rows = N - n0 < BM ? (int)(N - n0) : BM;
  const int nv = (V + BN - 1) / BN, KC = (H + BK - 1) / BK;
  const int vt0 = blockIdx.y * tps, vt1 = min(nv, vt0 + tps);
  const int steps = (vt1 - vt0) * KC;

  // chunk c into stage c % STAGES by 16-byte cp.async: x rows 0..BM-1,
  // then vocab rows; rows past N or V and columns past H are zeros
  auto issue = [&](int c) {
    if (c < steps) {
      const int64_t v0 = (int64_t)(vt0 + c / KC) * BN;
      const int k0 = (c % KC) * BK;
      bf16* dst = ring + (c % STAGES) * kStage;
#pragma unroll
      for (int i = threadIdx.x; i < (BM + BN) * VPR; i += kThreads) {
        const int r = i / VPR, k = k0 + (i % VPR) * 8;
        const bool is_x = r < BM;
        const int64_t row = is_x ? n0 + r : v0 + (r - BM);
        const bool ok = k < H && (is_x ? r < rows : row < V);
        const bf16* src = (is_x ? x : e) + (ok ? row * H + k : 0);
        cp_async16(dst + r * LD + (i % VPR) * 8, src, ok ? 16 : 0);
      }
    }
    cp_async_commit();  // empty past the walk: the wait counts stay the same
  };
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) issue(c);
  for (int i = threadIdx.x; i < BM; i += kThreads) {
    const int id = i < rows ? tid[n0 + i] : -1;
    sT[i] = id < V ? id : -1;  // an id outside [0, V) hits nothing
  }

  // this lane's rows: wm MW + 16 i + g + 8 h; its columns of a tile: wn NW
  // + 8 j + 2 t + q (acc[i][j][2 h + q])
  float m[MT][2], l[MT][2], tg[MT][2], acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) m[i][h] = kNegInf, l[i][h] = 0.f, tg[i][h] = 0.f;
  for (int c = 0; c < steps; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk c landed; every warp is done with chunk c - 1's stage
    issue(c + STAGES - 1);
    const int kc = c % KC;
    if (kc == 0) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
    }
    const bf16* sX = ring + (c % STAGES) * kStage;
    const bf16* sE = sX + BM * LD;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) ld_a(a[i], sX, LD, wm * MW + 16 * i, kk, lane);
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        uint32_t b[4];
        ld_b_nk(b, sE, LD, wn * NW + 16 * p, kk, lane);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma16816(acc[i][2 * p], a[i], b[0], b[1]);
          mma16816(acc[i][2 * p + 1], a[i], b[2], b[3]);
        }
      }
    }
    if (kc == KC - 1) {  // the tile's s is whole: fold it into the running (m, l, tgt)
      const int vt = vt0 + c / KC, col0 = vt * BN + wn * NW + 2 * t;
      if ((vt + 1) * BN > V) {  // the last tile: columns past V weigh 0
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (col0 + 8 * j + (q & 1) >= V) acc[i][j][q] = kMasked;
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float mx = m[i][h];
#pragma unroll
          for (int j = 0; j < NT; ++j)
            mx = fmaxf(mx, fmaxf(acc[i][j][2 * h], acc[i][j][2 * h + 1]));
          const float ms = mx * kLog2e;  // exp(s - mx) = exp2(s log2 e - mx log2 e)
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int q = 0; q < 2; ++q) sum += fast_exp2(fmaf(acc[i][j][2 * h + q], kLog2e, -ms));
          // a lane whose columns were all past V so far holds l = 0 at the
          // initial kNegInf, and when this tile leaves its max there, fmaf's
          // residual of kNegInf log2 e is +6.4e21: exp2 gives inf and 0 inf
          // NaN.  Such an l stays 0 (bitwise what a finite factor gives).
          // A vocab split of the last, partial tile alone has such lanes
          // (tp 2 at GPT-345M's vocab, 1024 rows: ROADMAP.md section 3).
          const float kept = l[i][h] == 0.f ? 0.f
                                            : l[i][h] * fast_exp2(fmaf(m[i][h], kLog2e, -ms));
          l[i][h] = kept + sum;
          m[i][h] = mx;
          const int rel = sT[wm * MW + 16 * i + g + 8 * h] - col0;
          if (rel >= 0 && rel < NW && (rel & 6) == 0) {  // the target is this lane's column
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
              for (int q = 0; q < 2; ++q)
                if (8 * j + q == rel) tg[i][h] += acc[i][j][2 * h + q];
          }
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free
  // every lane's (m, l, tgt) of its rows, then one thread a row merges
  // the row's kLanes partials in lane order (warp wn, then t)
  float* sM = reinterpret_cast<float*>(ring);
  float* sL = sM + BM * kLanes;
  float* sG = sL + BM * kLanes;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = (wm * MW + 16 * i + g + 8 * h) * kLanes + wn * 4 + t;
      sM[o] = m[i][h], sL[o] = l[i][h], sG[o] = tg[i][h];
    }
  __syncthreads();
  const int64_t S = gridDim.y;
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const float* pm = sM + r * kLanes;
    float mr = kNegInf, lr = 0.f, gr = 0.f;
#pragma unroll
    for (int k = 0; k < kLanes; ++k) mr = fmaxf(mr, pm[k]);
#pragma unroll
    for (int k = 0; k < kLanes; ++k) {
      lr += sL[r * kLanes + k] * fast_exp2((pm[k] - mr) * kLog2e);
      gr += sG[r * kLanes + k];
    }
    part[(0 * S + blockIdx.y) * N + n0 + r] = mr;
    part[(1 * S + blockIdx.y) * N + n0 + r] = lr;
    part[(2 * S + blockIdx.y) * N + n0 + r] = gr;
  }
}

// The S vocab splits' partials of each row, merged in split order.
__global__ void __launch_bounds__(256)
ce_fwd_combine(const float* __restrict__ part, int S, int N, float* __restrict__ m_out,
               float* __restrict__ l_out, float* __restrict__ tgt_out) {
  const int64_t n = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (n >= N) return;
  float m = kNegInf, l = 0.f, tg = 0.f;
  for (int s = 0; s < S; ++s) m = fmaxf(m, part[(int64_t)s * N + n]);
  for (int s = 0; s < S; ++s) {
    l += part[(int64_t)(S + s) * N + n] * expf(part[(int64_t)s * N + n] - m);
    tg += part[(int64_t)(2 * S + s) * N + n];
  }
  m_out[n] = m;
  l_out[n] = l;
  tgt_out[n] = tg;
}

// ------------------------------------------------------------ dx, dembed
// The backward's tile plan: own rows a block, streamed rows a tile, K
// groups of the score product, warps a block.  BwdH768 serves H <= 768,
// BwdH1024 the widths above (32 own rows: 64 and two streamed tiles do
// not fit).
struct BwdH768 {
  static constexpr int kRows = 64;
  static constexpr int kStream = 32;
  static constexpr int kGroups = 4;
  static constexpr int kWarps = 8;
};
struct BwdH1024 {
  static constexpr int kRows = 32;
  static constexpr int kStream = 32;
  static constexpr int kGroups = 6;
  static constexpr int kWarps = 12;
};

// 8 values of src as bf16 (nearest even), in one 16-byte vector.
template <typename T>
__device__ __forceinline__ uint4 bf16x8(const T* src) {
  if constexpr (sizeof(T) == 4) {
    const float4 a = *reinterpret_cast<const float4*>(src);
    const float4 b = *reinterpret_cast<const float4*>(src + 4);
    return make_uint4(pack2(a.x, a.y), pack2(a.z, a.w), pack2(b.x, b.y), pack2(b.z, b.w));
  } else {
    return *reinterpret_cast<const uint4*>(src);
  }
}

// dst[i] = bf16(src[i]) for n8 vectors of 8: the bf16 copy of an fp32
// streamed operand.
__global__ void __launch_bounds__(256)
ce_to_bf16(const float* __restrict__ src, bf16* __restrict__ dst, int64_t n8) {
  for (int64_t i = (int64_t)blockIdx.x * 256 + threadIdx.x; i < n8; i += (int64_t)gridDim.x * 256)
    reinterpret_cast<uint4*>(dst)[i] = bf16x8(src + 8 * i);
}

// acc[m][2i + j] += D[16m.., :SR] . Y[:SR, cols] for this warp's column
// groups n0 = 16 (warp + W i) < H (j: their two 8-column halves); D the
// staged d (16 MT x SR, stride SR + 8), Y the streamed tile (SR x H).
template <int MT, int NP, int SR, int W>
__device__ __forceinline__ void accumulate(float (&acc)[MT][2 * NP][4], const bf16* D,
                                           const bf16* Y, int ld, int H, int warp, int lane) {
#pragma unroll
  for (int k0 = 0; k0 < SR; k0 += 16) {
    uint32_t a[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) ld_a(a[m], D, SR + 8, 16 * m, k0, lane);
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int n0 = 16 * (warp + W * i);
      if (n0 < H) {  // warp-uniform
        uint32_t b[4];
        ld_b_kn(b, Y, ld, n0, k0, lane);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma16816(acc[m][2 * i], a[m], b[0], b[1]);
          mma16816(acc[m][2 * i + 1], a[m], b[2], b[3]);
        }
      }
    }
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack2(a, b);
}

// Shared memory of a backward block: the own tile and two stages of the
// streamed one (row stride H + 8, bf16), d (bf16, row stride sr + 8),
// the row data (fp32 / int32 lse, g, t: of the own rows for dx, of two
// stages' streamed rows for dembed) and kg - 1 partials of s (fp32).
__host__ __device__ constexpr size_t bwd_smem(int H, int rows, int sr, int kg, bool dembed) {
  return ((size_t)(rows + 2 * sr) * (H + 8) + (size_t)rows * (sr + 8)) * sizeof(bf16) +
         (size_t)3 * (dembed ? 2 * sr : rows) * sizeof(float) +
         (size_t)(kg - 1) * rows * sr * sizeof(float);
}

// DEMBED false: own = x (N rows), streamed = embed (V rows), out = dx.
// DEMBED true: own = embed (V rows), streamed = x (N rows), out = dembed.
// d[own r][streamed c] = (exp(s - lse[n]) - (v == t[n])) * g[n], with n
// the x row and v the vocab row of the pair; 0 past N or V.  The streamed
// operand is bf16 (the wrapper's copy when the caller's is fp32).
//   Warps: KG groups of WG = W / KG, group q scoring k-steps [q KS / KG,
// (q + 1) KS / KG) of the KS = H / 16.  A warp's piece of s is MI x NJ
// fragment tiles (16 x 8 each); the pieces of a group tile the ROWS x SR
// block, WR down and WC across.  Fragment tile idx = i NJ + j of every
// piece is owned by group idx % KG.
template <typename TOWN, typename TOUT, int ROWS, int SR, int KG, int W, int NP, int HC,
          bool DEMBED>
__global__ void __launch_bounds__(32 * W, 1)
ce_bwd_kernel(const TOWN* __restrict__ own, const bf16* __restrict__ str,
              const int* __restrict__ tid, const float* __restrict__ lse,
              const float* __restrict__ gr, TOUT* __restrict__ out, int n_own, int n_str,
              int h) {
  constexpr int MT = ROWS / 16, LDD = SR + 8, WG = W / KG, kThreads = 32 * W;
  constexpr int E = ROWS * SR / WG;  // elements of s a warp holds
  constexpr int MI = E >= 512 && ROWS >= 32 ? 2 : 1, NJ = E / (128 * MI);
  constexpr int WR = ROWS / (16 * MI), WC = SR / (8 * NJ);
  static_assert(W % KG == 0 && E >= 128 && WR * WC == WG && (NJ == 1 || NJ % 2 == 0),
                "the warps' pieces must tile the s block");
  // HC > 0: the width is HC, known here, so the score loop unrolls and
  // every tile address folds to a constant offset
  constexpr int KSG = HC > 0 && HC / 16 % KG == 0 ? HC / 16 / KG : 0;  // k-steps a group
  extern __shared__ __align__(128) char smem[];
  const int H = HC > 0 ? HC : h, ld = H + 8, vpr = H / 8, KS = H / 16;
  bf16* sO = reinterpret_cast<bf16*>(smem);
  bf16* sR = sO + ROWS * ld;  // two stages of SR rows
  bf16* sD = sR + 2 * SR * ld;
  float* sRow = reinterpret_cast<float*>(sD + ROWS * LDD);
  float4* sP = reinterpret_cast<float4*>(sRow + 3 * (DEMBED ? 2 * SR : ROWS));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int grp = warp / WG, wig = warp % WG;
  const int wr = (wig / WC) * 16 * MI, wc = (wig % WC) * 8 * NJ;  // this warp's piece of s
  const int ks0 = grp * KS / KG, ks1 = (grp + 1) * KS / KG;
  const int64_t o0 = (int64_t)blockIdx.x * ROWS;
  const int orows = n_own - o0 < ROWS ? (int)(n_own - o0) : ROWS;
  const int n_tiles = (n_str + SR - 1) / SR;

  // streamed tile `it` (rows past n_str zero) and, for dembed, its rows'
  // lse, g, t into stage it & 1.  This thread copies vectors threadIdx.x,
  // + 32 W, ... of the tile: row tr, vector tc, then steps of dr rows and
  // dc vectors.
  const int tr = threadIdx.x / vpr, tc = threadIdx.x % vpr;
  const int dr = kThreads / vpr, dc = kThreads % vpr;
  auto issue = [&](int it) {
    const int s0 = it * SR, valid = min(SR, n_str - s0);
    bf16* dst = sR + (it & 1) * SR * ld;
    const bf16* src = str + (int64_t)s0 * H;
    for (int r = tr, c = tc; r < SR;) {
      const bool ok = r < valid;
      cp_async16(dst + r * ld + 8 * c, ok ? src + (int64_t)r * H + 8 * c : str, ok ? 16 : 0);
      r += dr, c += dc;
      if (c >= vpr) c -= vpr, ++r;
    }
    if (DEMBED && threadIdx.x < SR) {
      float* rd = sRow + (it & 1) * 3 * SR + threadIdx.x;
      const bool ok = (int)threadIdx.x < valid;
      const int n = ok ? s0 + threadIdx.x : 0;
      cp_async4(rd, lse + n, ok ? 4 : 0);
      cp_async4(rd + SR, gr + n, ok ? 4 : 0);
      cp_async4(rd + 2 * SR, tid + n, ok ? 4 : 0);
    }
    cp_async_commit();
  };
  if (n_tiles > 0) issue(0);
  for (int c = threadIdx.x; c < ROWS * vpr; c += kThreads) {  // the own tile, as bf16
    const int r = c / vpr, col = (c % vpr) * 8;
    *reinterpret_cast<uint4*>(sO + r * ld + col) =
        r < orows ? bf16x8(own + (o0 + r) * H + col) : make_uint4(0u, 0u, 0u, 0u);
  }
  if (!DEMBED && threadIdx.x < ROWS) {  // dx: the own rows' lse, g, t
    const int r = threadIdx.x;
    sRow[r] = r < orows ? lse[o0 + r] : 0.f;
    sRow[ROWS + r] = r < orows ? gr[o0 + r] : 0.f;
    reinterpret_cast<int*>(sRow)[2 * ROWS + r] = r < orows ? tid[o0 + r] : -1;
  }
  float acc[MT][2 * NP][4] = {};
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<0>();
    __syncthreads();  // tile it landed; every warp is done with tile it - 1, d and the partials
    if (it + 1 < n_tiles) issue(it + 1);
    const int s0 = it * SR;
    const bf16* Y = sR + (it & 1) * SR * ld;
    // this group's partial s over its slice of H
    float s[MI][NJ][4] = {};
    auto score_step = [&](int ks) {
      uint32_t b[NJ][2];
      if constexpr (NJ == 1) {
        ld_b_nk1(b[0], Y, ld, wc, 16 * ks, lane);
      } else {
#pragma unroll
        for (int j = 0; j < NJ; j += 2) {
          uint32_t b4[4];
          ld_b_nk(b4, Y, ld, wc + 8 * j, 16 * ks, lane);
          b[j][0] = b4[0], b[j][1] = b4[1], b[j + 1][0] = b4[2], b[j + 1][1] = b4[3];
        }
      }
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        uint32_t a[4];
        ld_a(a, sO, ld, wr + 16 * i, 16 * ks, lane);
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma16816(s[i][j], a, b[j][0], b[j][1]);
      }
    };
    if constexpr (KSG > 0) {
#pragma unroll
      for (int kk = 0; kk < KSG; ++kk) score_step(ks0 + kk);
    } else {
#pragma unroll 2
      for (int ks = ks0; ks < ks1; ++ks) score_step(ks);
    }
    // partial slot of (writer group p, owner group o) for fragment tile idx of piece wig
    auto slot = [&](int p, int o, int idx) {
      return ((p - (p > o)) * WG * MI * NJ + wig * MI * NJ + idx) * 32 + lane;
    };
    if constexpr (KG > 1) {
#pragma unroll
      for (int idx = 0; idx < MI * NJ; ++idx)
        if (idx % KG != grp) {
          const float(&v)[4] = s[idx / NJ][idx % NJ];
          sP[slot(grp, idx % KG, idx)] = make_float4(v[0], v[1], v[2], v[3]);
        }
      __syncthreads();  // the partials written
    }
    // the owned tiles: s summed in group order, then d, staged as bf16
    constexpr int RN = DEMBED ? SR : ROWS;  // rows of the row data's lse, g, t
    const float* rd = DEMBED ? sRow + (it & 1) * 3 * SR : sRow;
    const int* rt = reinterpret_cast<const int*>(rd) + 2 * RN;
#pragma unroll
    for (int idx = 0; idx < MI * NJ; ++idx) {
      if (idx % KG != grp) continue;
      const int i = idx / NJ, j = idx % NJ;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int p = 0; p < KG; ++p) {
        float w[4] = {s[i][j][0], s[i][j][1], s[i][j][2], s[i][j][3]};
        if (p != grp) {
          const float4 f = sP[slot(p, grp, idx)];
          w[0] = f.x, w[1] = f.y, w[2] = f.z, w[3] = f.w;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] += w[q];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wr + 16 * i + g + 8 * h, c = wc + 8 * j + 2 * t;
        float d[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int n = DEMBED ? c + q : r;                     // the pair's x row in rd
          const int64_t vr = DEMBED ? o0 + r : s0 + c + q;      // and its vocab row
          d[q] = 0.f;
          if (r < orows && s0 + c + q < n_str)
            d[q] = (exp2f(fmaf(v[2 * h + q], kLog2e, -rd[n] * kLog2e)) -
                    (vr == rt[n] ? 1.f : 0.f)) * rd[RN + n];
        }
        *reinterpret_cast<uint32_t*>(sD + r * LDD + c) = pack2(d[0], d[1]);
      }
    }
    __syncthreads();  // d staged
    accumulate<MT, NP, SR, W>(acc, sD, Y, ld, H, warp, lane);
  }
  TOUT* dst = out + o0 * H;
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int n0 = 16 * (warp + W * i);
    if (n0 >= H) continue;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * m + g + 8 * h;
          if (r < orows)
            store2(dst + (int64_t)r * H + n0 + 8 * j + 2 * t, acc[m][2 * i + j][2 * h],
                   acc[m][2 * i + j][2 * h + 1]);
        }
  }
}

// The forward's plan, as launched: tiles, ring, warps, vocab splits
// (about kSms x blocks an SM blocks in all), shared memory, and the
// caller's scratch: the splits' partials (3, S, N) fp32, then the bf16
// copies of an fp32 x and an fp32 embed, each from a 256-byte boundary.
struct FwdPlan {
  int rows, cols, chunk, stages, warps, splits;
  size_t smem, part_bytes, x_copy, e_copy;
};
size_t round256(size_t b) { return (b + 255) / 256 * 256; }
FwdPlan fwd_plan(int N, int H, int V, int x_dtype, int e_dtype) {
  using F = FwdTiles;
  const int row_blocks = (N + F::kRows - 1) / F::kRows;
  const int nv = (V + F::kCols - 1) / F::kCols;
  int S = row_blocks > 0 ? kSms * F::kBlocksPerSm / row_blocks : 1;
  S = S < 1 ? 1 : S > nv ? nv : S;
  const int tps = (nv + S - 1) / S;
  FwdPlan f;
  f.rows = F::kRows, f.cols = F::kCols, f.chunk = F::kChunk, f.stages = F::kStages;
  f.warps = F::kWarpsM * F::kWarpsN;
  f.splits = (nv + tps - 1) / tps;  // no split left empty
  f.smem = fwd_smem(F::kRows, F::kCols, F::kChunk, F::kStages);
  f.part_bytes = round256((size_t)3 * f.splits * N * sizeof(float));
  f.x_copy = x_dtype == 0 ? round256((size_t)N * H * sizeof(bf16)) : 0;
  f.e_copy = e_dtype == 0 ? round256((size_t)V * H * sizeof(bf16)) : 0;
  return f;
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

struct Problem {
  const void* x;
  const void* e;
  const int* t;
  int N, H, V;
  cudaStream_t st;
};

// The streamed operand as bf16: itself, or its copy in `scratch` (rows x
// H), converted here when it is fp32.
template <typename T>
cudaError_t streamed(const void* src, int64_t rows, int H, void* scratch, cudaStream_t st,
                     const bf16** out) {
  *out = (const bf16*)src;
  if constexpr (sizeof(T) == 4) {
    if (scratch == nullptr) return cudaErrorInvalidValue;
    const int64_t n8 = rows * H / 8;
    const int64_t want = (n8 + 255) / 256;
    const int blocks = want < 4096 ? (int)want : 4096;
    ce_to_bf16<<<blocks, 256, 0, st>>>((const float*)src, (bf16*)scratch, n8);
    *out = (const bf16*)scratch;
    return cudaGetLastError();
  }
  return cudaSuccess;
}

// The forward: the bf16 copies of fp32 operands, the split kernel, the
// combine.
cudaError_t fwd(const Problem& p, char* scratch, float* m, float* l, float* tgt, int x_dtype,
                int e_dtype) {
  using F = FwdTiles;
  if (scratch == nullptr) return cudaErrorInvalidValue;
  const FwdPlan f = fwd_plan(p.N, p.H, p.V, x_dtype, e_dtype);
  float* part = (float*)scratch;
  char* x_copy = scratch + f.part_bytes;
  const bf16 *xb, *eb;
  cudaError_t err = x_dtype == 0 ? streamed<float>(p.x, p.N, p.H, x_copy, p.st, &xb)
                                 : streamed<bf16>(p.x, p.N, p.H, nullptr, p.st, &xb);
  if (err != cudaSuccess) return err;
  err = e_dtype == 0 ? streamed<float>(p.e, p.V, p.H, x_copy + f.x_copy, p.st, &eb)
                     : streamed<bf16>(p.e, p.V, p.H, nullptr, p.st, &eb);
  if (err != cudaSuccess) return err;
  auto kernel = ce_fwd_kernel<F::kRows, F::kCols, F::kChunk, F::kStages, F::kWarpsM, F::kWarpsN,
                              F::kBlocksPerSm>;
  err = prepare(kernel, f.smem);
  if (err != cudaSuccess) return err;
  const int nv = (p.V + F::kCols - 1) / F::kCols, tps = (nv + f.splits - 1) / f.splits;
  kernel<<<dim3((p.N + F::kRows - 1) / F::kRows, f.splits), 32 * f.warps, f.smem, p.st>>>(
      xb, eb, p.t, part, p.N, p.H, p.V, tps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ce_fwd_combine<<<(p.N + 255) / 256, 256, 0, p.st>>>(part, f.splits, p.N, m, l, tgt);
  return cudaGetLastError();
}

// The backward's plan at width H, as launched: own rows, streamed rows a
// tile, K groups, warps.
struct BwdPlan {
  int rows, sr, kg, warps;
};
template <typename F>
BwdPlan plan_of() {
  return {F::kRows, F::kStream, F::kGroups, F::kWarps};
}
BwdPlan bwd_plan(int H) { return H > 768 ? plan_of<BwdH1024>() : plan_of<BwdH768>(); }

// F's kernel for widths up to MAXH (HC: the width, when fixed): each
// warp owns NP 16-column groups.
template <typename TOWN, typename TOUT, typename F, int MAXH, int HC, bool DEMBED>
cudaError_t bwd_t(const void* own, const bf16* str, const Problem& p, const float* lse,
                  const float* g, void* out, int n_own, int n_str) {
  constexpr int NP = (MAXH / 16 + F::kWarps - 1) / F::kWarps;
  auto kernel = ce_bwd_kernel<TOWN, TOUT, F::kRows, F::kStream, F::kGroups, F::kWarps, NP, HC,
                              DEMBED>;
  const size_t smem = bwd_smem(p.H, F::kRows, F::kStream, F::kGroups, DEMBED);
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(n_own + F::kRows - 1) / F::kRows, 32 * F::kWarps, smem, p.st>>>(
      (const TOWN*)own, str, p.t, lse, g, (TOUT*)out, n_own, n_str, p.H);
  return cudaGetLastError();
}

// The width's kernel: the widths of the repo's GPT configurations (768
// for GPT-124M, 1024 for GPT-345M) fixed at compile time, any other H
// a runtime argument.
template <typename TOWN, typename TOUT, bool DEMBED>
cudaError_t bwd_w(const void* own, const bf16* str, const Problem& p, const float* lse,
                  const float* g, void* out, int n_own, int n_str) {
#define APEX_CE_BWD(F, MAXH, HC) \
  bwd_t<TOWN, TOUT, F, MAXH, HC, DEMBED>(own, str, p, lse, g, out, n_own, n_str)
  if (p.H == 768) return APEX_CE_BWD(BwdH768, 768, 768);
  if (p.H == 1024) return APEX_CE_BWD(BwdH1024, 1024, 1024);
  return p.H > 768 ? APEX_CE_BWD(BwdH1024, 1024, 0) : APEX_CE_BWD(BwdH768, 768, 0);
#undef APEX_CE_BWD
}

// which: 1 = dx (own x, streamed embed), 2 = dembed (own embed, streamed x).
template <typename TX, typename TE>
cudaError_t bwd(int which, const Problem& p, const float* lse, const float* g, void* out,
                void* scratch) {
  const bf16* str;
  cudaError_t err = which == 1 ? streamed<TE>(p.e, p.V, p.H, scratch, p.st, &str)
                               : streamed<TX>(p.x, p.N, p.H, scratch, p.st, &str);
  if (err != cudaSuccess) return err;
  if (which == 1) return bwd_w<TX, TX, false>(p.x, str, p, lse, g, out, p.N, p.V);
  return bwd_w<TE, float, true>(p.e, str, p, lse, g, out, p.V, p.N);
}

bool bad_problem(const Problem& p, int x_dtype, int e_dtype) {
  return p.H <= 0 || p.H % 16 != 0 || p.H > kMaxHidden || p.N < 0 || p.V <= 0 || x_dtype < 0 ||
         x_dtype > 1 || e_dtype < 0 || e_dtype > 1;
}

// which: 0 = forward (o0..o3: m, l, tgt, the plan's scratch), 1 = dx, 2 =
// dembed (o0: the output, o1: the streamed operand's bf16 scratch or
// null).  x_dtype, e_dtype: 0 = float32, 1 = bfloat16.
int dispatch(int which, const Problem& p, const float* lse, const float* g, void* o0,
             void* o1, void* o2, void* o3, int x_dtype, int e_dtype) {
  if (bad_problem(p, x_dtype, e_dtype)) return (int)cudaErrorInvalidValue;
  if (p.N == 0) return 0;
  if (which == 0)
    return (int)fwd(p, (char*)o3, (float*)o0, (float*)o1, (float*)o2, x_dtype, e_dtype);
  cudaError_t err;
  if (x_dtype == 1 && e_dtype == 0)
    err = bwd<bf16, float>(which, p, lse, g, o0, o1);
  else if (x_dtype == 1)
    err = bwd<bf16, bf16>(which, p, lse, g, o0, o1);
  else if (e_dtype == 0)
    err = bwd<float, float>(which, p, lse, g, o0, o1);
  else
    err = bwd<float, bf16>(which, p, lse, g, o0, o1);
  return (int)err;
}

}  // namespace

// The forward's plan into out[8]: x rows and vocab rows of a block tile,
// columns of H a ring stage, ring stages, warps a block, vocab splits,
// shared memory bytes of a block, bytes of the caller's scratch (the
// splits' partials and the bf16 copies of fp32 operands).
extern "C" int apex_ce_fwd_plan(int N, int H, int V, int x_dtype, int e_dtype, int64_t* out) {
  const Problem p = {nullptr, nullptr, nullptr, N, H, V, nullptr};
  if (bad_problem(p, x_dtype, e_dtype)) return (int)cudaErrorInvalidValue;
  const FwdPlan f = fwd_plan(N, H, V, x_dtype, e_dtype);
  out[0] = f.rows;
  out[1] = f.cols;
  out[2] = f.chunk;
  out[3] = f.stages;
  out[4] = f.warps;
  out[5] = f.splits;
  out[6] = (int64_t)f.smem;
  out[7] = (int64_t)(f.part_bytes + f.x_copy + f.e_copy);
  return 0;
}

// m, l, tgt (N,) fp32; scratch: the plan's bytes (16-byte aligned).  Up
// to four launches: the bf16 copies of fp32 x and embed, the split
// forward and the combine.
extern "C" int apex_ce_fwd(const void* x, const void* e, const void* t, void* scratch, void* m,
                           void* l, void* tgt, int N, int H, int V, int x_dtype, int e_dtype,
                           void* stream) {
  const Problem p = {x, e, (const int*)t, N, H, V, (cudaStream_t)stream};
  return dispatch(0, p, nullptr, nullptr, m, l, tgt, scratch, x_dtype, e_dtype);
}

// The backward's plan (which: 1 = dx, 2 = dembed) into out[7]: own rows
// a block, streamed rows a tile, K groups, warps a block, ring stages,
// shared memory bytes of a block, bytes of the streamed operand's bf16
// scratch (0 when it is bf16).
extern "C" int apex_ce_bwd_plan(int which, int N, int H, int V, int x_dtype, int e_dtype,
                                int64_t* out) {
  const Problem p = {nullptr, nullptr, nullptr, N, H, V, nullptr};
  if ((which != 1 && which != 2) || bad_problem(p, x_dtype, e_dtype))
    return (int)cudaErrorInvalidValue;
  const BwdPlan b = bwd_plan(H);
  const bool fp32_stream = (which == 1 ? e_dtype : x_dtype) == 0;
  out[0] = b.rows;
  out[1] = b.sr;
  out[2] = b.kg;
  out[3] = b.warps;
  out[4] = 2;
  out[5] = (int64_t)bwd_smem(H, b.rows, b.sr, b.kg, which == 2);
  out[6] = fp32_stream ? (int64_t)(which == 1 ? V : N) * H * (int64_t)sizeof(bf16) : 0;
  return 0;
}

// dx (N, H) in x's dtype.  scratch: (V, H) bf16 when the embed is fp32,
// else null.  Two launches when it is fp32: the conversion and dx.
extern "C" int apex_ce_dx(const void* x, const void* e, const void* t, const void* lse,
                          const void* g, void* dx, void* scratch, int N, int H, int V,
                          int x_dtype, int e_dtype, void* stream) {
  const Problem p = {x, e, (const int*)t, N, H, V, (cudaStream_t)stream};
  return dispatch(1, p, (const float*)lse, (const float*)g, dx, scratch, nullptr, nullptr,
                  x_dtype, e_dtype);
}

// dembed (V, H) fp32.  scratch: (N, H) bf16 when x is fp32, else null.
extern "C" int apex_ce_dembed(const void* x, const void* e, const void* t, const void* lse,
                              const void* g, void* de, void* scratch, int N, int H, int V,
                              int x_dtype, int e_dtype, void* stream) {
  const Problem p = {x, e, (const int*)t, N, H, V, (cudaStream_t)stream};
  return dispatch(2, p, (const float*)lse, (const float*)g, de, scratch, nullptr, nullptr,
                  x_dtype, e_dtype);
}
