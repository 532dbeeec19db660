// Streamed stage-2 REINFORCE reduction for Hopper (sm_90a), plain C interface.
//
// posfeat_lse_pass replaces posfeat_tpu/ops/pallas/reinforce.py:66
// (_pass1_kernel) and reinforce.py:88 (_pass2_kernel) with one pass;
// posfeat_reward_pass replaces reinforce.py:110 (_pass3_kernel);
// posfeat_reinforce_split prepares the operands that both read. The Python
// wrappers (posfeat_tpu_torch/ops/reinforce.py) check devices, dtypes, shapes
// and contiguity, allocate every output and scratch buffer, pack the reward
// pass's column operands, pass PyTorch's current stream, raise on a non-zero
// return code, and merge the per-row-tile partials that these kernels write.
//
// Both passes walk the affinity aff = T * f1 . f2^T - T of one batch element
// tile by tile and never write an m x n tensor. What bounds them: at the
// training path's shapes (B = 6, m = n = 4800, D = 128) each pass is a
// 2*B*m*n*D = 35.4 GFLOP product against 30 MB of inputs, so arithmetic
// bounds them. The JAX kernels run the product at Precision.HIGHEST, and
// T = 60 multiplies any error in f1 . f2^T: one TF32 product (~5e-4
// relative) would move a logit by ~0.03 and p by ~3%, far outside the
// reference's rtol 2e-4. No atomics: every sum has a fixed order, so results
// are deterministic. The ragged edge (m or n not a multiple of the tile, D
// not a multiple of the depth step) is zero-filled by the split and masked
// in the epilogues; nothing is padded in the caller's tensors. The TPU
// kernels carried their column sums across a sequential grid; here blocks
// run in any order and the wrapper merges the per-row-tile partials.
//
// The product runs on the tensor cores as 3xTF32. Each operand is split
// once, before the product: x = hi + lo, hi = cvt.rna.tf32(x), lo =
// cvt.rna.tf32(x - hi); each 8-deep step forms lo.hi + hi.lo + hi.hi on the
// tensor cores (the dropped lo.lo term is ~2^-22 relative), and the result
// joins an f32 running sum with an add rounded to nearest: the tensor
// cores' own accumulation truncates, and a chain of 48 MMAs per D = 128 dot
// moved the reduction's s0 by 0.7% on the card. Floor: 3 x 35.4 GFLOP at
// 495 TFLOP/s of TF32 = 0.215 ms per pass at D = 128.
// - wgmma.m64n128k8 (tf32), both operands K-major in shared memory, in
//   core matrices without swizzle ([depth / 4][rows][4] floats): f1 [m, D]
//   and f2 [n, D] lie that way in memory, so nothing is transposed.
// - A first kernel (lse_split_kernel) splits f1 and f2 into hi and lo once
//   per reduction, into scratch laid out as the tiles are read, so that
//   staging is bulk copies (async proxy, no fence, no thread work)
//   completing on mbarriers; both passes read the same scratch. A block
//   takes a 128-row tile of f1 (two warpgroups, 64 rows each) of one batch
//   element against every 128-column tile of f2 in turn; f2 comes in 16-deep
//   chunks (hi and lo, 16 KB each).
// - Both passes run one product loop per instance, so a pair's dot is
//   bit-identical in both: at a peaked pair the rounding of aff and of its
//   log-sum-exps cancels in the reward pass's lp = (aff - row_lse) +
//   (aff - col_lse).
//
// Two instances of each pass, by descriptor width:
// - Up to D = RESIDENT_D = 128 (lse_pass_kernel, reward_pass_kernel;
//   product_tiles): the block keeps its f1 tile resident as hi and lo
//   (2 x 64 KB at D = 128); 256 threads, thread 0 copies each f2 chunk two
//   chunks ahead into a ring of four, one block barrier per chunk, a
//   rounded add per 8-deep step with two accumulator sets taking turns;
//   the epilogues do not overlap the wgmmas.
// - Beyond it (lse_pass_streamed_kernel, reward_pass_streamed_kernel;
//   stream_producer, stream_product): a deeper f1 tile does not fit beside
//   a ring (256 KB at D = 256), so each ring buffer carries f1's 16-deep
//   chunk beside f2's (32 KB a buffer, NS = 6 of them), and f1 is read
//   again from L2 for every column tile. Warp specialised as the f32 conv
//   kernels are (fused_head_f32.cu): a producer warpgroup, whose one thread
//   keeps the ring full (setmaxnreg down to 24), and two consumer
//   warpgroups (up to 240 registers) that wait on full mbarriers and
//   release each buffer on an empty one: no block barrier in the loop.
//   Each 16-deep chunk's six products (one commit group, one asm block:
//   wgmma_chunk16_3xtf32) go into one of two accumulator sets that take
//   turns and join the running sum with one rounded add, so each
//   warpgroup keeps up to 12 wgmmas queued; a tile's depth is an even
//   count of chunks (tile_chunks), taken in pairs without a branch. The
//   consumers' waits are one asm block each (mbar_wait_asm): with the poll
//   loop in C++, ptxas capped their registers near 180, spilled the
//   accumulators and serialized every wgmma. Each warpgroup merges its own
//   64 rows' column partials behind a named barrier of its own, the
//   columns of a warp's 16 rows by reduce-scatters (56 shuffles a tile
//   where butterflies take 192), and the wrapper merges twice as many
//   partials rows. A block takes a range of a row tile's column tiles
//   (column_range, grid (row tiles, B, ranges)): the wrapper splits the
//   columns in up to four so that the blocks' waves leave the fewest tiles
//   on the longest path (at B = 6, m = n = 4800 on 132 SMs, 912 blocks of
//   at most 10 tiles, where 228 blocks of 38 fill two waves at most 86%),
//   and merges the rows' partials of the ranges. The block's place and
//   range are read anew where they are used (block_place), and T log2(e)
//   comes as a parameter, so that none of it holds a register across the
//   product loop: the reward pass's consumers use 237 of their 240.
// - Floor at D = 256: 0.429 ms per pass. On an H100 at 700 W
//   (tools/profile_torch_lse_stages.py --D 256) the loop without the
//   epilogues takes about 0.60 (lse) and 0.65 ms (reward), 66-72% of it;
//   the epilogues, which the tensor cores wait for, add about 0.19 and
//   0.23 ms. Not taken, each tried on the card or reckoned: the next
//   tile's first chunks issued before the epilogue (lse 1% faster with 8-36
//   B of spills, reward 3-6% slower: the epilogue then runs beside 128-192
//   registers in flight); one warpgroup held a few chunks behind the other
//   (no gain: the shared ring lets them drift 4 chunks at most, a third of
//   an epilogue); the reward pass's column operands loaded in pairs
//   (float2; no gain); accumulators in shared memory for separate epilogue
//   warps (acc and two sets need the consumers' 240 registers, which leave
//   the third warpgroup 24); a ping-pong of the warpgroups over whole
//   tiles (each f2 chunk held for half a tile, a ring of 256 KB, or read
//   twice).
//
// lse pass epilogue, in base 2 (v = log2(e) * aff, exp2 on the SFU): each
// warp holds 16 whole rows of the 128-column tile, so a row's online (max,
// sum exp) needs only its quad; each column gets (max, sum exp) over the
// warp's 16 rows by shuffles, then over the warps of the block (resident)
// or of the warpgroup (streamed) through shared memory, and one partials
// row per row tile (or half tile) is written in a fixed order; a row's
// (max, sum exp) over a column range is written where the columns split.
//
// reward pass epilogue: each thread forms, for its 2 rows x 32 columns, lp,
// p, both epipolar distances (in the plain version's rounded order), the
// decision and W, and adds into its rows' sums of W and p and its s0, max
// p and good pairs, first over the tile, then into running sums. The
// product's accumulator sets (192 registers) leave no room for more state
// between epilogues, so the block's row operands (line1, c1h, accept1,
// row_lse) and each thread's running sums live in shared memory; a column
// tile's operands (c2h, line2, accept2, col_lse: 4 KB, packed
// structure-of-arrays by the wrapper) come in by one bulk copy, one tile
// ahead, double-buffered. Column sums of W and p go over the warp's 16 rows
// by shuffles, then over the warps through shared memory, one partials row
// per row tile (or half tile). The ragged edge needs no mask per pair: a
// row beyond m gets a NaN line (never good), accept 0 and row_lse 1e30
// (p = 0), and the wrapper packs the columns beyond n the same way. The
// reward pass forms aff from the lse pass's dots with the lse pass's
// arithmetic (aff_log2), so that beside it the dots' errors (the tensor
// cores' truncating accumulation, one sign) and the roundings of aff cancel
// in lp = (aff - row_lse) + (aff - col_lse). Fed the log-sum-exps of the
// plain f32 product instead, nothing cancels, and at T = 60 the training
// path's s0 moves by up to ~1.6e-4 relative, inside the reference's rtol
// 2e-4; forming aff as fmaf(T, dot, -T) moved it by ~3e-4 beside the lse
// pass.
//
// Where the time goes: tools/profile_torch_lse_stages.py [--D 256] cuts
// copies of this file at the "staging" and "epilogue" comments.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int RESIDENT_D = 128;  // widest f1 tile kept resident; deeper ones stream beside f2
constexpr int LM = 128;          // rows of f1 per block (two warpgroups x 64) = columns of f2 per tile
constexpr int LKC = 16;          // depth of one f2 chunk: two 8-deep steps
constexpr int NBUF = 4;          // resident: f2 chunk buffers, chunk s + 2 loads while chunk s runs
constexpr int L_THREADS = 256;   // the threads that hold accumulators: 8 warps of 16 rows each
constexpr int CHUNK_FLOATS = 2 * LKC * LM;  // one f2 chunk, hi then lo: 16 KB
constexpr int SPLIT_THREADS = 256;
constexpr int N_COLOPS = 8;      // reward pass operands per column: c2h xyz, line2 xyz, accept2, col_lse
constexpr int N_TOT = 7;         // reward pass running sums per thread: rowW, rowW, p, p, s0, max p, good pairs
constexpr float kNeg = -1e30f, kFar = 1e30f;
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

// resident instances: dynamic shared memory, the product's (f1 hi/lo and
// the f2 chunk ring), then each pass's own, then mbarriers (NBUF for the
// ring, one for the resident f1 tile, the reward pass two more for its
// column operands)
constexpr int P_FLOATS = 2 * RESIDENT_D * LM + NBUF * CHUNK_FLOATS;
constexpr int P_BARS = NBUF + 1;
// + column (max, sum exp) per warp
constexpr size_t L_SMEM_BYTES = size_t(P_FLOATS + 2 * 8 * LM) * 4 + 8 * P_BARS;
// + column operands [2][N_COLOPS][LM], row operands [N_COLOPS][LM], column
// (W, p) per warp, each thread's N_TOT running sums
constexpr int R_FLOATS = 3 * N_COLOPS * LM + 2 * 8 * LM + N_TOT * L_THREADS;
constexpr size_t R_SMEM_BYTES = size_t(P_FLOATS + R_FLOATS) * 4 + 8 * (P_BARS + 2);

// streamed instances: a ring of NS buffers, each f2's chunk then f1's
// chunk of the same 16 depths; a producer warpgroup and two consumer
// warpgroups, whose registers the launch gives as 168 a thread and
// setmaxnreg hands on (24 to the producer, 240 to each consumer)
constexpr int NS = 6;
constexpr int S_BUF_FLOATS = 2 * CHUNK_FLOATS;  // 32 KB
constexpr int S_RING_FLOATS = NS * S_BUF_FLOATS;
constexpr int S_THREADS = 384;
constexpr int LAUNCH_REGS = 168, PRODUCER_REGS = 24, CONSUMER_REGS = 240;
static_assert(128 * PRODUCER_REGS + 256 * CONSUMER_REGS <= S_THREADS * LAUNCH_REGS, "over the launch's registers");
// + the lse pass's column partials; mbarriers: full[NS], empty[NS]
constexpr size_t SL_SMEM_BYTES = size_t(S_RING_FLOATS + 2 * 8 * LM) * 4 + 8 * 2 * NS;
// + the reward pass's own (as resident); mbarriers: + the column operands' full[2], empty[2]
constexpr size_t SR_SMEM_BYTES = size_t(S_RING_FLOATS + R_FLOATS) * 4 + 8 * (2 * NS + 4);
static_assert(R_SMEM_BYTES <= 232448 && SR_SMEM_BYTES <= 232448, "over a block's shared memory");

enum ArgError { kBadShape = -1, kGridTooLarge = -2, kRegisterBudget = -3 };

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// (m1, s1) <- merge of two (max, sum exp2(x - max)) pairs
__device__ __forceinline__ void lse2_merge(float& m1, float& s1, float m2, float s2) {
  const float M = fmaxf(m1, m2);
  s1 = s1 * fast_exp2(m1 - M) + s2 * fast_exp2(m2 - M);
  m1 = M;
}

// log2(e) * aff = log2(e) * (T * dot - T) from Tl = T * kLog2e, as both
// passes form it. The reward pass's aff is this times ln 2: at |aff| ~ 30
// a rounding is ~1e-6, so only the lse pass's own arithmetic on the same
// dots cancels in lp = (aff - row_lse) + (aff - col_lse); fmaf(T, dot, -T)
// moved the training path's s0 by 3e-4.
__device__ __forceinline__ float aff_log2(float dot, float Tl) { return fmaf(dot, Tl, -Tl); }

// count mbarriers from bar on, by thread 0; the caller syncs the block after
__device__ __forceinline__ void init_bars(uint32_t bar, int count) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < count; ++i) mbar_init(bar + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
}

// x [B, rows, D] split into TF32 hi and lo, in tiles of 128 rows laid out
// as the passes read them: [B][tile][chunk][hi, lo][cq][128][4], each
// chunk cq groups of 4 depths, zero beyond rows and D. In shared memory
// [depth / 4][rows][4] is what wgmma reads as K-major core matrices (4
// depths of 8 consecutive rows make one 128-byte core matrix), so a chunk
// is one contiguous bulk copy. One thread per float4 of hi and of lo; a
// row of x is read as float4s where D % 4 == 0 (rows 16-byte aligned),
// else one float at a time.
__global__ void __launch_bounds__(SPLIT_THREADS) lse_split_kernel(
    const float* __restrict__ x, int rows, int D, int tiles, int chunks, int cq,
    float* __restrict__ out) {
  const size_t i = size_t(blockIdx.x) * SPLIT_THREADS + threadIdx.x;  // within batch element b
  if (i >= size_t(tiles) * chunks * cq * LM) return;
  const int b = blockIdx.y, r = int(i % LM);
  const size_t g = i / LM;  // (tile, chunk, group)
  const int q = int(g % cq), c = int(g / cq % chunks), tile = int(g / cq / chunks);
  const int row = tile * LM + r, k = 4 * (c * cq + q);
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row < rows && k < D) {
    const float* src = x + (size_t(b) * rows + row) * D + k;
    if (D % 4 == 0) {
      v = __ldg(reinterpret_cast<const float4*>(src));
    } else {
      v.x = __ldg(src);
      if (k + 1 < D) v.y = __ldg(src + 1);
      if (k + 2 < D) v.z = __ldg(src + 2);
      if (k + 3 < D) v.w = __ldg(src + 3);
    }
  }
  float* o = out + ((((size_t(b) * tiles + tile) * chunks + c) * 2 * cq + q) * LM + r) * 4;
  split_store(o, o + cq * LM * 4, v);
}

// ------------------------------------------------------------ epilogues
//
// Shared by both instances of each pass. acc[4j + 2h + e] holds the dot of
// the thread's row g + 8h of its warp's 16 and column 8j + 2t + e of the
// tile (g = lane / 4, t = lane % 4).

// one step of a reduce-scatter across the lanes that differ in bit M: of
// x[0 .. 2 HALF), the lane with the bit set keeps x[HALF .. 2 HALF) combined
// with its partner's by op, the other x[0 .. HALF), both in x[0 .. HALF)
template <int M, int HALF, class Op>
__device__ __forceinline__ void scatter_step(float* x, int lane, Op op) {
  const bool hi = lane & M;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float recv = __shfl_xor_sync(0xffffffffu, hi ? x[i] : x[i + HALF], M);
    x[i] = op(hi ? x[i + HALF] : x[i], recv);
  }
}

// x[k] (k < N, N = 16 or 32) combined by op over the warp's 8 lanes of the
// same t (lane bits 2-4): lane (g, t) ends with k = (N / 8) g .. (N / 8) g +
// N / 8 - 1 in x[0 .. N / 8). 28 shuffles for N = 32 where a butterfly per
// value takes 96.
template <int N, class Op>
__device__ __forceinline__ void scatter(float (&x)[N], int lane, Op op) {
  scatter_step<16, N / 2>(x, lane, op);
  scatter_step<8, N / 4>(x, lane, op);
  scatter_step<4, N / 8>(x, lane, op);
}

// The lse pass's share of one thread in the column tile at col0: acc turned
// into base-2 aff, v = log2(e) * (T * dot - T); its two rows' running (max,
// sum exp2) rm, rs updated over its 32 columns; each column's (max, sum
// exp2) over the warp's 16 rows into cMw, cSw (the warp's partials row):
// by butterflies and the lanes with g = 0, or (SCATTER) by reduce-scatters,
// the maxima read back from cMw, and every lane writing its 4 columns.
template <bool SCATTER>
__device__ __forceinline__ void lse_tile(float (&acc)[64], int col0, int n, int g, int t, const bool (&rok)[2],
                                         float Tl, float (&rm)[2], float (&rs)[2], float* cMw, float* cSw) {
  bool cok[16][2];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) cok[j][e] = col0 + 8 * j + 2 * t + e < n;
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = aff_log2(acc[i], Tl);

  // rows: online over this thread's 32 columns
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float tmax = kNeg;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (cok[j][e]) tmax = fmaxf(tmax, acc[4 * j + 2 * h + e]);
    if (tmax > rm[h]) {
      rs[h] *= fast_exp2(rm[h] - tmax);
      rm[h] = tmax;
    }
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (cok[j][e]) sum += fast_exp2(acc[4 * j + 2 * h + e] - rm[h]);
    rs[h] += sum;
  }

  // columns: (max, sum exp2) over the warp's 16 rows
  if constexpr (SCATTER) {
    const int lane = 4 * g + t;
    float x[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      x[k] = kNeg;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (rok[h]) x[k] = fmaxf(x[k], acc[4 * (k >> 1) + 2 * h + (k & 1)]);
    }
    // x[k], k = 2j + e, is column 8j + 2t + e: lane (g, t) keeps columns 16g + 2t + {0, 1, 8, 9}
    const auto col = [&](int i) { return 16 * g + 8 * (i >> 1) + 2 * t + (i & 1); };
    scatter(x, lane, [](float a, float b) { return fmaxf(a, b); });
#pragma unroll
    for (int i = 0; i < 4; ++i) cMw[col(i)] = x[i];
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 cm = *reinterpret_cast<const float2*>(cMw + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float cs = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (rok[h]) cs += fast_exp2(acc[4 * j + 2 * h + e] - (e ? cm.y : cm.x));
        x[2 * j + e] = cs;
      }
    }
    scatter(x, lane, [](float a, float b) { return a + b; });
#pragma unroll
    for (int i = 0; i < 4; ++i) cSw[col(i)] = x[i];
    return;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float cm = kNeg;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (rok[h]) cm = fmaxf(cm, acc[4 * j + 2 * h + e]);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, off));
      float cs = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (rok[h]) cs += fast_exp2(acc[4 * j + 2 * h + e] - cm);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) cs += __shfl_xor_sync(0xffffffffu, cs, off);
      if (g == 0) {
        cMw[8 * j + 2 * t + e] = cm;
        cSw[8 * j + 2 * t + e] = cs;
      }
    }
}

// column col's (max, sum exp2) over the NW warps' partials rows of cM, cS
// from cM (warp 0 of the NW) on, merged in order, into col_max[o] (natural
// units) and col_sum[o]
template <int NW>
__device__ __forceinline__ void lse_merge(const float* cM, const float* cS, int col, float* col_max,
                                          float* col_sum, size_t o) {
  float M = cM[col], S = cS[col];
#pragma unroll
  for (int w = 1; w < NW; ++w) lse2_merge(M, S, cM[w * LM + col], cS[w * LM + col]);
  col_max[o] = M * kLn2;
  col_sum[o] = S;
}

// after the last tile: row h's (max, sum exp2) of this thread merged over
// its quad (the warp holds all of each row's columns that the block takes)
__device__ __forceinline__ void lse_quad(float (&rm)[2], float (&rs)[2], int h) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    const float om = __shfl_xor_sync(0xffffffffu, rm[h], off);
    const float os = __shfl_xor_sync(0xffffffffu, rs[h], off);
    lse2_merge(rm[h], rs[h], om, os);
  }
}

// after the last tile: the rows' lse written to row_lse_w[0] and [8] (rows
// g and g + 8 of the warp) by the lanes with t = 0
__device__ __forceinline__ void lse_rows(float (&rm)[2], float (&rs)[2], int t, const bool (&rok)[2],
                                         float* row_lse_w) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lse_quad(rm, rs, h);
    if (t == 0 && rok[h]) row_lse_w[8 * h] = rm[h] * kLn2 + logf(fmaxf(rs[h], 1e-30f));
  }
}

// The reward pass's share of one thread in a column tile: rv the block's
// row operands [N_COLOPS][LM] (line1 xyz, c1h xyz, accept1, row_lse), lr0
// the thread's first row in the block, cvt the tile's column operands
// [N_COLOPS][LM]; column sums of W and p over the warp's 16 rows into cWw,
// cPw (the warp's partials row), by butterflies and the lanes with g = 0,
// or (SCATTER) by reduce-scatters, every lane writing 4 columns; the
// thread's running sums at my[k * L_THREADS], k < N_TOT, updated.
template <bool SCATTER>
__device__ __forceinline__ void reward_tile(const float (&acc)[64], const float* rv, int lr0, const float* cvt,
                                            int g, int t, float Tl, float thr, float good_reward, float bad_reward,
                                            float* cWw, float* cPw, float* my) {
  // row operands from shared memory: registers stay free for the
  // product's accumulators between epilogues
  float l1[2][3], c1[2][3], a1[2], rl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float* r = rv + lr0 + 8 * h;
#pragma unroll
    for (int k = 0; k < 3; ++k) l1[h][k] = r[k * LM], c1[h][k] = r[(3 + k) * LM];
    a1[h] = r[6 * LM];
    rl[h] = r[7 * LM];
  }
  // the tile's sums, added into the running ones at its end: no chain
  // of more than a tile's pairs in one f32 sum
  float rw[2] = {0.f, 0.f}, rp[2] = {0.f, 0.f}, s0 = 0.f, pmax = 0.f, ngood = 0.f;
  const float* cq = cvt + 2 * t;
  // column 8j + 2t + e: its pairs with the thread's two rows, their sums
  // of W and p into cw, cp
  const auto column = [&](int j, int e, float& cw, float& cp) {
    // the column's operands, one column at a time: the epilogue has the
    // registers that the product's accumulators leave
    const float* o = cq + 8 * j + e;
    const float c2x = o[0], c2y = o[LM], c2z = o[2 * LM], l2x = o[3 * LM], l2y = o[4 * LM], l2z = o[5 * LM];
    const float a2 = o[6 * LM], cl = o[7 * LM];
    cw = 0.f;
    cp = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float aff = aff_log2(acc[4 * j + 2 * h + e], Tl) * kLn2;
      const float lp = (aff - rl[h]) + (aff - cl);
      const float p = fast_exp2(lp * kLog2e);
      // three products, two sums, each rounded: the plain version's order
      const float d1 = fabsf(__fadd_rn(__fadd_rn(__fmul_rn(l1[h][0], c2x), __fmul_rn(l1[h][1], c2y)),
                                       __fmul_rn(l1[h][2], c2z)));
      const float d2 = fabsf(__fadd_rn(__fadd_rn(__fmul_rn(c1[h][0], l2x), __fmul_rn(c1[h][1], l2y)),
                                       __fmul_rn(c1[h][2], l2z)));
      const bool good = (d1 < thr) && (d2 < thr);
      const float w = a1[h] * a2 * (good ? good_reward : bad_reward) * p;
      s0 = fmaf(w, lp, s0);
      rw[h] += w;
      rp[h] += p;
      cw += w;
      cp += p;
      pmax = fmaxf(pmax, p);
      ngood += good ? 1.f : 0.f;
    }
  };
  if constexpr (SCATTER) {
    // in two halves of 16 columns, so that 32 sums, not 64, wait for
    // their reduce-scatter
    const auto sum = [](float a, float b) { return a + b; };
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float xw[16], xp[16];  // x[2 jj + e]: column 8 (8 half + jj) + 2t + e
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) column(8 * half + jj, e, xw[2 * jj + e], xp[2 * jj + e]);
      scatter(xw, 4 * g + t, sum);
      scatter(xp, 4 * g + t, sum);
      // lane (g, t) keeps columns 8 (8 half + g) + 2t + {0, 1}
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        cWw[8 * (8 * half + g) + 2 * t + i] = xw[i];
        cPw[8 * (8 * half + g) + 2 * t + i] = xp[i];
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float cw, cp;
        column(j, e, cw, cp);
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          cw += __shfl_xor_sync(0xffffffffu, cw, off);
          cp += __shfl_xor_sync(0xffffffffu, cp, off);
        }
        if (g == 0) {
          cWw[8 * j + 2 * t + e] = cw;
          cPw[8 * j + 2 * t + e] = cp;
        }
      }
  }
  my[0 * L_THREADS] += rw[0];
  my[1 * L_THREADS] += rw[1];
  my[2 * L_THREADS] += rp[0];
  my[3 * L_THREADS] += rp[1];
  my[4 * L_THREADS] += s0;
  my[5 * L_THREADS] = fmaxf(my[5 * L_THREADS], pmax);
  my[6 * L_THREADS] += ngood;
}

// column col's sums of W and p over the NW warps' partials rows of cW, cP
// from cW (warp 0 of the NW) on, in order, into colw_part[o], pcol_part[o]
template <int NW>
__device__ __forceinline__ void reward_merge(const float* cW, const float* cP, int col, float* colw_part,
                                             float* pcol_part, size_t o) {
  float W = 0.f, P = 0.f;
#pragma unroll
  for (int w = 0; w < NW; ++w) W += cW[w * LM + col], P += cP[w * LM + col];
  colw_part[o] = W;
  pcol_part[o] = P;
}

// after the last tile: this thread's rows' sums of W and p (over its quad:
// the warp holds all of each row's columns) into row_w and p_rowsum at
// rows row (g) and row + 8 (g + 8) where below m; returns the warp's
// totals (s0, max p, sum p, good pairs) in every lane
__device__ __forceinline__ float4 reward_rows(const float* my, int t, int row, int m, float* row_w,
                                              float* p_rowsum) {
  float rw[2] = {my[0], my[L_THREADS]}, rp[2] = {my[2 * L_THREADS], my[3 * L_THREADS]};
  float s0 = my[4 * L_THREADS], pmax = my[5 * L_THREADS], psum = rp[0] + rp[1], ngood = my[6 * L_THREADS];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      rw[h] += __shfl_xor_sync(0xffffffffu, rw[h], off);
      rp[h] += __shfl_xor_sync(0xffffffffu, rp[h], off);
    }
    if (t == 0 && row + 8 * h < m) {
      row_w[row + 8 * h] = rw[h];
      p_rowsum[row + 8 * h] = rp[h];
    }
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, off);
    pmax = fmaxf(pmax, __shfl_xor_sync(0xffffffffu, pmax, off));
    psum += __shfl_xor_sync(0xffffffffu, psum, off);
    ngood += __shfl_xor_sync(0xffffffffu, ngood, off);
  }
  return make_float4(s0, pmax, psum, ngood);
}

// the totals of NW warps, red[k * NW + w] for total k of warp w, summed
// (max p: maxed) in order into o[0 .. 3]
template <int NW>
__device__ __forceinline__ void reward_totals(const float* red, float* o) {
  float S0 = 0.f, PM = 0.f, PS = 0.f, NG = 0.f;
  for (int w = 0; w < NW; ++w) {
    S0 += red[0 * NW + w];
    PM = fmaxf(PM, red[1 * NW + w]);
    PS += red[2 * NW + w];
    NG += red[3 * NW + w];
  }
  o[0] = S0;
  o[1] = PM;
  o[2] = PS;
  o[3] = NG;
}

// ---------------------------------------------------------- the product
// (resident: D <= RESIDENT_D)

// The block's dots f1 . f2^T, 3xTF32, for its 128 rows of f1 (row tile
// blockIdx.x of batch element blockIdx.y) against each 128-column tile of
// f2 in turn, from the split tiles f1s and f2s; after each column tile,
// epi(acc, ct) with acc[4j + 2h + e] the dot of row 16 * warp + g + 8h of
// the block and column 8j + 2t + e of tile ct (g = lane / 4, t = lane % 4).
// smem holds the product's operands (P_FLOATS: f1 hi, f1 lo and the
// ring); bars NBUF + 1 initialised mbarriers. epi may sync the block;
// every step ends with a block barrier, a tile's last after its epilogue.
template <class Epilogue>
__device__ __forceinline__ void product_tiles(const float* __restrict__ f1s, const float* __restrict__ f2s,
                                              int D, int n, float* smem, uint32_t bars, Epilogue&& epi) {
  // aH, aL [RESIDENT_D / 4][LM][4], then the ring [NBUF][hi, lo][LKC / 4][LM][4]
  float* aH = smem;
  float* aL = aH + RESIDENT_D * LM;
  float* ring = aL + RESIDENT_D * LM;
  const uint32_t full_u = bars, a_bar = bars + 8 * NBUF;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int DP = (D + 7) & ~7;            // depth in whole 8-deep steps, zero-filled
  const int nck = (DP + LKC - 1) / LKC;   // chunks per column tile
  const int qa = 4 * nck;                 // groups of 4 depths of the f1 tile
  const int n_ct = (n + LM - 1) / LM, steps = n_ct * nck;
  // the block's f1 tile: one chunk of qa depth groups, hi then lo; f2's
  // column tiles: nck chunks each
  const float* A = f1s + (size_t(blockIdx.y) * gridDim.x + blockIdx.x) * 2 * qa * LM * 4;
  const float* Bm = f2s + size_t(blockIdx.y) * n_ct * nck * CHUNK_FLOATS;

  // chunk i (column tile i / nck, depths (i % nck) * LKC ...) into ring
  // buffer i % NBUF, by thread 0
  auto fetch = [&](int i) {
    const uint32_t bar = full_u + 8 * (i % NBUF);
    mbar_expect_tx(bar, CHUNK_FLOATS * 4);
    bulk_load(smem_u32(ring + (i % NBUF) * CHUNK_FLOATS), Bm + size_t(i) * CHUNK_FLOATS, CHUNK_FLOATS * 4, bar);
  };
  if (tid == 0) {
    mbar_expect_tx(a_bar, 2 * qa * LM * 16);
    bulk_load(smem_u32(aH), A, qa * LM * 16, a_bar);
    bulk_load(smem_u32(aL), A + qa * LM * 4, qa * LM * 16, a_bar);
    fetch(0);
    if (steps > 1) fetch(1);
  }
  const uint32_t aH_u = smem_u32(aH) + wg * 64 * 16, aL_u = smem_u32(aL) + wg * 64 * 16;
  const uint32_t ring_u = smem_u32(ring);
  mbar_wait(a_bar, 0);

  float acc[64], d0[64], d1[64];
  auto add = [&](float(&d)[64]) {
    fence_acc(d);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += d[i];
  };
  // Each 8-deep step's three products (small terms first) start from zero
  // in d0 (first step of a chunk) or d1 (second) and join the running sum
  // with rounded f32 adds: the tensor cores' accumulation truncates, so a
  // long chain of MMAs into one accumulator would drift by ~2^-23 of the
  // sum per MMA. A set is added, then reused, once the step two back has
  // retired, so that two steps' wgmmas stay queued. A column tile's first
  // chunk writes both sets without reading them, so that nothing holds
  // their registers through the epilogue before it.
  auto step = [&](int ct, int c, bool first) {
    const int s = ct * nck + c, kc = c * LKC, buf = s % NBUF;
    // staging begin: buffer (s + 2) % NBUF was last read by step s - 2's
    // wgmmas, which every thread waited for in step s - 1, before the
    // barrier that ended it
    if (tid == 0 && s + 2 < steps) fetch(s + 2);
    mbar_wait(full_u + 8 * buf, (s / NBUF) & 1);
    // staging end
    const int nks = min(LKC, DP - kc) / 8;
    auto issue = [&](float(&d)[64], int ks) {
      const uint32_t bo = buf * CHUNK_FLOATS * 4 + 2 * ks * LM * 16;
      // f1's depths kc + 8 ks .. in the resident tile
      const uint32_t ah_u = aH_u + ((kc + 8 * ks) / 4) * LM * 16;
      const uint32_t al_u = aL_u + ((kc + 8 * ks) / 4) * LM * 16;
      const uint64_t ah = desc_interleave(ah_u, LM * 16, 128), al = desc_interleave(al_u, LM * 16, 128);
      const uint64_t bh = desc_interleave(ring_u + bo, LM * 16, 128);
      const uint64_t bl = desc_interleave(ring_u + bo + LKC * LM * 4, LM * 16, 128);
      wgmma_fence();
      if (first)
        wgmma_m64n128k8_tf32_first(d, al, bh);
      else
        wgmma_m64n128k8_tf32(d, al, bh, 0);
      wgmma_m64n128k8_tf32(d, ah, bl, 1);
      wgmma_m64n128k8_tf32(d, ah, bh, 1);
      wgmma_commit();
      fence_acc(d);
    };
    wgmma_wait<1>();
    if (!first) add(d0);
    issue(d0, 0);
    if (nks == 2) {
      wgmma_wait<1>();
      if (!first) add(d1);
      issue(d1, 1);
    }
    if (c < nck - 1) __syncthreads();  // the last chunk's barrier follows the epilogue
  };
  for (int ct = 0; ct < n_ct; ++ct) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    step(ct, 0, true);
    for (int c = 1; c < nck; ++c) step(ct, c, false);
    // the last chunk: every wgmma retired and added
    wgmma_wait<0>();
    add(d0);
    if (nck > 1 || DP % LKC == 0) add(d1);  // its second step, or the one before its first
    epi(acc, ct);
    __syncthreads();
  }
}

// ---------------------------------------------------------- the product
// (streamed: D > RESIDENT_D)

// 16-deep chunks of a column tile at width D (zero-filled beyond D): an
// even count beyond RESIDENT_D, so that the streamed loop takes them in
// pairs without a branch
__host__ __device__ __forceinline__ int tile_chunks(int D) {
  const int nck = (D + LKC - 1) / LKC;
  return D > RESIDENT_D ? nck + (nck & 1) : nck;
}

// a streamed block's batch element b, row tile rt and column range sp
// (grid (row tiles, B, column ranges)), read anew by asm volatile: the
// consumers need them inside and after the product loop and keep none of
// it in registers across it, where acc and two sets leave few
__device__ __forceinline__ void block_place(int& b, int& rt, int& sp) {
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(rt));
  asm volatile("mov.u32 %0, %%ctaid.y;" : "=r"(b));
  asm volatile("mov.u32 %0, %%ctaid.z;" : "=r"(sp));
}

// column tiles [ct0, ct1) of range sp, ``per`` tiles a range (the last
// one shorter, or empty) over n columns: no division, so that nothing of
// it outlives its use
__device__ __forceinline__ void column_range(int n, int sp, int per, int& ct0, int& ct1) {
  ct0 = sp * per;
  ct1 = min(ct0 + per, (n + LM - 1) / LM);
}

// the block's column range, from blockIdx read anew
__device__ __forceinline__ void block_range(int n, int per, int& ct0, int& ct1) {
  int b, rt, sp;
  block_place(b, rt, sp);
  column_range(n, sp, per, ct0, ct1);
}

// The producer warpgroup of a streamed pass: its thread 256 copies every
// chunk of the block's column tiles ct0 .. ct1 - 1 (f2's, then the f1
// chunk of the same depths of row tile rt of n_rt) into ring buffer i % NS
// in the order the consumers take them, each buffer once both consumer
// warpgroups have released it; with COLS (the reward pass), the range's
// k-th column tile's operands into buffer k % 2 of cv before the tile's
// first chunk. The producer's 24 registers hold running offsets, no
// pointers. bars: full[NS], empty[NS], then (COLS) the column operands'
// full[2], empty[2].
template <bool COLS>
__device__ __forceinline__ void stream_producer(const float* __restrict__ f1s, const float* __restrict__ f2s,
                                                const float* __restrict__ cols, int D, int n, int n_rt, int rt,
                                                int ct0, int ct1, float* ring, float* cv, uint32_t bars) {
  setmaxnreg_dec<PRODUCER_REGS>();
  // staging begin (tools/profile_torch_lse_stages.py cuts the copies and the waits for them)
  if (threadIdx.x == L_THREADS) {
    const int nck = tile_chunks(D), n_ct = (n + LM - 1) / LM, total = (ct1 - ct0) * nck;
    // offsets in floats of the block's f1 tile and of its first f2 chunk
    const uint32_t a0 = (blockIdx.y * n_rt + rt) * nck * CHUNK_FLOATS;
    const uint32_t b0 = (blockIdx.y * n_ct + ct0) * nck * CHUNK_FLOATS;
    int c = 0, buf = 0, phase = 0;
    for (int i = 0; i < total; ++i) {
      if (COLS && c == 0) {
        const int k = i / nck, cb = k & 1;  // the range's k-th column tile
        mbar_wait(bars + 16 * NS + 16 + 8 * cb, ((k >> 1) & 1) ^ 1);
        mbar_expect_tx(bars + 16 * NS + 8 * cb, N_COLOPS * LM * 4);
        bulk_load(smem_u32(cv + cb * N_COLOPS * LM), cols + (blockIdx.y * n_ct + ct0 + k) * N_COLOPS * LM,
                  N_COLOPS * LM * 4, bars + 16 * NS + 8 * cb);
      }
      // a buffer's first fill waits on parity 1 of its fresh empty
      // barrier, which counts as complete
      mbar_wait(bars + 8 * NS + 8 * buf, phase ^ 1);
      mbar_expect_tx(bars + 8 * buf, S_BUF_FLOATS * 4);
      bulk_load(smem_u32(ring + buf * S_BUF_FLOATS), f2s + b0 + i * CHUNK_FLOATS, CHUNK_FLOATS * 4,
                bars + 8 * buf);
      bulk_load(smem_u32(ring + buf * S_BUF_FLOATS + CHUNK_FLOATS), f1s + a0 + c * CHUNK_FLOATS, CHUNK_FLOATS * 4,
                bars + 8 * buf);
      if (++c == nck) c = 0;
      if (++buf == NS) buf = 0, phase ^= 1;
    }
  }
  // staging end
}

// The consumer warpgroups' product of a streamed pass (threads 0-255,
// after setmaxnreg_inc): the block's dots, 3xTF32, against each column
// tile ct0 .. ct1 - 1 of its range (block_range, ``per`` tiles a range) in
// turn, from the ring that stream_producer fills; after each column tile,
// epi(acc, ct, ct - ct0) with acc as product_tiles gives it. Only the
// count of tiles taken is held across a tile's product: the range comes
// anew from block_range, where held it took two registers that acc and two
// sets do not leave. Each 16-deep chunk's six products (small terms first)
// go into d0 (even chunk of the tile) or d1 (odd), starting from zero, and
// join the running sum with one rounded f32 add, in chunk order; a set is
// added, then reused, once the chunk two back has retired, and each
// chunk's buffer is released then. A tile's first two chunks write both
// sets without reading them, so that nothing holds their registers
// through the epilogue before them; no wgmma is in flight across an
// epilogue or under a branch: with the next tile's first chunk issued
// ahead of the epilogue, ptxas spilled part of acc and serialized every
// wgmma (C7514, C7517).
template <class Epilogue>
__device__ __forceinline__ void stream_product(int D, int n, int per, const float* ring, uint32_t bars,
                                               Epilogue&& epi) {
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int nck = tile_chunks(D);
  const uint32_t full_u = bars, empty_u = bars + 8 * NS;
  const uint32_t ring_u = smem_u32(ring);

  float acc[64], d0[64], d1[64];
  auto add = [&](float(&d)[64]) {
    fence_acc(d);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += d[i];
  };
  // chunk i (of the block's sequence) into d once its buffer is full: its
  // six products (wgmma_chunk16_3xtf32: f2's chunk at the buffer's start,
  // this warpgroup's 64 rows of f1's after it), from zero. d's last chunk,
  // i - 2, has then retired: it is added and its buffer released first.
  // first (std::true_type for a tile's chunks 0 and 1 only): d holds
  // nothing to add.
  auto chunk = [&](auto first, int i, float(&d)[64]) {
    const int buf = i % NS;
    // staging begin
    mbar_wait_asm(full_u + 8 * buf, (i / NS) & 1);
    // staging end
    wgmma_wait<1>();
    if constexpr (!decltype(first)::value) {
      add(d);
      if (lane == 0) mbar_arrive(empty_u + 8 * ((i - 2) % NS));
    }
    const uint32_t bu = ring_u + buf * S_BUF_FLOATS * 4;
    wgmma_fence();
    wgmma_chunk16_3xtf32(d, desc_lo_128rows(bu + CHUNK_FLOATS * 4 + wg * 64 * 16), desc_lo_128rows(bu));
    wgmma_commit();
    fence_acc(d);
  };

  for (int k = 0;; ++k) {
    int ct0, ct1;
    block_range(n, per, ct0, ct1);
    if (k >= ct1 - ct0) break;
    const int i0 = k * nck;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    // nck is even: chunks in pairs, d0 then d1
    chunk(std::true_type{}, i0, d0);
    chunk(std::true_type{}, i0 + 1, d1);
    for (int c = 2; c < nck; c += 2) {
      chunk(std::false_type{}, i0 + c, d0);
      chunk(std::false_type{}, i0 + c + 1, d1);
    }
    // every wgmma retired and added in chunk order, every buffer released
    wgmma_wait<0>();
    add(d0);
    add(d1);
    if (lane == 0) {
      mbar_arrive(empty_u + 8 * ((i0 + nck - 2) % NS));
      mbar_arrive(empty_u + 8 * ((i0 + nck - 1) % NS));
    }
    block_range(n, per, ct0, ct1);
    epi(acc, ct0 + k, k);
  }
}

// the named barrier of consumer warpgroup wg's 128 threads (ids 1 and 2;
// compile-time ids, so that ptxas reserves three barriers, not all 16)
__device__ __forceinline__ void warpgroup_sync(int wg) {
  if (wg == 0)
    named_bar_sync(1, 128);
  else
    named_bar_sync(2, 128);
}

// mbarriers of a streamed pass from bar on, by thread 0: full[NS] (the
// producer's one arrival and the bytes), empty[NS] (one arrival per
// consumer warp), then, for the reward pass, the column operands' full[2]
// and empty[2]; the caller syncs the block after
__device__ __forceinline__ void init_stream_bars(uint32_t bar, bool cols) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < (cols ? NS + 2 : NS); ++i) {
      const uint32_t full = i < NS ? bar + 8 * i : bar + 16 * NS + 8 * (i - NS);
      mbar_init(full, 1);
      mbar_init(full + (i < NS ? 8 * NS : 16), L_THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
}

// --------------------------------------------------------------- lse pass

__global__ void __launch_bounds__(L_THREADS, 1) lse_pass_kernel(
    const float* __restrict__ f1s, const float* __restrict__ f2s, int m, int n,
    int D, float T, float* __restrict__ row_lse, float* __restrict__ col_max,
    float* __restrict__ col_sum) {
  extern __shared__ __align__(128) float smem[];
  float* cM = smem + P_FLOATS;  // [8][LM] column partials per warp
  float* cS = cM + 8 * LM;
  const uint32_t bars = smem_u32(cS + 8 * LM);

  const int b = blockIdx.y, rt = blockIdx.x, n_rt = gridDim.x;
  const int row0 = rt * LM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;   // accumulator row group, thread in group
  const float Tl = T * kLog2e;
  init_bars(bars, P_BARS);
  __syncthreads();

  // this thread's accumulator rows: g and g + 8 of its warp's 16
  const int lr0 = 16 * warp + g;
  const bool rok[2] = {row0 + lr0 < m, row0 + lr0 + 8 < m};
  float rm[2] = {kNeg, kNeg}, rs[2] = {0.f, 0.f};  // running row max and sum exp2

  product_tiles(f1s, f2s, D, n, smem, bars, [&](float(&acc)[64], int ct) {
    // epilogue begin
    const int col0 = ct * LM;
    lse_tile<false>(acc, col0, n, g, t, rok, Tl, rm, rs, cM + warp * LM, cS + warp * LM);
    __syncthreads();
    if (tid < LM && col0 + tid < n)
      lse_merge<8>(cM, cS, tid, col_max, col_sum, (size_t(b) * n_rt + rt) * n + col0 + tid);
    // cM/cS are rewritten only after the barrier that ends this tile
    // epilogue end
  });
  lse_rows(rm, rs, t, rok, row_lse + size_t(b) * m + row0 + lr0);
}

// Beyond RESIDENT_D: f1 streams beside f2 (stream_product). Block (rt, b,
// sp) takes row tile rt of batch element b against column range sp of
// gridDim.z (column_range, ``per`` tiles each); each consumer warpgroup
// writes its 64 rows' column partials, row 2 rt + wg of [B][2 n_rt][n], and
// the rows' (max in natural units, sum exp) over the range into row_max,
// row_sum [B][ranges][m]. Tl = T log2(e), rounded as the resident kernels
// round it, comes as a parameter: a kernel parameter is read from the
// constant bank, where a value formed in the kernel would hold registers
// across the product loop.
__global__ void __launch_bounds__(S_THREADS, 1) lse_pass_streamed_kernel(
    const float* __restrict__ f1s, const float* __restrict__ f2s, int m, int n,
    int D, int per, float Tl, float* __restrict__ row_max, float* __restrict__ row_sum,
    float* __restrict__ col_max, float* __restrict__ col_sum) {
  extern __shared__ __align__(128) float smem[];
  float* cM = smem + S_RING_FLOATS;  // [8][LM] column partials per warp
  float* cS = cM + 8 * LM;
  const uint32_t bars = smem_u32(cS + 8 * LM);
  const int b = blockIdx.y, n_rt = gridDim.x, rt = blockIdx.x, sp = blockIdx.z;
  init_stream_bars(bars, false);
  __syncthreads();
  if (threadIdx.x >= L_THREADS) {
    int ct0, ct1;
    column_range(n, sp, per, ct0, ct1);
    stream_producer<false>(f1s, f2s, nullptr, D, n, n_rt, rt, ct0, ct1, smem, nullptr, bars);
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();

  const int row0 = rt * LM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const int lr0 = 16 * warp + g;
  const bool rok[2] = {row0 + lr0 < m, row0 + lr0 + 8 < m};
  float rm[2] = {kNeg, kNeg}, rs[2] = {0.f, 0.f};

  stream_product(D, n, per, smem, bars, [&](float(&acc)[64], int ct, int) {
    // epilogue begin
    const int col0 = ct * LM, lt = tid & 127;
    lse_tile<true>(acc, col0, n, g, t, rok, Tl, rm, rs, cM + warp * LM, cS + warp * LM);
    warpgroup_sync(wg);
    if (col0 + lt < n)
      lse_merge<4>(cM + 4 * wg * LM, cS + 4 * wg * LM, lt, col_max, col_sum,
                   (size_t(b) * 2 * n_rt + 2 * rt + wg) * n + col0 + lt);
    warpgroup_sync(wg);  // the warpgroup's cM/cS rows are free for the next tile
    // epilogue end
  });
  const size_t o = (size_t(b) * gridDim.z + sp) * m + row0 + lr0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lse_quad(rm, rs, h);
    if (t == 0 && rok[h]) {
      row_max[o + 8 * h] = rm[h] * kLn2;
      row_sum[o + 8 * h] = rs[h];
    }
  }
}

// ------------------------------------------------------------ reward pass

// the block's row operands into rv [N_COLOPS][LM], by threads 0 .. LM - 1;
// a row beyond m is never good (NaN line) and has W = p = 0 (accept 0,
// row_lse 1e30)
__device__ __forceinline__ void load_rows(float* rv, const float* __restrict__ line1, const float* __restrict__ c1h,
                                          const float* __restrict__ accept1, const float* __restrict__ row_lse,
                                          int b, int row0, int m) {
  const int tid = threadIdx.x;
  if (tid < LM) {
    const int row = row0 + tid;
    const size_t r = size_t(b) * m + row;
    const bool ok = row < m;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      rv[k * LM + tid] = ok ? line1[3 * r + k] : __int_as_float(0x7fc00000);
      rv[(3 + k) * LM + tid] = ok ? c1h[3 * r + k] : __int_as_float(0x7fc00000);
    }
    rv[6 * LM + tid] = ok ? accept1[r] : 0.f;
    rv[7 * LM + tid] = ok ? row_lse[r] : kFar;
  }
}

__global__ void __launch_bounds__(L_THREADS, 1) reward_pass_kernel(
    const float* __restrict__ f1s, const float* __restrict__ f2s,
    const float* __restrict__ line1, const float* __restrict__ c1h,
    const float* __restrict__ accept1, const float* __restrict__ row_lse,
    const float* __restrict__ cols, int m, int n, int D, float T, float thr,
    float good_reward, float bad_reward, float* __restrict__ row_w,
    float* __restrict__ p_rowsum, float* __restrict__ colw_part,
    float* __restrict__ pcol_part, float* __restrict__ tile_stats) {
  extern __shared__ __align__(128) float smem[];
  float* cv = smem + P_FLOATS;         // [2][N_COLOPS][LM] column operands, by column tile parity
  float* rv = cv + 2 * N_COLOPS * LM;  // [N_COLOPS][LM] row operands: line1 xyz, c1h xyz, accept1, row_lse
  float* cW = rv + N_COLOPS * LM;      // [8][LM] column sums of W per warp
  float* cP = cW + 8 * LM;             // [8][LM] column sums of p per warp
  float* tot = cP + 8 * LM;            // [N_TOT][L_THREADS] each thread's running sums
  const uint32_t bars = smem_u32(tot + N_TOT * L_THREADS), col_bar = bars + 8 * P_BARS;

  const int b = blockIdx.y, rt = blockIdx.x, n_rt = gridDim.x;
  const int row0 = rt * LM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n_ct = (n + LM - 1) / LM;
  const float* C = cols + size_t(b) * n_ct * N_COLOPS * LM;
  const float Tl = T * kLog2e;
  // column tile ct's operands into buffer ct % 2, by thread 0
  auto fetch_cols = [&](int ct) {
    const uint32_t bar = col_bar + 8 * (ct & 1);
    mbar_expect_tx(bar, N_COLOPS * LM * 4);
    bulk_load(smem_u32(cv + (ct & 1) * N_COLOPS * LM), C + size_t(ct) * N_COLOPS * LM, N_COLOPS * LM * 4, bar);
  };
  init_bars(bars, P_BARS + 2);
  load_rows(rv, line1, c1h, accept1, row_lse, b, row0, m);
#pragma unroll
  for (int k = 0; k < N_TOT; ++k) tot[k * L_THREADS + tid] = 0.f;
  __syncthreads();
  if (tid == 0) fetch_cols(0);

  // this thread's rows: g and g + 8 of its warp's 16
  const int lr0 = 16 * warp + g;
  product_tiles(f1s, f2s, D, n, smem, bars, [&](float(&acc)[64], int ct) {
    // staging begin: buffer (ct + 1) % 2 was last read in tile ct - 1's
    // epilogue, before the barrier that ended that tile
    if (tid == 0 && ct + 1 < n_ct) fetch_cols(ct + 1);
    mbar_wait(col_bar + 8 * (ct & 1), (ct >> 1) & 1);
    // staging end
    // epilogue begin
    reward_tile<false>(acc, rv, lr0, cv + (ct & 1) * N_COLOPS * LM, g, t, Tl, thr, good_reward, bad_reward,
                cW + warp * LM, cP + warp * LM, tot + tid);
    __syncthreads();
    const int col0 = ct * LM;
    if (tid < LM && col0 + tid < n)
      reward_merge<8>(cW, cP, tid, colw_part, pcol_part, (size_t(b) * n_rt + rt) * n + col0 + tid);
    // cW/cP are rewritten only after the barrier that ends this tile
    // epilogue end
  });

  const float4 tw = reward_rows(tot + tid, t, row0 + lr0, m, row_w + size_t(b) * m, p_rowsum + size_t(b) * m);
  __syncthreads();  // every thread has read its running sums: reuse cW for the warps' totals
  if (lane == 0) {
    cW[0 * 8 + warp] = tw.x;
    cW[1 * 8 + warp] = tw.y;
    cW[2 * 8 + warp] = tw.z;
    cW[3 * 8 + warp] = tw.w;
  }
  __syncthreads();
  if (tid == 0) reward_totals<8>(cW, tile_stats + (size_t(b) * n_rt + rt) * 4);
}

// Beyond RESIDENT_D: f1 streams beside f2 (stream_product), blocks and Tl
// as in lse_pass_streamed_kernel; the producer also brings each column
// tile's operands; each consumer warpgroup writes its 64 rows' column
// partials, row 2 rt + wg of [B][2 n_rt][n], and totals, row (2 rt + wg)
// ranges + sp of [B][2 n_rt ranges][4]; the rows' sums of W and p over the
// range go to row_w, p_rowsum [B][ranges][m].
__global__ void __launch_bounds__(S_THREADS, 1) reward_pass_streamed_kernel(
    const float* __restrict__ f1s, const float* __restrict__ f2s,
    const float* __restrict__ line1, const float* __restrict__ c1h,
    const float* __restrict__ accept1, const float* __restrict__ row_lse,
    const float* __restrict__ cols, int m, int n, int D, int per, float Tl, float thr,
    float good_reward, float bad_reward, float* __restrict__ row_w,
    float* __restrict__ p_rowsum, float* __restrict__ colw_part,
    float* __restrict__ pcol_part, float* __restrict__ tile_stats) {
  extern __shared__ __align__(128) float smem[];
  float* cv = smem + S_RING_FLOATS;    // [2][N_COLOPS][LM] column operands, by column tile parity
  float* rv = cv + 2 * N_COLOPS * LM;  // [N_COLOPS][LM] row operands
  float* cW = rv + N_COLOPS * LM;      // [8][LM] column sums of W per warp
  float* cP = cW + 8 * LM;             // [8][LM] column sums of p per warp
  float* tot = cP + 8 * LM;            // [N_TOT][L_THREADS] each consumer thread's running sums
  const uint32_t bars = smem_u32(tot + N_TOT * L_THREADS);
  const uint32_t cfull_u = bars + 16 * NS, cempty_u = cfull_u + 16;

  init_stream_bars(bars, true);
  load_rows(rv, line1, c1h, accept1, row_lse, blockIdx.y, blockIdx.x * LM, m);
  if (threadIdx.x < L_THREADS) {
#pragma unroll
    for (int k = 0; k < N_TOT; ++k) tot[k * L_THREADS + threadIdx.x] = 0.f;
  }
  __syncthreads();
  if (threadIdx.x >= L_THREADS) {
    int ct0, ct1;
    column_range(n, blockIdx.z, per, ct0, ct1);
    stream_producer<true>(f1s, f2s, cols, D, n, gridDim.x, blockIdx.x, ct0, ct1, smem, cv, bars);
    return;
  }
  setmaxnreg_inc<CONSUMER_REGS>();
  // the thread's place and the block's are read anew inside and after the
  // loop (block_place), not held across it
  stream_product(D, n, per, smem, bars, [&](float(&acc)[64], int ct, int k) {
    const int cb = k & 1;  // the column operands' buffer
    // staging begin
    mbar_wait_asm(cfull_u + 8 * cb, (k >> 1) & 1);
    // staging end
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
    // epilogue begin
    reward_tile<true>(acc, rv, 16 * warp + (lane >> 2), cv + cb * N_COLOPS * LM, lane >> 2, lane & 3,
                      Tl, thr, good_reward, bad_reward, cW + warp * LM, cP + warp * LM, tot + tid);
    // epilogue end
    if (lane == 0) mbar_arrive(cempty_u + 8 * cb);  // this warp has read the tile's column operands
    // epilogue begin
    const int col0 = ct * LM, lt = tid & 127;
    int b, rt, sp;
    block_place(b, rt, sp);
    warpgroup_sync(wg);
    if (col0 + lt < n)
      reward_merge<4>(cW + 4 * wg * LM, cP + 4 * wg * LM, lt, colw_part, pcol_part,
                      (size_t(b) * 2 * gridDim.x + 2 * rt + wg) * n + col0 + lt);
    warpgroup_sync(wg);  // the warpgroup's cW/cP rows are free for the next tile
    // epilogue end
  });

  int b, rt, sp;
  block_place(b, rt, sp);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
  const size_t ro = (size_t(b) * gridDim.z + sp) * m;
  const float4 tw = reward_rows(tot + tid, lane & 3, rt * LM + 16 * warp + (lane >> 2), m, row_w + ro, p_rowsum + ro);
  // the warpgroup's warp totals in its first warp's cW row, which only it reads
  float* red = cW + 4 * wg * LM;
  if (lane == 0) {
    red[0 * 4 + (warp & 3)] = tw.x;
    red[1 * 4 + (warp & 3)] = tw.y;
    red[2 * 4 + (warp & 3)] = tw.z;
    red[3 * 4 + (warp & 3)] = tw.w;
  }
  warpgroup_sync(wg);
  if ((tid & 127) == 0)
    reward_totals<4>(red, tile_stats + ((size_t(b) * 2 * gridDim.x + 2 * rt + wg) * gridDim.z + sp) * 4);
}

// f1's tile streams beside f2's chunks beyond RESIDENT_D (see the top)
bool streams_f1(int D) { return D > RESIDENT_D; }

int check_shape(int B, int m, int n, int D) {
  if (B < 1 || m < 1 || n < 1 || D < 1) return kBadShape;
  if (B > 65535) return kGridTooLarge;
  // the streamed producer addresses the split tiles by 32-bit offsets
  const size_t tiles = (size_t(m > n ? m : n) + LM - 1) / LM;
  if (streams_f1(D) && size_t(B) * tiles * tile_chunks(D) * CHUNK_FLOATS > 0xffffffffu) return kBadShape;
  return 0;
}

// a resident instance's launch: (row tile, batch element) blocks of 256 threads
template <typename Kernel, typename... Args>
int launch_resident(Kernel kernel, size_t smem, int B, int m, cudaStream_t stream, Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  kernel<<<dim3((m + LM - 1) / LM, B), L_THREADS, smem, stream>>>(args...);
  return int(cudaGetLastError());
}

// a streamed instance's launch: (row tile, batch element, column range)
// blocks of S_THREADS, with the register pool that setmaxnreg redistributes
// (with fewer, the consumers' setmaxnreg.inc would wait forever)
template <typename Kernel, typename... Args>
int launch_streamed(Kernel kernel, size_t smem, int B, int m, int splits, cudaStream_t stream, Args... args) {
  if (splits > 65535) return kGridTooLarge;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return int(err);
  if (attr.numRegs < LAUNCH_REGS) return kRegisterBudget;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  kernel<<<dim3((m + LM - 1) / LM, B, splits), S_THREADS, smem, stream>>>(args...);
  return int(cudaGetLastError());
}

// splits must be 1 up to RESIDENT_D, and at most the column tiles beyond
int check_splits(int n, int D, int splits) {
  const int n_ct = (n + LM - 1) / LM;
  return splits < 1 || splits > n_ct || (!streams_f1(D) && splits != 1) ? kBadShape : 0;
}

// column tiles a range when a row tile's n columns split in ``splits``
int range_tiles(int n, int splits) { return ((n + LM - 1) / LM + splits - 1) / splits; }

}  // namespace

extern "C" {

// Returns 0, a cudaError_t value, or a negative ArgError. f1 [B, m, D] and
// f2 [B, n, D] split into TF32 hi and lo tiles: f1s B * ceil(m / 128) *
// 2 * 16 * nck * 128 floats, f2s the same with n, nck = ceil(D / 16) up
// to D = RESIDENT_D and ceil(D / 32) * 2 beyond (tile_chunks); f2's tiles
// in 16-deep chunks, f1's in one chunk of the whole depth up to
// D = RESIDENT_D and in 16-deep chunks beyond.
int posfeat_reinforce_split(const void* f1, const void* f2, void* f1s, void* f2s, int B, int m,
                            int n, int D, void* stream) {
  if (int rc = check_shape(B, m, n, D)) return rc;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nck = tile_chunks(D);
  auto split = [&](const void* x, int rows, int chunks, int cq, void* out) {
    const int tiles = (rows + LM - 1) / LM;
    const size_t per_b = size_t(tiles) * chunks * cq * LM;
    dim3 grid(unsigned((per_b + SPLIT_THREADS - 1) / SPLIT_THREADS), B);
    lse_split_kernel<<<grid, SPLIT_THREADS, 0, st>>>(static_cast<const float*>(x), rows, D, tiles,
                                                      chunks, cq, static_cast<float*>(out));
    return cudaGetLastError();
  };
  cudaError_t err = streams_f1(D) ? split(f1, m, nck, LKC / 4, f1s) : split(f1, m, 1, 4 * nck, f1s);
  if (err == cudaSuccess) err = split(f2, n, nck, LKC / 4, f2s);
  return int(err);
}

// f1s, f2s from posfeat_reinforce_split. col_max, col_sum [B, P, n]
// partials, the max in natural units: P = ceil(m / 128) up to D =
// RESIDENT_D (one per row tile), twice that beyond (one per 64 rows). Up
// to RESIDENT_D, row_lse [B, m] and splits 1 (row_sum unused); beyond it,
// each row tile's columns in ``splits`` ranges (one block each), row_lse
// and row_sum [B, splits, m] the rows' (max in natural units, sum exp)
// over each range.
int posfeat_lse_pass(const void* f1s, const void* f2s, void* row_lse, void* row_sum, void* col_max,
                     void* col_sum, int B, int m, int n, int D, int splits, float T, void* stream) {
  if (int rc = check_shape(B, m, n, D)) return rc;
  if (int rc = check_splits(n, D, splits)) return rc;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto a = static_cast<const float*>(f1s), b = static_cast<const float*>(f2s);
  const auto cm = static_cast<float*>(col_max), cs = static_cast<float*>(col_sum);
  if (!streams_f1(D))
    return launch_resident(lse_pass_kernel, L_SMEM_BYTES, B, m, st, a, b, m, n, D, T, static_cast<float*>(row_lse),
                           cm, cs);
  return launch_streamed(lse_pass_streamed_kernel, SL_SMEM_BYTES, B, m, splits, st, a, b, m, n, D,
                         range_tiles(n, splits), T * kLog2e, static_cast<float*>(row_lse),
                         static_cast<float*>(row_sum), cm, cs);
}

// f1s, f2s from posfeat_reinforce_split; line1, c1h [B, m, 3]; accept1,
// row_lse [B, m]; cols [B, ceil(n / 128), 8, 128]: per column tile c2h x,
// y, z, line2 x, y, z, accept2, col_lse, each 128 columns, the columns
// beyond n with NaN lines, accept 0 and col_lse 1e30. row_w, p_rowsum
// [B, splits, m] (sums over each column range; splits as posfeat_lse_pass's);
// colw_part, pcol_part [B, P, n]; tile_stats [B, P splits, 4] = (s0, max
// p, sum p, good pairs) per partials row and range, P as posfeat_lse_pass's.
int posfeat_reward_pass(const void* f1s, const void* f2s, const void* line1, const void* c1h,
                        const void* accept1, const void* row_lse, const void* cols, void* row_w,
                        void* p_rowsum, void* colw_part, void* pcol_part, void* tile_stats, int B,
                        int m, int n, int D, int splits, float T, float thr, float good_reward,
                        float bad_reward, void* stream) {
  if (int rc = check_shape(B, m, n, D)) return rc;
  if (int rc = check_splits(n, D, splits)) return rc;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto a = static_cast<const float*>(f1s), b = static_cast<const float*>(f2s);
  const auto l1 = static_cast<const float*>(line1), c1 = static_cast<const float*>(c1h);
  const auto a1 = static_cast<const float*>(accept1), rl = static_cast<const float*>(row_lse);
  const auto cv = static_cast<const float*>(cols);
  const auto rw = static_cast<float*>(row_w), pr = static_cast<float*>(p_rowsum);
  const auto cw = static_cast<float*>(colw_part), pc = static_cast<float*>(pcol_part);
  const auto ts = static_cast<float*>(tile_stats);
  if (!streams_f1(D))
    return launch_resident(reward_pass_kernel, R_SMEM_BYTES, B, m, st, a, b, l1, c1, a1, rl, cv, m, n, D, T, thr,
                           good_reward, bad_reward, rw, pr, cw, pc, ts);
  return launch_streamed(reward_pass_streamed_kernel, SR_SMEM_BYTES, B, m, splits, st, a, b, l1, c1, a1, rl, cv, m,
                         n, D, range_tiles(n, splits), T * kLog2e, thr, good_reward, bad_reward, rw, pr, cw, pc,
                         ts);
}

const char* posfeat_reinforce_error_string(int code) {
  switch (code) {
    case kBadShape:
      return "shape outside what the kernels support (B, m, n and D must be positive; beyond D = 128 the "
             "split of f1 or f2 must hold fewer than 2^32 floats)";
    case kGridTooLarge:
      return "batch too large for one launch";
    case kRegisterBudget:
      return "the streamed pass was built with fewer registers per thread than setmaxnreg hands on";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
