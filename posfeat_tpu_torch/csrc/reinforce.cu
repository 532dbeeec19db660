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
// The product (product_tiles, shared by both passes) runs on the tensor
// cores as 3xTF32. Each operand is split once, before the product:
// x = hi + lo, hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi); each 8-deep
// step forms lo.hi + hi.lo + hi.hi on the tensor cores (the dropped lo.lo
// term is ~2^-22 relative) and adds it to an f32 running sum, rounded to
// nearest: the tensor cores' own accumulation truncates, and a chain of
// 48 MMAs per D = 128 dot moved the reduction's s0 by 0.7% on the card.
// Floor: 3 x 35.4 GFLOP at 495 TFLOP/s of TF32 = 0.215 ms per pass; the
// epilogues come on top, not overlapped.
// - wgmma.m64n128k8 (tf32), both operands K-major in shared memory, in
//   core matrices without swizzle ([depth / 4][rows][4] floats): f1 [m, D]
//   and f2 [n, D] lie that way in memory, so nothing is transposed.
// - A first kernel (lse_split_kernel) splits f1 and f2 into hi and lo once
//   per reduction, into scratch laid out as the tiles are read, so that
//   staging is bulk copies (async proxy, no fence, no thread work)
//   completing on mbarriers; both passes read the same scratch. One block of
//   256 threads (two warpgroups, 64 rows each) per (128-row tile of f1,
//   batch element); f2 streams through a ring of four 16-deep chunks of 128
//   columns (hi and lo, 16 KB each), each copied two chunks ahead of its
//   wgmmas by one thread, one barrier per chunk. Up to D = RESIDENT_D = 128
//   the block keeps its f1 tile resident as hi and lo (2 x 64 KB at
//   D = 128). A deeper f1 tile would not fit beside the ring (256 KB at
//   D = 256, over the 227 KB a block may have), so there each ring buffer
//   carries the f1 chunk of the same 16 depths beside f2's (32 KB a
//   buffer), and f1 is read again from L2 for every column tile: shared
//   memory stays at 128 KB plus the epilogue's at any D. Both layouts feed
//   the same wgmmas the same operands in the same order, so a dot does not
//   depend on which one ran.
// - Two accumulator sets take turns, so that two 8-deep steps' wgmmas stay
//   queued while the step before them is added into the running sum. Both
//   passes run this one loop, so a pair's dot is bit-identical in both: at
//   a peaked pair the rounding of aff and of its log-sum-exps cancels in
//   the reward pass's lp = (aff - row_lse) + (aff - col_lse).
// - Where the time goes (tools/profile_torch_lse_stages.py cuts copies of
//   this file at the "staging" and "epilogue" comments): the epilogues do
//   not overlap the wgmmas, and neither the staging nor the adds fully do.
//
// lse pass epilogue, in base 2 (v = log2(e) * aff, exp2 on the SFU): each
// warp holds 16 whole rows of the 128-column tile, so a row's online (max,
// sum exp) needs only its quad; each column gets (max, sum exp) over the
// warp's 16 rows by shuffles, then over the 8 warps through shared memory,
// and one partials row per row tile is written in a fixed order.
//
// reward pass epilogue: each thread forms, for its 2 rows x 32 columns, lp,
// p, both epipolar distances (in the plain version's rounded order), the
// decision and W, and adds into its rows' sums of W and p and its s0, max
// p and good pairs, first over the tile, then into running sums. The
// product's three accumulator sets (192 registers) leave no room for more
// state between epilogues, so the block's row operands (line1, c1h,
// accept1, row_lse) and each thread's running sums live in shared memory;
// a column tile's operands (c2h, line2, accept2, col_lse: 4 KB, packed
// structure-of-arrays by the wrapper) come in by one bulk copy, one tile
// ahead, double-buffered. Column sums of W and p go over the warp's 16 rows
// by shuffles, then over the 8 warps through shared memory, one partials
// row per row tile. The ragged edge needs no mask per pair: a row beyond m
// gets a NaN line (never good), accept 0 and row_lse 1e30 (p = 0), and the
// wrapper packs the columns beyond n the same way. The reward pass forms
// aff from the lse pass's dots with the lse pass's arithmetic (aff_log2),
// so that beside it the dots' errors (the tensor cores' truncating
// accumulation, one sign) and the roundings of aff cancel in
// lp = (aff - row_lse) + (aff - col_lse). Fed the log-sum-exps of the plain
// f32 product instead, nothing cancels, and at T = 60 the training path's
// s0 moves by up to ~1.6e-4 relative, inside the reference's rtol 2e-4;
// forming aff as fmaf(T, dot, -T) moved it by ~3e-4 beside the lse pass.

#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int RESIDENT_D = 128;  // widest f1 tile kept resident; deeper ones stream beside f2
constexpr int LM = 128;          // rows of f1 per block (two warpgroups x 64) = columns of f2 per tile
constexpr int LKC = 16;          // depth of one f2 chunk: two 8-deep steps
constexpr int NBUF = 4;          // f2 chunk buffers: chunk s + 2 loads while chunk s runs
constexpr int L_THREADS = 256;   // two warpgroups, 8 warps of 16 rows each
constexpr int CHUNK_FLOATS = 2 * LKC * LM;  // one f2 chunk, hi then lo: 16 KB
constexpr int SPLIT_THREADS = 256;
constexpr int N_COLOPS = 8;      // reward pass operands per column: c2h xyz, line2 xyz, accept2, col_lse
constexpr float kNeg = -1e30f, kFar = 1e30f;
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;
// dynamic shared memory of both passes: the product's (f1 hi/lo and the f2
// chunk ring, or a ring of f2 and f1 chunks when f1 streams), then each
// pass's own, then mbarriers (NBUF for the ring, one for the resident f1
// tile, the reward pass two more for its column operands)
template <bool STREAM_A>
__host__ __device__ constexpr int p_floats() {
  return STREAM_A ? NBUF * 2 * CHUNK_FLOATS : 2 * RESIDENT_D * LM + NBUF * CHUNK_FLOATS;
}
constexpr int P_BARS = NBUF + 1;
// + column (max, sum exp) per warp
template <bool STREAM_A>
constexpr size_t l_smem_bytes() {
  return size_t(p_floats<STREAM_A>() + 2 * 8 * LM) * 4 + 8 * P_BARS;
}
// + column operands [2][N_COLOPS][LM], row operands [N_COLOPS][LM], column
// (W, p) per warp, each thread's N_TOT running sums (rowW, rowW, p, p, s0,
// max p, good pairs)
constexpr int N_TOT = 7;
template <bool STREAM_A>
constexpr size_t r_smem_bytes() {
  return size_t(p_floats<STREAM_A>() + 3 * N_COLOPS * LM + 2 * 8 * LM + N_TOT * L_THREADS) * 4 + 8 * (P_BARS + 2);
}
static_assert(r_smem_bytes<true>() <= 232448 && r_smem_bytes<false>() <= 232448, "over a block's shared memory");

enum ArgError { kBadShape = -1, kGridTooLarge = -2 };

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

// ---------------------------------------------------------- the product

// The block's dots f1 . f2^T, 3xTF32, for its 128 rows of f1 (row tile
// blockIdx.x of batch element blockIdx.y) against each 128-column tile of
// f2 in turn, from the split tiles f1s and f2s; after each column tile,
// epi(acc, ct) with acc[4j + 2h + e] the dot of row 16 * warp + g + 8h of
// the block and column 8j + 2t + e of tile ct (g = lane / 4, t = lane % 4).
// smem holds the product's operands (p_floats<STREAM_A>: f1 hi, f1 lo and
// the ring; or, STREAM_A, the ring of f2 and f1 chunks); bars NBUF + 1
// initialised mbarriers. epi may sync the block; every step ends with a
// block barrier, a tile's last after its epilogue.
template <bool STREAM_A, class Epilogue>
__device__ __forceinline__ void product_tiles(const float* __restrict__ f1s, const float* __restrict__ f2s,
                                              int D, int n, float* smem, uint32_t bars, Epilogue&& epi) {
  // resident: aH, aL [RESIDENT_D / 4][LM][4], then the ring
  // [NBUF][hi, lo][LKC / 4][LM][4]; streamed: the ring [NBUF][f2, f1][hi, lo]
  // [LKC / 4][LM][4]
  constexpr int BUF_FLOATS = STREAM_A ? 2 * CHUNK_FLOATS : CHUNK_FLOATS;
  float* aH = smem;
  float* aL = aH + RESIDENT_D * LM;
  float* ring = STREAM_A ? smem : aL + RESIDENT_D * LM;
  const uint32_t full_u = bars, a_bar = bars + 8 * NBUF;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int DP = (D + 7) & ~7;            // depth in whole 8-deep steps, zero-filled
  const int nck = (DP + LKC - 1) / LKC;   // chunks per column tile
  const int qa = 4 * nck;                 // groups of 4 depths of the f1 tile
  const int n_ct = (n + LM - 1) / LM, steps = n_ct * nck;
  // the block's f1 tile: one chunk of qa depth groups, hi then lo
  // (resident), or nck chunks like f2's (streamed); f2's column tiles: nck
  // chunks each
  const float* A = f1s + (size_t(blockIdx.y) * gridDim.x + blockIdx.x) * 2 * qa * LM * 4;
  const float* Bm = f2s + size_t(blockIdx.y) * n_ct * nck * CHUNK_FLOATS;

  // chunk i (column tile i / nck, depths (i % nck) * LKC ...) into ring
  // buffer i % NBUF, by thread 0; streamed, f1's chunk of the same depths
  // after it
  auto fetch = [&](int i) {
    const uint32_t bar = full_u + 8 * (i % NBUF);
    float* dst = ring + (i % NBUF) * BUF_FLOATS;
    mbar_expect_tx(bar, BUF_FLOATS * 4);
    bulk_load(smem_u32(dst), Bm + size_t(i) * CHUNK_FLOATS, CHUNK_FLOATS * 4, bar);
    if constexpr (STREAM_A)
      bulk_load(smem_u32(dst + CHUNK_FLOATS), A + size_t(i % nck) * CHUNK_FLOATS, CHUNK_FLOATS * 4, bar);
  };
  if (tid == 0) {
    if constexpr (!STREAM_A) {
      mbar_expect_tx(a_bar, 2 * qa * LM * 16);
      bulk_load(smem_u32(aH), A, qa * LM * 16, a_bar);
      bulk_load(smem_u32(aL), A + qa * LM * 4, qa * LM * 16, a_bar);
    }
    fetch(0);
    if (steps > 1) fetch(1);
  }
  const uint32_t aH_u = smem_u32(aH) + wg * 64 * 16, aL_u = smem_u32(aL) + wg * 64 * 16;
  const uint32_t ring_u = smem_u32(ring);
  if constexpr (!STREAM_A) mbar_wait(a_bar, 0);

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
      const uint32_t bo = buf * BUF_FLOATS * 4 + 2 * ks * LM * 16;
      // f1's depths kc + 8 ks ..: in the resident tile, or in the buffer's f1 chunk
      const uint32_t ah_u = STREAM_A ? ring_u + bo + CHUNK_FLOATS * 4 + wg * 64 * 16
                                     : aH_u + ((kc + 8 * ks) / 4) * LM * 16;
      const uint32_t al_u = STREAM_A ? ah_u + LKC * LM * 4 : aL_u + ((kc + 8 * ks) / 4) * LM * 16;
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

// --------------------------------------------------------------- lse pass

template <bool STREAM_A>
__global__ void __launch_bounds__(L_THREADS, 1) lse_pass_kernel(
    const float* __restrict__ f1s, const float* __restrict__ f2s, int m, int n,
    int D, float T, float* __restrict__ row_lse, float* __restrict__ col_max,
    float* __restrict__ col_sum) {
  extern __shared__ __align__(128) float smem[];
  float* cM = smem + p_floats<STREAM_A>();  // [8][LM] column partials per warp
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

  product_tiles<STREAM_A>(f1s, f2s, D, n, smem, bars, [&](float(&acc)[64], int ct) {
    // epilogue begin
    const int col0 = ct * LM;
    // the tile's aff in base 2: v = log2(e) * (T * dot - T)
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
          cM[warp * LM + 8 * j + 2 * t + e] = cm;
          cS[warp * LM + 8 * j + 2 * t + e] = cs;
        }
      }
    __syncthreads();
    if (tid < LM && col0 + tid < n) {
      float M = cM[tid], S = cS[tid];
#pragma unroll
      for (int w = 1; w < 8; ++w) lse2_merge(M, S, cM[w * LM + tid], cS[w * LM + tid]);
      const size_t o = (size_t(b) * n_rt + rt) * n + col0 + tid;
      col_max[o] = M * kLn2;
      col_sum[o] = S;
    }
    // cM/cS are rewritten only after the barrier that ends this tile
    // epilogue end
  });

  // rows: merge the quad; the warp holds all of each row's columns
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, rm[h], off);
      const float os = __shfl_xor_sync(0xffffffffu, rs[h], off);
      lse2_merge(rm[h], rs[h], om, os);
    }
    if (t == 0 && rok[h])
      row_lse[size_t(b) * m + row0 + lr0 + 8 * h] = rm[h] * kLn2 + logf(fmaxf(rs[h], 1e-30f));
  }
}

// ------------------------------------------------------------ reward pass

template <bool STREAM_A>
__global__ void __launch_bounds__(L_THREADS, 1) reward_pass_kernel(
    const float* __restrict__ f1s, const float* __restrict__ f2s,
    const float* __restrict__ line1, const float* __restrict__ c1h,
    const float* __restrict__ accept1, const float* __restrict__ row_lse,
    const float* __restrict__ cols, int m, int n, int D, float T, float thr,
    float good_reward, float bad_reward, float* __restrict__ row_w,
    float* __restrict__ p_rowsum, float* __restrict__ colw_part,
    float* __restrict__ pcol_part, float* __restrict__ tile_stats) {
  extern __shared__ __align__(128) float smem[];
  float* cv = smem + p_floats<STREAM_A>();  // [2][N_COLOPS][LM] column operands, by column tile parity
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
  // the block's row operands; a row beyond m is never good (NaN line) and
  // has W = p = 0 (accept 0, row_lse 1e30)
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
#pragma unroll
  for (int k = 0; k < N_TOT; ++k) tot[k * L_THREADS + tid] = 0.f;
  __syncthreads();
  if (tid == 0) fetch_cols(0);

  // this thread's rows: g and g + 8 of its warp's 16
  const int lr0 = 16 * warp + g;
  product_tiles<STREAM_A>(f1s, f2s, D, n, smem, bars, [&](float(&acc)[64], int ct) {
    // staging begin: buffer (ct + 1) % 2 was last read in tile ct - 1's
    // epilogue, before the barrier that ended that tile
    if (tid == 0 && ct + 1 < n_ct) fetch_cols(ct + 1);
    mbar_wait(col_bar + 8 * (ct & 1), (ct >> 1) & 1);
    // staging end
    // epilogue begin
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
    const float* cq = cv + (ct & 1) * N_COLOPS * LM + 2 * t;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // column 8j + 2t + e's operands, one at a time: the epilogue has
        // the registers that the product's accumulators leave
        const float* o = cq + 8 * j + e;
        const float c2x = o[0], c2y = o[LM], c2z = o[2 * LM], l2x = o[3 * LM], l2y = o[4 * LM], l2z = o[5 * LM];
        const float a2 = o[6 * LM], cl = o[7 * LM];
        float cw = 0.f, cp = 0.f;
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
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          cw += __shfl_xor_sync(0xffffffffu, cw, off);
          cp += __shfl_xor_sync(0xffffffffu, cp, off);
        }
        if (g == 0) {
          cW[warp * LM + 8 * j + 2 * t + e] = cw;
          cP[warp * LM + 8 * j + 2 * t + e] = cp;
        }
      }
    float* my = tot + tid;
    my[0 * L_THREADS] += rw[0];
    my[1 * L_THREADS] += rw[1];
    my[2 * L_THREADS] += rp[0];
    my[3 * L_THREADS] += rp[1];
    my[4 * L_THREADS] += s0;
    my[5 * L_THREADS] = fmaxf(my[5 * L_THREADS], pmax);
    my[6 * L_THREADS] += ngood;
    __syncthreads();
    const int col0 = ct * LM;
    if (tid < LM && col0 + tid < n) {
      float W = 0.f, P = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) W += cW[w * LM + tid], P += cP[w * LM + tid];
      const size_t o = (size_t(b) * n_rt + rt) * n + col0 + tid;
      colw_part[o] = W;
      pcol_part[o] = P;
    }
    // cW/cP are rewritten only after the barrier that ends this tile
    // epilogue end
  });

  // rows: sum the quad; the warp holds all of each row's columns
  const float* my = tot + tid;
  float rw[2] = {my[0], my[L_THREADS]}, rp[2] = {my[2 * L_THREADS], my[3 * L_THREADS]};
  float s0 = my[4 * L_THREADS], pmax = my[5 * L_THREADS], psum = rp[0] + rp[1], ngood = my[6 * L_THREADS];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      rw[h] += __shfl_xor_sync(0xffffffffu, rw[h], off);
      rp[h] += __shfl_xor_sync(0xffffffffu, rp[h], off);
    }
    const int row = row0 + lr0 + 8 * h;
    if (t == 0 && row < m) {
      row_w[size_t(b) * m + row] = rw[h];
      p_rowsum[size_t(b) * m + row] = rp[h];
    }
  }
  // block totals: s0, max p, sum p, good pairs
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, off);
    pmax = fmaxf(pmax, __shfl_xor_sync(0xffffffffu, pmax, off));
    psum += __shfl_xor_sync(0xffffffffu, psum, off);
    ngood += __shfl_xor_sync(0xffffffffu, ngood, off);
  }
  __syncthreads();  // every thread has read its running sums: reuse cW for the warps' totals
  if (lane == 0) {
    cW[0 * 8 + warp] = s0;
    cW[1 * 8 + warp] = pmax;
    cW[2 * 8 + warp] = psum;
    cW[3 * 8 + warp] = ngood;
  }
  __syncthreads();
  if (tid == 0) {
    float S0 = 0.f, PM = 0.f, PS = 0.f, NG = 0.f;
    for (int w = 0; w < 8; ++w) {
      S0 += cW[0 * 8 + w];
      PM = fmaxf(PM, cW[1 * 8 + w]);
      PS += cW[2 * 8 + w];
      NG += cW[3 * 8 + w];
    }
    float* o = tile_stats + (size_t(b) * n_rt + rt) * 4;
    o[0] = S0;
    o[1] = PM;
    o[2] = PS;
    o[3] = NG;
  }
}

int check_shape(int B, int m, int n, int D) {
  if (B < 1 || m < 1 || n < 1 || D < 1) return kBadShape;
  if (B > 65535) return kGridTooLarge;
  return 0;
}

// f1's tile streams beside f2's chunks beyond RESIDENT_D (see the top)
bool streams_f1(int D) { return D > RESIDENT_D; }

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}

}  // namespace

extern "C" {

// Returns 0, a cudaError_t value, or a negative ArgError. f1 [B, m, D] and
// f2 [B, n, D] split into TF32 hi and lo tiles: f1s B * ceil(m / 128) *
// 2 * 16 * ceil(DP / 16) * 128 floats, f2s the same with n, DP = D rounded
// up to a multiple of 8; f2's tiles in 16-deep chunks, f1's in one chunk
// of the whole depth up to D = RESIDENT_D and in 16-deep chunks beyond.
int posfeat_reinforce_split(const void* f1, const void* f2, void* f1s, void* f2s, int B, int m,
                            int n, int D, void* stream) {
  if (int rc = check_shape(B, m, n, D)) return rc;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nck = ((D + 7) / 8 * 8 + LKC - 1) / LKC;  // 16-deep chunks of the depth, zero-filled
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

// f1s, f2s from posfeat_reinforce_split. row_lse [B, m]; col_max, col_sum
// [B, ceil(m / 128), n] partials, the max in natural units.
int posfeat_lse_pass(const void* f1s, const void* f2s, void* row_lse, void* col_max, void* col_sum,
                     int B, int m, int n, int D, float T, void* stream) {
  if (int rc = check_shape(B, m, n, D)) return rc;
  const bool st = streams_f1(D);
  const auto kernel = st ? lse_pass_kernel<true> : lse_pass_kernel<false>;
  const size_t smem = st ? l_smem_bytes<true>() : l_smem_bytes<false>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return int(err);
  kernel<<<dim3((m + LM - 1) / LM, B), L_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f1s), static_cast<const float*>(f2s), m, n, D, T,
      static_cast<float*>(row_lse), static_cast<float*>(col_max), static_cast<float*>(col_sum));
  return int(cudaGetLastError());
}

// f1s, f2s from posfeat_reinforce_split; line1, c1h [B, m, 3]; accept1,
// row_lse [B, m]; cols [B, ceil(n / 128), 8, 128]: per column tile c2h x,
// y, z, line2 x, y, z, accept2, col_lse, each 128 columns, the columns
// beyond n with NaN lines, accept 0 and col_lse 1e30. row_w, p_rowsum
// [B, m]; colw_part, pcol_part [B, ceil(m / 128), n]; tile_stats
// [B, ceil(m / 128), 4] = (s0, max p, sum p, good pairs) per row tile.
int posfeat_reward_pass(const void* f1s, const void* f2s, const void* line1, const void* c1h,
                        const void* accept1, const void* row_lse, const void* cols, void* row_w,
                        void* p_rowsum, void* colw_part, void* pcol_part, void* tile_stats, int B,
                        int m, int n, int D, float T, float thr, float good_reward,
                        float bad_reward, void* stream) {
  if (int rc = check_shape(B, m, n, D)) return rc;
  const bool st = streams_f1(D);
  const auto kernel = st ? reward_pass_kernel<true> : reward_pass_kernel<false>;
  const size_t smem = st ? r_smem_bytes<true>() : r_smem_bytes<false>();
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return int(err);
  kernel<<<dim3((m + LM - 1) / LM, B), L_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f1s), static_cast<const float*>(f2s),
      static_cast<const float*>(line1), static_cast<const float*>(c1h),
      static_cast<const float*>(accept1), static_cast<const float*>(row_lse),
      static_cast<const float*>(cols), m, n, D, T, thr, good_reward, bad_reward,
      static_cast<float*>(row_w), static_cast<float*>(p_rowsum), static_cast<float*>(colw_part),
      static_cast<float*>(pcol_part), static_cast<float*>(tile_stats));
  return int(cudaGetLastError());
}

const char* posfeat_reinforce_error_string(int code) {
  switch (code) {
    case kBadShape:
      return "shape outside what the kernels support (B, m, n and D must be positive)";
    case kGridTooLarge:
      return "batch too large for one launch";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
