// Streamed stage-2 REINFORCE reduction for Hopper (sm_90a), plain C interface.
//
// posfeat_lse_pass replaces posfeat_tpu/ops/pallas/reinforce.py:66
// (_pass1_kernel) and reinforce.py:88 (_pass2_kernel) with one pass;
// posfeat_reward_pass replaces reinforce.py:110 (_pass3_kernel). The Python
// wrappers (posfeat_tpu_torch/ops/reinforce.py) check devices, dtypes, shapes
// and contiguity, allocate every output and scratch buffer, pass PyTorch's
// current stream, raise on a non-zero return code, and merge the
// per-row-tile partials that these kernels write.
//
// Both kernels walk the affinity aff = T * f1 . f2^T - T of one batch element
// tile by tile and never write an m x n tensor. What bounds them: at the
// training path's shapes (B = 6, m = n = 4800, D = 128) each pass is a
// 2*B*m*n*D = 35.4 GFLOP product against 30 MB of inputs, so arithmetic
// bounds them. The JAX kernels run the product at Precision.HIGHEST, and
// T = 60 multiplies any error in f1 . f2^T: one TF32 product (~5e-4
// relative) would move a logit by ~0.03 and p by ~3%, far outside the
// reference's rtol 2e-4. No atomics in either: every sum has a fixed order,
// so results are deterministic. The ragged edge (m or n not a multiple of
// the tile, D not a multiple of the depth step) is masked or zero-filled in
// the kernel; nothing is padded in memory. The TPU kernels carried their
// column sums across a sequential grid; here blocks run in any order and the
// wrapper merges the per-row-tile partials.
//
// lse pass (lse_pass_kernel): the product runs on the tensor cores as
// 3xTF32. Each operand is split once, before the product: x = hi + lo,
// hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi); each 8-deep
// step forms lo.hi + hi.lo + hi.hi on the tensor cores (the dropped lo.lo
// term is ~2^-22 relative) and adds it to an f32 running sum, rounded to
// nearest: the tensor cores' own accumulation truncates, and a chain of
// 48 MMAs per D = 128 dot moved the reduction's s0 by 0.7% on the card.
// Floor: 3 x 35.4 GFLOP at 495 TFLOP/s of TF32 = 0.215 ms; the 2 exps per
// pair (on the SFU) and the epilogue's shuffles come on top, not overlapped.
// - wgmma.m64n128k8 (tf32), both operands K-major in shared memory, in
//   core matrices without swizzle ([depth / 4][rows][4] floats): f1 [m, D]
//   and f2 [n, D] lie that way in memory, so nothing is transposed. A
//   version on the legacy mma.sync.m16n8k8 (TF32) took about 1 ms per
//   launch at the training path's shapes; wgmma's TF32 rate is several
//   times higher.
// - A first kernel (lse_split_kernel) splits f1 and f2 into hi and lo once,
//   into scratch laid out as the tiles are read, so that staging is bulk
//   copies (async proxy, no fence, no thread work) completing on
//   mbarriers. One block of 256 threads (two warpgroups, 64 rows each) per
//   (128-row tile of f1, batch element) keeps the f1 tile resident as hi
//   and lo (2 x 64 KB); f2 streams through a ring of four 16-deep chunks
//   of 128 columns (hi and lo, 16 KB each), each copied two chunks ahead
//   of its wgmmas by one thread, one barrier per chunk.
// - Two accumulator sets take turns, so that two 8-deep steps' wgmmas stay
//   queued while the step before them is added into the running sum.
// - Where the time goes (tools/profile_torch_lse_stages.py cuts the kernel
//   at its "staging" and "epilogue" comments): the epilogue does not
//   overlap the wgmmas, and neither the staging nor the adds fully do.
// - Epilogue on the accumulators, in base 2 (v = log2(e) * aff, exp2 on the
//   SFU): each warp holds 16 whole rows of the 128-column tile, so a row's
//   online (max, sum exp) needs only its quad; each column gets (max, sum
//   exp) over the warp's 16 rows by shuffles, then over the 8 warps through
//   shared memory, and one partials row per row tile is written in a fixed
//   order.
//
// reward pass (reward_pass_kernel): plain f32 FMA. One block of 256 threads
// per (64-row tile of f1, batch element) keeps its f1 tile in shared memory
// (64 x 128 f32, 32 KB, depth-major) and streams f2 through in 64-column
// tiles, 32 depth rows at a time (8 KB); each thread owns a 4 x 4 register
// tile of aff (two float4 loads per 16 FMAs, an XOR swizzle of the float4
// groups keeps the transposing stores free of bank conflicts). It forms p,
// the two epipolar distances, the reward and W in registers, writes rowW
// and the row sums of p, and per row tile the column sums of W and p and
// the tile's s0, max p, sum p and number of good pairs.

#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int TM = 64;    // rows of f1 per reward-pass block
constexpr int TN = 64;    // columns of f2 per tile
constexpr int KC = 32;    // depth rows of f2 staged at a time
constexpr int DMAX = 128; // largest descriptor width
constexpr int NT = 256;   // threads per block: 16 x 16, each a 4 x 4 tile
constexpr float kNeg = -1e30f;

enum ArgError { kBadShape = -1, kGridTooLarge = -2 };

// float4 group of row/column r stored at depth k: groups are XOR-swizzled by
// (k / 4) % 8 so that the transposing stores hit 32 distinct banks.
__device__ __forceinline__ int swz(int r, int k) {
  return ((((r >> 2) ^ ((k >> 2) & 7))) << 2) | (r & 3);
}

// Stage rows [r0, r0 + 64) of x [rows, D] at depths [kc, kc + 32) into
// s[kk][64] (kk = k - k_base), zero outside the matrix.
__device__ __forceinline__ void stage(float (*s)[TN], const float* x, int r0,
                                      int rows, int D, int kc, int k_base) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = t + NT * i;
    const int r = idx >> 3;
    const int q = idx & 7;
    const int k = kc + 4 * q;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < rows && k < D)
      v = *reinterpret_cast<const float4*>(x + size_t(r0 + r) * D + k);
    const int kk = k - k_base;
    s[kk + 0][swz(r, k + 0)] = v.x;
    s[kk + 1][swz(r, k + 1)] = v.y;
    s[kk + 2][swz(r, k + 2)] = v.z;
    s[kk + 3][swz(r, k + 3)] = v.w;
  }
}

// acc[i][j] = f1[row0 + 4 ty + i] . f2[col0 + 4 tx + j] over D, in f32 FMA.
// sA holds the block's f1 tile; sB is the staging buffer of f2.
__device__ __forceinline__ void tile_product(float acc[4][4], float (*sA)[TM],
                                             float (*sB)[TN], const float* f2,
                                             int col0, int n, int D, int Dp) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int kc = 0; kc < Dp; kc += KC) {
    __syncthreads();  // the previous chunk's reads are done
    stage(sB, f2, col0, n, D, kc, kc);
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < KC; ++kk) {
      const int k = kc + kk;
      const int g = (k >> 2) & 7;
      const float4 a = *reinterpret_cast<const float4*>(&sA[k][(ty ^ g) << 2]);
      const float4 b = *reinterpret_cast<const float4*>(&sB[kk][(tx ^ g) << 2]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

__device__ __forceinline__ void load_f1_tile(float (*sA)[TM], const float* f1,
                                             int row0, int m, int D, int Dp) {
  for (int kc = 0; kc < Dp; kc += KC) stage(sA, f1, row0, m, D, kc, 0);
}

// --------------------------------------------------------------- lse pass

constexpr int LM = 128;          // rows of f1 per block (two warpgroups x 64) = columns of f2 per tile
constexpr int LKC = 16;          // depth of one f2 chunk: two 8-deep steps
constexpr int NBUF = 4;          // f2 chunk buffers: chunk s + 2 loads while chunk s runs
constexpr int L_THREADS = 256;   // two warpgroups, 8 warps of 16 rows each
constexpr int CHUNK_FLOATS = 2 * LKC * LM;  // one f2 chunk, hi then lo: 16 KB
constexpr int SPLIT_THREADS = 256;
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;
// dynamic shared memory: f1 hi/lo, the f2 chunk ring, column partials, then
// NBUF + 1 mbarriers (one per ring buffer, one for the f1 tile)
constexpr int L_SMEM_FLOATS = 2 * DMAX * LM + NBUF * CHUNK_FLOATS + 2 * 8 * LM;
constexpr size_t L_SMEM_BYTES = size_t(L_SMEM_FLOATS) * 4 + 8 * (NBUF + 1);

// x rounded to TF32 (to nearest, ties away from zero) as an f32 value; the
// mask keeps the split below exact whatever the 13 dropped bits of a .tf32
// result hold
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r & 0xffffe000u);
}

// x = hi + lo, both TF32 values
__device__ __forceinline__ void split_store(float* hi, float* lo, float4 v) {
  float4 h, l;
  h.x = tf32_rna(v.x); l.x = tf32_rna(v.x - h.x);
  h.y = tf32_rna(v.y); l.y = tf32_rna(v.y - h.y);
  h.z = tf32_rna(v.z); l.z = tf32_rna(v.z - h.z);
  h.w = tf32_rna(v.w); l.w = tf32_rna(v.w - h.w);
  *reinterpret_cast<float4*>(hi) = h;
  *reinterpret_cast<float4*>(lo) = l;
}

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

// d[64 x 128] (+)= A[64 x 8] * B[8 x 128], both TF32 in shared memory,
// K-major, in core matrices without swizzle
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64], uint64_t da, uint64_t db,
                                                     uint32_t scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// bytes global -> shared by the bulk copy engine, completing on mbarrier bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
               ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// x [B, rows, D] split into TF32 hi and lo, in tiles of 128 rows laid out
// as the lse pass reads them: [B][tile][chunk][hi, lo][cq][128][4], each
// chunk cq groups of 4 depths, zero beyond rows and D. In shared memory
// [depth / 4][rows][4] is what wgmma reads as K-major core matrices (4
// depths of 8 consecutive rows make one 128-byte core matrix), so a chunk
// is one contiguous bulk copy. One thread per float4 of hi and of lo.
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
  if (row < rows && k < D) v = __ldg(reinterpret_cast<const float4*>(x + (size_t(b) * rows + row) * D + k));
  float* o = out + ((((size_t(b) * tiles + tile) * chunks + c) * 2 * cq + q) * LM + r) * 4;
  split_store(o, o + cq * LM * 4, v);
}

__global__ void __launch_bounds__(L_THREADS, 1) lse_pass_kernel(
    const float* __restrict__ f1s, const float* __restrict__ f2s, int m, int n,
    int D, float T, float* __restrict__ row_lse, float* __restrict__ col_max,
    float* __restrict__ col_sum) {
  extern __shared__ __align__(128) float smem[];
  float* aH = smem;                        // [DMAX / 4][LM][4]
  float* aL = aH + DMAX * LM;
  float* ring = aL + DMAX * LM;            // [NBUF][hi, lo][LKC / 4][LM][4]
  float* cM = ring + NBUF * CHUNK_FLOATS;  // [8][LM] column partials per warp
  float* cS = cM + 8 * LM;
  const uint32_t full_u = smem_u32(cS + 8 * LM), a_bar = full_u + 8 * NBUF;

  const int b = blockIdx.y, rt = blockIdx.x, n_rt = gridDim.x;
  const int row0 = rt * LM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
  const int g = lane >> 2, t = lane & 3;   // accumulator row group, thread in group
  const int DP = (D + 7) & ~7;             // depth in whole 8-deep steps, zero-filled
  const int nck = (DP + LKC - 1) / LKC;    // chunks per column tile
  const int qa = 4 * nck;                  // groups of 4 depths of the f1 tile
  const int n_ct = (n + LM - 1) / LM, steps = n_ct * nck;
  const float* A = f1s + (size_t(b) * n_rt + rt) * 2 * qa * LM * 4;
  const float* Bm = f2s + size_t(b) * n_ct * nck * CHUNK_FLOATS;
  const float Tl = T * kLog2e;

  // chunk i (column tile i / nck, depths (i % nck) * LKC ...) into ring
  // buffer i % NBUF, by thread 0
  auto fetch = [&](int i) {
    const uint32_t bar = full_u + 8 * (i % NBUF);
    mbar_expect_tx(bar, CHUNK_FLOATS * 4);
    bulk_load(smem_u32(ring + (i % NBUF) * CHUNK_FLOATS), Bm + size_t(i) * CHUNK_FLOATS, CHUNK_FLOATS * 4,
              bar);
  };
  if (tid == 0) {
    for (int i = 0; i <= NBUF; ++i) mbar_init(full_u + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(a_bar, 2 * qa * LM * 16);
    bulk_load(smem_u32(aH), A, qa * LM * 16, a_bar);
    bulk_load(smem_u32(aL), A + qa * LM * 4, qa * LM * 16, a_bar);
    fetch(0);
    if (steps > 1) fetch(1);
  }

  // this thread's accumulator rows: g and g + 8 of its warp's 16
  const int lr0 = 16 * warp + g;
  const bool rok[2] = {row0 + lr0 < m, row0 + lr0 + 8 < m};
  float rm[2] = {kNeg, kNeg}, rs[2] = {0.f, 0.f};  // running row max and sum exp2
  const uint32_t aH_u = smem_u32(aH) + wg * 64 * 16, aL_u = smem_u32(aL) + wg * 64 * 16;
  const uint32_t ring_u = smem_u32(ring);
  mbar_wait(a_bar, 0);

  float acc[64], d0[64], d1[64];
  for (int s = 0; s < steps; ++s) {
    const int ct = s / nck, c = s - ct * nck;
    const int col0 = ct * LM, kc = c * LKC;
    const int buf = s % NBUF;
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    }
    // staging begin: buffer (s + 2) % NBUF was last read by step s - 2's
    // wgmmas, which every thread waited for in step s - 1, before the
    // barrier that ended it
    if (tid == 0 && s + 2 < steps) fetch(s + 2);
    mbar_wait(full_u + 8 * buf, (s / NBUF) & 1);
    // staging end

    // Each 8-deep step's three products (small terms first) start from zero
    // in d0 (first step of a chunk) or d1 (second) and join the running sum
    // with rounded f32 adds: the tensor cores' accumulation truncates, so a
    // long chain of MMAs into one accumulator would drift by ~2^-23 of the
    // sum per MMA. A set is added, then reused, once the step two back has
    // retired, so that two steps' wgmmas stay queued.
    const int nks = min(LKC, DP - kc) / 8;
    auto issue = [&](float(&d)[64], int ks) {
      const uint32_t ao = ((kc + 8 * ks) / 4) * LM * 16, bo = buf * CHUNK_FLOATS * 4 + 2 * ks * LM * 16;
      const uint64_t ah = desc_interleave(aH_u + ao, LM * 16, 128), al = desc_interleave(aL_u + ao, LM * 16, 128);
      const uint64_t bh = desc_interleave(ring_u + bo, LM * 16, 128);
      const uint64_t bl = desc_interleave(ring_u + bo + LKC * LM * 4, LM * 16, 128);
      wgmma_fence();
      wgmma_m64n128k8_tf32(d, al, bh, 0);
      wgmma_m64n128k8_tf32(d, ah, bl, 1);
      wgmma_m64n128k8_tf32(d, ah, bh, 1);
      wgmma_commit();
      fence_acc(d);
    };
    auto add = [&](float(&d)[64]) {
      fence_acc(d);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += d[i];
    };
    wgmma_wait<1>();
    if (c > 0) add(d0);
    issue(d0, 0);
    if (nks == 2) {
      wgmma_wait<1>();
      if (c > 0) add(d1);
      issue(d1, 1);
    }

    // epilogue begin
    if (c == nck - 1) {
      wgmma_wait<0>();
      add(d0);
      if (nks == 2 || c > 0) add(d1);  // the step before this chunk's first, or its second
      // the tile's aff in base 2: v = log2(e) * (T * dot - T); acc[4j + 2h + e]
      // is row lr0 + 8h, column 8j + 2t + e of the tile
      bool cok[16][2];
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) cok[j][e] = col0 + 8 * j + 2 * t + e < n;
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = fmaf(acc[i], Tl, -Tl);

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
      // cM/cS are rewritten only after the barrier that ends this step
    }
    // epilogue end

    __syncthreads();
  }

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

__global__ void __launch_bounds__(NT) reward_pass_kernel(
    const float* __restrict__ f1, const float* __restrict__ f2,
    const float* __restrict__ line1, const float* __restrict__ c2h,
    const float* __restrict__ line2, const float* __restrict__ c1h,
    const float* __restrict__ acc1, const float* __restrict__ acc2,
    const float* __restrict__ row_lse, const float* __restrict__ col_lse, int m,
    int n, int D, float T, float thr, float good_reward, float bad_reward,
    float* __restrict__ row_w, float* __restrict__ p_rowsum,
    float* __restrict__ colw_part, float* __restrict__ pcol_part,
    float* __restrict__ tile_stats) {
  __shared__ __align__(16) float sA[DMAX][TM];
  __shared__ __align__(16) float sB[KC][TN];
  __shared__ float red_w[NT / 32][TN];
  __shared__ float red_p[NT / 32][TN];
  __shared__ float red_b[4][NT / 32];

  const int b = blockIdx.y, rt = blockIdx.x, n_rt = gridDim.x;
  const int row0 = rt * TM;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int Dp = (D + KC - 1) / KC * KC;
  const float* A = f1 + size_t(b) * m * D;
  const float* Bm = f2 + size_t(b) * n * D;

  load_f1_tile(sA, A, row0, m, D, Dp);

  // this thread's 4 rows: line1, c1h, accept, row lse
  bool rok[4];
  float l1[4][3], c1[4][3], a1[4], rl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + 4 * ty + i;
    rok[i] = row < m;
    const size_t r = size_t(b) * m + (rok[i] ? row : 0);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      l1[i][c] = line1[3 * r + c];
      c1[i][c] = c1h[3 * r + c];
    }
    a1[i] = acc1[r];
    rl[i] = row_lse[r];
  }

  float rw[4] = {0.f, 0.f, 0.f, 0.f}, rp[4] = {0.f, 0.f, 0.f, 0.f};
  float s0 = 0.f, pmax = 0.f, psum = 0.f, ngood = 0.f;
  float acc[4][4];
  for (int col0 = 0; col0 < n; col0 += TN) {
    tile_product(acc, sA, sB, Bm, col0, n, D, Dp);
    float cw[4], cp[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + 4 * tx + j;
      const bool cok = col < n;
      const size_t c = size_t(b) * n + (cok ? col : 0);
      const float c2x = c2h[3 * c], c2y = c2h[3 * c + 1], c2z = c2h[3 * c + 2];
      const float l2x = line2[3 * c], l2y = line2[3 * c + 1], l2z = line2[3 * c + 2];
      const float a2 = acc2[c], cl = col_lse[c];
      cw[j] = 0.f;
      cp[j] = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (!(cok && rok[i])) continue;
        const float aff = T * acc[i][j] - T;
        const float lp = (aff - rl[i]) + (aff - cl);
        const float p = expf(lp);
        // three products, two sums, each rounded: the plain version's order
        const float d1 = fabsf(__fadd_rn(__fadd_rn(__fmul_rn(l1[i][0], c2x), __fmul_rn(l1[i][1], c2y)),
                                         __fmul_rn(l1[i][2], c2z)));
        const float d2 = fabsf(__fadd_rn(__fadd_rn(__fmul_rn(c1[i][0], l2x), __fmul_rn(c1[i][1], l2y)),
                                         __fmul_rn(c1[i][2], l2z)));
        const bool good = (d1 < thr) && (d2 < thr);
        const float w = a1[i] * a2 * (good ? good_reward : bad_reward) * p;
        s0 += w * lp;
        rw[i] += w;
        rp[i] += p;
        cw[j] += w;
        cp[j] += p;
        pmax = fmaxf(pmax, p);
        psum += p;
        ngood += good ? 1.f : 0.f;
      }
      cw[j] += __shfl_xor_sync(0xffffffffu, cw[j], 16);
      cp[j] += __shfl_xor_sync(0xffffffffu, cp[j], 16);
    }
    if (lane < 16) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        red_w[warp][4 * tx + j] = cw[j];
        red_p[warp][4 * tx + j] = cp[j];
      }
    }
    __syncthreads();
    if (threadIdx.x < TN && col0 + threadIdx.x < n) {
      float W = 0.f, P = 0.f;
#pragma unroll
      for (int w = 0; w < NT / 32; ++w) W += red_w[w][threadIdx.x], P += red_p[w][threadIdx.x];
      const size_t o = (size_t(b) * n_rt + rt) * n + col0 + threadIdx.x;
      colw_part[o] = W;
      pcol_part[o] = P;
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) {
      rw[i] += __shfl_xor_sync(0xffffffffu, rw[i], off);
      rp[i] += __shfl_xor_sync(0xffffffffu, rp[i], off);
    }
    const int row = row0 + 4 * ty + i;
    if (tx == 0 && row < m) {
      row_w[size_t(b) * m + row] = rw[i];
      p_rowsum[size_t(b) * m + row] = rp[i];
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
  if (lane == 0) {
    red_b[0][warp] = s0;
    red_b[1][warp] = pmax;
    red_b[2][warp] = psum;
    red_b[3][warp] = ngood;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float S0 = 0.f, PM = 0.f, PS = 0.f, NG = 0.f;
    for (int w = 0; w < NT / 32; ++w) {
      S0 += red_b[0][w];
      PM = fmaxf(PM, red_b[1][w]);
      PS += red_b[2][w];
      NG += red_b[3][w];
    }
    float* o = tile_stats + (size_t(b) * n_rt + rt) * 4;
    o[0] = S0;
    o[1] = PM;
    o[2] = PS;
    o[3] = NG;
  }
}

int check_shape(int B, int m, int n, int D) {
  if (B < 1 || m < 1 || n < 1 || D < 4 || D > DMAX || D % 4) return kBadShape;
  if (B > 65535) return kGridTooLarge;
  return 0;
}

}  // namespace

extern "C" {

// Returns 0, a cudaError_t value, or a negative ArgError. f1s and f2s are
// scratch for f1 and f2 split into TF32 hi and lo in tiles:
// B * ceil(m / 128) * 2 * 16 * ceil(DP / 16) * 128 and B * ceil(n / 128) * 2
// * 16 * ceil(DP / 16) * 128 floats, DP = D rounded up to a multiple of 8.
// row_lse [B, m]; col_max, col_sum [B, ceil(m / 128), n] partials, the max
// in natural units.
int posfeat_lse_pass(const void* f1, const void* f2, void* f1s, void* f2s, void* row_lse,
                     void* col_max, void* col_sum, int B, int m, int n, int D, float T,
                     void* stream) {
  if (int rc = check_shape(B, m, n, D)) return rc;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nck = ((D + 7) / 8 * 8 + LKC - 1) / LKC, mt = (m + LM - 1) / LM, nt = (n + LM - 1) / LM;
  auto split = [&](const void* x, int rows, int tiles, int chunks, int cq, void* out) {
    const size_t per_b = size_t(tiles) * chunks * cq * LM;
    dim3 grid(unsigned((per_b + SPLIT_THREADS - 1) / SPLIT_THREADS), B);
    lse_split_kernel<<<grid, SPLIT_THREADS, 0, st>>>(static_cast<const float*>(x), rows, D, tiles,
                                                      chunks, cq, static_cast<float*>(out));
    return cudaGetLastError();
  };
  cudaError_t err = split(f1, m, mt, 1, 4 * nck, f1s);
  if (err == cudaSuccess) err = split(f2, n, nt, nck, LKC / 4, f2s);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(lse_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               int(L_SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  lse_pass_kernel<<<dim3(mt, B), L_THREADS, L_SMEM_BYTES, st>>>(
      static_cast<const float*>(f1s), static_cast<const float*>(f2s), m, n, D, T,
      static_cast<float*>(row_lse), static_cast<float*>(col_max), static_cast<float*>(col_sum));
  return int(cudaGetLastError());
}

// row_w, p_rowsum [B, m]; colw_part, pcol_part [B, ceil(m / 64), n];
// tile_stats [B, ceil(m / 64), 4] = (s0, max p, sum p, good pairs) per tile.
int posfeat_reward_pass(const void* f1, const void* f2, const void* line1,
                        const void* c2h, const void* line2, const void* c1h,
                        const void* acc1, const void* acc2, const void* row_lse,
                        const void* col_lse, void* row_w, void* p_rowsum,
                        void* colw_part, void* pcol_part, void* tile_stats, int B,
                        int m, int n, int D, float T, float thr, float good_reward,
                        float bad_reward, void* stream) {
  if (int rc = check_shape(B, m, n, D)) return rc;
  dim3 grid((m + TM - 1) / TM, B);
  reward_pass_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f1), static_cast<const float*>(f2),
      static_cast<const float*>(line1), static_cast<const float*>(c2h),
      static_cast<const float*>(line2), static_cast<const float*>(c1h),
      static_cast<const float*>(acc1), static_cast<const float*>(acc2),
      static_cast<const float*>(row_lse), static_cast<const float*>(col_lse), m, n,
      D, T, thr, good_reward, bad_reward, static_cast<float*>(row_w),
      static_cast<float*>(p_rowsum), static_cast<float*>(colw_part),
      static_cast<float*>(pcol_part), static_cast<float*>(tile_stats));
  return int(cudaGetLastError());
}

const char* posfeat_reinforce_error_string(int code) {
  switch (code) {
    case kBadShape:
      return "shape outside what the kernel supports (D must be a multiple of 4, at most 128)";
    case kGridTooLarge:
      return "batch too large for one launch";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
