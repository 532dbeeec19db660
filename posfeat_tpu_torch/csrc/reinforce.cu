// Streamed stage-2 REINFORCE reduction for Hopper (sm_90a), plain C interface.
//
// posfeat_lse_pass replaces posfeat_tpu/ops/pallas/reinforce.py:66
// (_pass1_kernel) and reinforce.py:88 (_pass2_kernel) with one pass;
// posfeat_reward_pass replaces reinforce.py:110 (_pass3_kernel). The Python
// wrappers (posfeat_tpu_torch/ops/reinforce.py) check devices, dtypes, shapes
// and contiguity, allocate every output and scratch buffer, pass PyTorch's
// current stream, raise on a non-zero return code, and sum the per-row-tile
// partials that these kernels write.
//
// Both kernels walk the affinity aff = T * f1 . f2^T - T of one batch element
// in 64 x 64 tiles and never write an m x n tensor.
//
// What bounds them: at the training path's shapes (B = 6, m = n = 4800,
// D = 128) each pass is a 2*B*m*n*D = 35.4 GFLOP product against 30 MB of
// inputs, so arithmetic bounds them: 0.53 ms each at 67 TFLOP/s of f32 FMA.
// The products are plain f32 FMA, with no tensor cores and no TF32: the JAX
// kernels run the product at Precision.HIGHEST, and T = 60 multiplies any
// error in f1 . f2^T, so TF32's ~5e-4 relative error would move a logit by
// ~0.03 and p by ~3%, far outside the reference's rtol 2e-4.
//
// Design: one block of 256 threads per (64-row tile of f1, batch element).
// The block keeps its f1 tile in shared memory for the whole pass (64 x 128
// f32, 32 KB) and streams f2 through in 64-column tiles, 32 depth rows at a
// time (8 KB). Both are stored depth-major, so a thread reads its 4 rows and
// its 4 columns of one depth step as two float4 loads and does 16 FMAs; an
// XOR swizzle of the float4 groups keeps the transposing stores free of bank
// conflicts. Each thread owns a 4 x 4 register tile of aff.
//   - lse pass: the row max and the row sum of exp run online (rescaled when
//     the max grows), so one pass replaces the two TPU passes. Each block
//     writes its rows' log-sum-exp and, per column, a (max, sum exp) partial
//     over its 64 rows into a [B, row tiles, n] scratch that the wrapper
//     merges into the column log-sum-exp.
//   - reward pass: recomputes aff, forms p, the two epipolar distances, the
//     reward and W in registers, writes rowW and the row sums of p, and per
//     row tile the column sums of W and p and the tile's s0, max p, sum p and
//     number of good pairs.
// No atomics: every sum has a fixed order, so results are deterministic. The
// ragged edge (m or n not a multiple of 64, D not a multiple of 32) is masked
// in the kernel; nothing is padded in memory. The TPU kernels carried their
// column sums across a sequential grid; here blocks run in any order and the
// wrapper sums the per-tile partials.

#include <cuda_runtime.h>

namespace {

constexpr int TM = 64;    // rows of f1 per block
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

// (m1, s1) <- merge of two (max, sum exp(x - max)) pairs
__device__ __forceinline__ void lse_merge(float& m1, float& s1, float m2, float s2) {
  const float M = fmaxf(m1, m2);
  s1 = s1 * expf(m1 - M) + s2 * expf(m2 - M);
  m1 = M;
}

// --------------------------------------------------------------- lse pass

__global__ void __launch_bounds__(NT) lse_pass_kernel(
    const float* __restrict__ f1, const float* __restrict__ f2, int m, int n,
    int D, float T, float* __restrict__ row_lse, float* __restrict__ col_max,
    float* __restrict__ col_sum) {
  __shared__ __align__(16) float sA[DMAX][TM];
  __shared__ __align__(16) float sB[KC][TN];
  __shared__ float red_m[NT / 32][TN];
  __shared__ float red_s[NT / 32][TN];

  const int b = blockIdx.y, rt = blockIdx.x, n_rt = gridDim.x;
  const int row0 = rt * TM;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int Dp = (D + KC - 1) / KC * KC;
  const float* A = f1 + size_t(b) * m * D;
  const float* Bm = f2 + size_t(b) * n * D;

  load_f1_tile(sA, A, row0, m, D, Dp);

  float rm[4], rs[4];  // running row max and sum exp over this thread's columns
#pragma unroll
  for (int i = 0; i < 4; ++i) rm[i] = kNeg, rs[i] = 0.f;

  float acc[4][4];
  for (int col0 = 0; col0 < n; col0 += TN) {
    tile_product(acc, sA, sB, Bm, col0, n, D, Dp);
    bool rok[4], cok[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) rok[i] = row0 + 4 * ty + i < m;
#pragma unroll
    for (int j = 0; j < 4; ++j) cok[j] = col0 + 4 * tx + j < n;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = T * acc[i][j] - T;

    // rows: online over this thread's columns
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tmax = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (cok[j]) tmax = fmaxf(tmax, acc[i][j]);
      if (tmax > rm[i]) {
        rs[i] *= expf(rm[i] - tmax);
        rm[i] = tmax;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (cok[j]) rs[i] += expf(acc[i][j] - rm[i]);
    }

    // columns: (max, sum exp) over this tile's rows
    float cm[4], cs[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      cm[j] = kNeg;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (rok[i]) cm[j] = fmaxf(cm[j], acc[i][j]);
      cs[j] = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (rok[i]) cs[j] += expf(acc[i][j] - cm[j]);
      // the warp's other 4-row group (ty ^ 1) holds the same columns
      const float om = __shfl_xor_sync(0xffffffffu, cm[j], 16);
      const float os = __shfl_xor_sync(0xffffffffu, cs[j], 16);
      lse_merge(cm[j], cs[j], om, os);
    }
    if (lane < 16) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        red_m[warp][4 * tx + j] = cm[j];
        red_s[warp][4 * tx + j] = cs[j];
      }
    }
    __syncthreads();
    if (threadIdx.x < TN && col0 + threadIdx.x < n) {
      float M = red_m[0][threadIdx.x], S = red_s[0][threadIdx.x];
#pragma unroll
      for (int w = 1; w < NT / 32; ++w) lse_merge(M, S, red_m[w][threadIdx.x], red_s[w][threadIdx.x]);
      const size_t o = (size_t(b) * n_rt + rt) * n + col0 + threadIdx.x;
      col_max[o] = M;
      col_sum[o] = S;
    }
    // red_* is rewritten only after the next tile's __syncthreads pair
  }

  // rows: merge the 16 threads (tx) that share each row
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, rm[i], off);
      const float os = __shfl_xor_sync(0xffffffffu, rs[i], off);
      lse_merge(rm[i], rs[i], om, os);
    }
    const int row = row0 + 4 * ty + i;
    if (tx == 0 && row < m) row_lse[size_t(b) * m + row] = rm[i] + logf(fmaxf(rs[i], 1e-30f));
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

// Returns 0, a cudaError_t value, or a negative ArgError.
// row_lse [B, m]; col_max, col_sum [B, ceil(m / 64), n] partials.
int posfeat_lse_pass(const void* f1, const void* f2, void* row_lse, void* col_max,
                     void* col_sum, int B, int m, int n, int D, float T, void* stream) {
  if (int rc = check_shape(B, m, n, D)) return rc;
  dim3 grid((m + TM - 1) / TM, B);
  lse_pass_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f1), static_cast<const float*>(f2), m, n, D, T,
      static_cast<float*>(row_lse), static_cast<float*>(col_max),
      static_cast<float*>(col_sum));
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
