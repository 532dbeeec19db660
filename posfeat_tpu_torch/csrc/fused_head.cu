// Fused KeypointDet head kernels for Hopper (sm_90a), plain C interface.
//
// K1 posfeat_conv_phase replaces posfeat_tpu/ops/pallas/fused_head.py:148
// (_conv_kernel_v3). K2 posfeat_head_tail replaces fused_head.py:284
// (_tail_kernel). The Python wrappers (posfeat_tpu_torch/ops/fused_head.py)
// check devices, dtypes, shapes and contiguity, allocate every output, pass
// PyTorch's current stream, and raise on a non-zero return code.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libposfeat_kernels.so fused_head.cu
// (posfeat_tpu_torch/ops/_build.py does this on first use.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

using namespace nvcuda;
using bf16 = __nv_bfloat16;

namespace {

// ------------------------------------------------------------------- K1
//
// z[b, y, x, n] = sum_{dy,dx,c} tp[b, y+dy, x+dx, c] * kph[dy*3+dx, c, n]
//               + sum_p pat[b, y, x, p] * wm[b, p, n] + b2b[b, n]
// plus per-tile column sums of z and z^2, taken from the f32 accumulator
// before z is rounded to bf16.
//
// What bounds it: at the flagship point (B=16, h=120, w=160, C=192,
// N=16*128=2048, KP=192) it is an implicit GEMM with M = B*h*w trunk
// cells, N = 2048, K = 9*192 + 192 = 1920: 151 GFLOP per image against
// about 94 MB per image of traffic (mostly the z write), so the tensor
// cores bound it (0.153 ms per image at 989 TFLOP/s bf16).
//
// Design: one block computes a TH x TW tile of trunk cells (BM = 64 rows
// of the GEMM) against BN = 128 output channels. It stages the tile's
// trunk cells with their 1-cell halo (the edge-padded trunk, so no
// boundary tests in the MMA loop) and the tile's patch rows in shared
// memory once, then walks K: 9 taps x C channels of the halo tile against
// kph, then KP patch channels against wm[b], staging KC = 32 rows of the
// B operand at a time. The TPU kernel carried its halo DMA across a
// sequential grid; here every block loads its own halo, so blocks run in
// any order. MMAs are bf16 WMMA 16x16x16 with f32 accumulators; 8 warps
// each own a 32 x 32 piece of the 64 x 128 block tile. Row strides in
// shared memory are padded by 16 bf16 (32 bytes) to keep WMMA's 32-byte
// alignment while spreading rows over banks. The epilogue stages the
// accumulators in shared memory (reusing the operand space), adds the
// bias, writes z as bf16 pairs and reduces each column over the tile's
// valid cells. Each tile writes its own partials row: no atomics, so the
// moments are deterministic. wgmma, TMA and a pipelined K loop come later.

constexpr int TH = 4;
constexpr int TW = 16;
constexpr int BM = TH * TW;  // 64
constexpr int BN = 128;
constexpr int KC = 32;
constexpr int PAD = 16;
constexpr int BS = BN + PAD;  // B-tile row stride (bf16)
constexpr int CT = BN + 4;    // accumulator staging row stride (f32)
constexpr int K1_THREADS = 256;

size_t k1_smem_bytes(int C, int KP) {
  size_t halo = size_t(TH + 2) * (TW + 2) * (C + PAD) * sizeof(bf16);
  size_t ptile = size_t(BM) * (KP + PAD) * sizeof(bf16);
  size_t btile = size_t(KC) * BS * sizeof(bf16);
  size_t ops = halo + ptile + btile;
  size_t ctile = size_t(BM) * CT * sizeof(float);
  return ops > ctile ? ops : ctile;
}

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
}

__global__ void __launch_bounds__(K1_THREADS)
conv_phase_kernel(const bf16* __restrict__ tp, const bf16* __restrict__ kph,
                  const bf16* __restrict__ pat, const bf16* __restrict__ wm,
                  const float* __restrict__ b2b, bf16* __restrict__ z,
                  float* __restrict__ psum, float* __restrict__ psq, int h,
                  int w, int C, int KP, int N) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int CS = C + PAD;
  const int PS = KP + PAD;
  bf16* halo = reinterpret_cast<bf16*>(smem);  // [(TH+2)*(TW+2)][CS]
  bf16* ptile = halo + (TH + 2) * (TW + 2) * CS;  // [BM][PS]
  bf16* btile = ptile + BM * PS;                  // [KC][BS]
  float* ctile = reinterpret_cast<float*>(smem);  // [BM][CT], after the K loop

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int ntx = (w + TW - 1) / TW;
  const int nty = (h + TH - 1) / TH;
  const int T = ntx * nty;
  const int b = blockIdx.y / T;
  const int tile = blockIdx.y % T;
  const int y0 = (tile / ntx) * TH;
  const int x0 = (tile % ntx) * TW;
  const int hp = h + 2, wp = w + 2;

  // stage the halo tile (rows y0..y0+TH+1, columns x0..x0+TW+1 of tp)
  const int C8 = C / 8;
  for (int i = tid; i < (TH + 2) * (TW + 2) * C8; i += K1_THREADS) {
    const int cell = i / C8, c8 = i % C8;
    const int gy = y0 + cell / (TW + 2), gx = x0 + cell % (TW + 2);
    bf16* dst = halo + cell * CS + c8 * 8;
    if (gy < hp && gx < wp) {
      copy16(dst, tp + ((size_t(b) * hp + gy) * wp + gx) * C + c8 * 8);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  }
  // stage the tile's patch rows
  const int KP8 = KP / 8;
  for (int i = tid; i < BM * KP8; i += K1_THREADS) {
    const int cell = i / KP8, k8 = i % KP8;
    const int gy = y0 + cell / TW, gx = x0 + cell % TW;
    bf16* dst = ptile + cell * PS + k8 * 8;
    if (gy < h && gx < w) {
      copy16(dst, pat + ((size_t(b) * h + gy) * w + gx) * KP + k8 * 8);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  }

  const int warp = tid / 32;
  const int wr = warp / 4;  // tile rows 2*wr, 2*wr+1 (16 cells each)
  const int wc = warp % 4;  // channels wc*32 .. wc*32+31 of the block
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  // one KC x BN chunk of a row-major [K, N] operand into btile
  auto stage_b = [&](const bf16* src) {
    for (int i = tid; i < KC * (BN / 8); i += K1_THREADS) {
      const int r = i / (BN / 8), c8 = i % (BN / 8);
      copy16(btile + r * BS + c8 * 8, src + size_t(r) * N + c8 * 8);
    }
  };
  auto mma_chunk = [&](const bf16* a_base, int a_row_step, int lda) {
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], a_base + (2 * wr + i) * a_row_step + kk, lda);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], btile + kk * BS + wc * 32 + j * 16, BS);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  };

  // trunk half: 9 taps of the halo tile against kph[tap]
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3, dx = tap % 3;
    for (int k0 = 0; k0 < C; k0 += KC) {
      __syncthreads();  // staging done / previous chunk consumed
      stage_b(kph + (size_t(tap) * C + k0) * N + n0);
      __syncthreads();
      // fragment row i = cell (row, dx + i) of the halo tile
      mma_chunk(halo + (dy * (TW + 2) + dx) * CS + k0, (TW + 2) * CS, CS);
    }
  }
  // image half: the tile's patches against wm[b]
  for (int k0 = 0; k0 < KP; k0 += KC) {
    __syncthreads();
    stage_b(wm + (size_t(b) * KP + k0) * N + n0);
    __syncthreads();
    mma_chunk(ptile + k0, TW * PS, PS);
  }
  __syncthreads();  // every warp is done with the operand tiles

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(ctile + (2 * wr + i) * 16 * CT + wc * 32 + j * 16,
                              acc[i][j], CT, wmma::mem_row_major);
  __syncthreads();

  const float* bias = b2b + size_t(b) * N + n0;
  for (int i = tid; i < BM * (BN / 2); i += K1_THREADS) {
    const int r = i / (BN / 2), c = 2 * (i % (BN / 2));
    const int gy = y0 + r / TW, gx = x0 + r % TW;
    if (gy < h && gx < w) {
      const float v0 = ctile[r * CT + c] + bias[c];
      const float v1 = ctile[r * CT + c + 1] + bias[c + 1];
      *reinterpret_cast<__nv_bfloat162*>(z + ((size_t(b) * h + gy) * w + gx) * N + n0 + c) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
  if (tid < BN) {
    const float bc = bias[tid];
    float s = 0.f, q = 0.f;
    for (int r = 0; r < BM; ++r) {
      if (y0 + r / TW < h && x0 + r % TW < w) {
        const float v = ctile[r * CT + tid] + bc;
        s += v;
        q += v * v;
      }
    }
    const size_t o = (size_t(b) * T + tile) * N + n0 + tid;
    psum[o] = s;
    psq[o] = q;
  }
}

// ------------------------------------------------------------------- K2
//
// For each phase row r of image b (R = h*w*16 rows of Cout channels):
//   x = PReLU((z[b, r, :] - mu[b]) * sc[b]);  u[b, r, o] = x . w3[:, o] + b3[o]
// plus per-block sums of u and u^2 per output channel.
//
// What bounds it: it reads z once (78.6 MB per image at the flagship point)
// and writes u (1.2 MB per image for one output channel), a few FLOP per
// byte: device memory bandwidth bounds it (about 24 us per image at
// 3.35 TB/s).
//
// Design: a row is read by LPR = Cout/8 lanes, each with one 16-byte load
// of 8 bf16, so a warp reads 32/LPR whole rows per step, coalesced. Each
// lane keeps its 8 channels' mu, sc and w3 in registers for the whole
// block (rows of one block belong to one image). The per-row dot product
// is finished by xor shuffles inside each lane group; each block owns
// ROWS rows of one image and writes one partials row, reduced in a fixed
// order through shared memory, so the moments are deterministic. There is
// no tensor-core work: out_ch is 1 or 2.

constexpr int K2_THREADS = 256;
constexpr int K2_WARPS = K2_THREADS / 32;
constexpr int MAXO = 4;

__global__ void __launch_bounds__(K2_THREADS)
head_tail_kernel(const bf16* __restrict__ z, const float* __restrict__ mu,
                 const float* __restrict__ sc, const float* __restrict__ a,
                 const float* __restrict__ w3, const float* __restrict__ b3,
                 float* __restrict__ u, float* __restrict__ usum,
                 float* __restrict__ usq, int R, int cout, int out_ch,
                 int rows_per_block) {
  __shared__ float red[K2_WARPS][2 * MAXO];
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(r0 + rows_per_block, R);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int lpr = cout / 8;            // lanes per row
  const int rpw = 32 / lpr;            // rows per warp step
  const int sub = lane / lpr;          // row within the step
  const int c0 = (lane % lpr) * 8;     // this lane's first channel
  const float slope = a[0];

  float m[8], s[8], wv[8][MAXO];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    m[j] = mu[size_t(b) * cout + c0 + j];
    s[j] = sc[size_t(b) * cout + c0 + j];
#pragma unroll
    for (int o = 0; o < MAXO; ++o) wv[j][o] = o < out_ch ? w3[(c0 + j) * out_ch + o] : 0.f;
  }
  float bias[MAXO], tsum[MAXO], tsq[MAXO];
#pragma unroll
  for (int o = 0; o < MAXO; ++o) {
    bias[o] = o < out_ch ? b3[o] : 0.f;
    tsum[o] = 0.f;
    tsq[o] = 0.f;
  }

  const bf16* zb = z + size_t(b) * R * cout;
  for (int r = r0 + warp * rpw + sub; r - sub < r1; r += K2_WARPS * rpw) {
    const bool valid = r < r1;
    float acc[MAXO] = {0.f, 0.f, 0.f, 0.f};
    if (valid) {
      uint4 raw = *reinterpret_cast<const uint4*>(zb + size_t(r) * cout + c0);
      const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(v2[j]);
        float x0 = (f.x - m[2 * j]) * s[2 * j];
        float x1 = (f.y - m[2 * j + 1]) * s[2 * j + 1];
        x0 = x0 >= 0.f ? x0 : slope * x0;
        x1 = x1 >= 0.f ? x1 : slope * x1;
#pragma unroll
        for (int o = 0; o < MAXO; ++o) acc[o] += x0 * wv[2 * j][o] + x1 * wv[2 * j + 1][o];
      }
    }
    // finish the dot product inside each lane group
#pragma unroll
    for (int o = 0; o < MAXO; ++o)
      for (int off = lpr / 2; off > 0; off /= 2)
        acc[o] += __shfl_xor_sync(0xffffffffu, acc[o], off);
    if (valid && lane % lpr == 0) {
      for (int o = 0; o < out_ch; ++o) {
        const float v = acc[o] + bias[o];
        u[(size_t(b) * R + r) * out_ch + o] = v;
        tsum[o] += v;
        tsq[o] += v * v;
      }
    }
  }
  // block reduction in a fixed order: lanes, then warps
#pragma unroll
  for (int o = 0; o < MAXO; ++o) {
    for (int off = 16; off > 0; off /= 2) {
      tsum[o] += __shfl_xor_sync(0xffffffffu, tsum[o], off);
      tsq[o] += __shfl_xor_sync(0xffffffffu, tsq[o], off);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int o = 0; o < MAXO; ++o) {
      red[warp][o] = tsum[o];
      red[warp][MAXO + o] = tsq[o];
    }
  }
  __syncthreads();
  if (threadIdx.x < out_ch) {
    const int o = threadIdx.x;
    float s1 = 0.f, s2 = 0.f;
    for (int i = 0; i < K2_WARPS; ++i) {
      s1 += red[i][o];
      s2 += red[i][MAXO + o];
    }
    const size_t idx = (size_t(b) * gridDim.x + blockIdx.x) * out_ch + o;
    usum[idx] = s1;
    usq[idx] = s2;
  }
}

enum ArgError {
  kBadTile = -1,
  kBadShape = -2,
  kGridTooLarge = -3,
};

}  // namespace

extern "C" {

// Returns 0, a cudaError_t value, or a negative ArgError.
int posfeat_conv_phase(const void* tp, const void* kph, const void* pat,
                       const void* wm, const void* b2b, void* z, void* psum,
                       void* psq, int B, int h, int w, int C, int KP, int N,
                       int th, int tw, void* stream) {
  if (th != TH || tw != TW) return kBadTile;
  if (C % KC || KP % KC || N % BN || B < 1 || h < 1 || w < 1) return kBadShape;
  const long tiles = long(B) * ((h + TH - 1) / TH) * ((w + TW - 1) / TW);
  if (tiles > 65535) return kGridTooLarge;
  const size_t smem = k1_smem_bytes(C, KP);
  cudaError_t err = cudaFuncSetAttribute(
      conv_phase_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid(N / BN, unsigned(tiles));
  conv_phase_kernel<<<grid, K1_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(tp), static_cast<const bf16*>(kph),
      static_cast<const bf16*>(pat), static_cast<const bf16*>(wm),
      static_cast<const float*>(b2b), static_cast<bf16*>(z),
      static_cast<float*>(psum), static_cast<float*>(psq), h, w, C, KP, N);
  return int(cudaGetLastError());
}

int posfeat_head_tail(const void* z, const void* mu, const void* sc,
                      const void* a, const void* w3, const void* b3, void* u,
                      void* usum, void* usq, int B, int R, int cout, int out_ch,
                      int rows_per_block, void* stream) {
  const int lpr = cout / 8;
  if (cout % 8 || lpr > 32 || (lpr & (lpr - 1)) || out_ch < 1 || out_ch > MAXO ||
      rows_per_block < 1 || B < 1 || B > 65535 || R < 1)
    return kBadShape;
  dim3 grid((R + rows_per_block - 1) / rows_per_block, B);
  head_tail_kernel<<<grid, K2_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(z), static_cast<const float*>(mu),
      static_cast<const float*>(sc), static_cast<const float*>(a),
      static_cast<const float*>(w3), static_cast<const float*>(b3),
      static_cast<float*>(u), static_cast<float*>(usum), static_cast<float*>(usq),
      R, cout, out_ch, rows_per_block);
  return int(cudaGetLastError());
}

const char* posfeat_error_string(int code) {
  switch (code) {
    case kBadTile:
      return "K1 tile size differs from the compiled TH x TW";
    case kBadShape:
      return "shape outside what the kernel supports";
    case kGridTooLarge:
      return "too many tiles for one launch";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
