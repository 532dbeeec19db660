// f32 instances of the fused head's conv kernels for Hopper (sm_90a),
// plain C interface.
//
// posfeat_conv_phase_f32 is K1 at f32 (replaces posfeat_tpu/ops/pallas/
// fused_head.py:148 _conv_kernel_v3 where the head runs at float32);
// posfeat_conv_phase_img_f32 is K3 (fused_head.py:70 _conv_kernel, the v1
// dataflow), T1 (tools/bench_fused_parts.py:105 _conv_kernel_noz) and T2
// (bench_fused_parts.py:154 _conv_kernel_prephase) at f32. They compute
// what the bf16 kernels of fused_head.cu compute,
//   z[b, y, x, n] = sum_{dy,dx,c} tp[b, y+dy, x+dx, c] * kph[dy*3+dx, c, n]
//                 + (K1) sum_p pat[b, y, x, p] * wm[b, p, n] + b2b[b, n]
//                 + (K3, T2) the image term Z[b, y, x, n] + b2[n],
// with z stored as f32, plus per-tile column sums of z and z^2, in the same
// [B, T, N] partials layout over the same 8 x 16 trunk tiles. The Python
// wrappers (posfeat_tpu_torch/ops/fused_head.py) check devices, dtypes,
// shapes, contiguity and alignment, allocate every output, pass PyTorch's
// current stream, and raise on a non-zero return code.
//
// Arithmetic: every product and sum in f32 on the CUDA cores (FFMA), as
// the Pallas kernel computes at f32 (interpret mode: exact f32 products).
// One TF32 pass would put ~5e-4 relative errors into z; this kernel's
// errors are those of f32 sums in another order.
//
// What bounds it: at the flagship point (B = 16, h = 120, w = 160, C = 192,
// N = 16 * 128 = 2048, KP = 192) K1 is 2.42 TFLOP per launch against
// 2.6 GB of traffic (mostly the f32 z write), so arithmetic bounds it:
// 36.1 ms at 67 TFLOP/s of f32 FMA, 14.6 ms if the same products ran as
// 3xTF32 on the tensor cores (a later redesign's target).
//
// Design (simple first): one block of 256 threads = one 8 x 16 tile of
// trunk cells (BM = 128 GEMM rows) x 128 output channels; blockIdx.x walks
// N, so the blocks of one tile run side by side and share its halo in L2.
// - The reduction dimension goes in chunks of 8 channels: for a trunk
//   chunk, the tile's 10 x 18 halo cells and all 9 taps of kph (9 x 8 x
//   128); for a patch chunk (K1), the tile's 128 patch rows and 8 rows of
//   wm[b]. Chunks are copied by cp.async into a double-buffered stage
//   (42.6 KB each, 85.2 KB a block, two blocks an SM), the next chunk's
//   copy in flight while the current one is multiplied.
// - Thread (tc, tn) owns 8 cells (tile row tc % 8, columns 8 (tc / 8) ..
//   + 7) x 8 channels (4 tn .. 4 tn + 3 and 64 + 4 tn .. + 3): 64 f32
//   accumulators. Per chunk channel and tap row dy it reads 10 halo values
//   and, per tap, two float4 of kph: 192 FMAs per 16 loads. The two cell
//   groups of a warp are one tile row apart (18 halo cells: other banks);
//   its 16 channel groups read 256 contiguous bytes.
// - Epilogue from the registers: z = acc + bias (+ Z), stored as two
//   float4 per cell; the column sums of z and z^2 over the tile's valid
//   cells go through shared memory, summed over the 16 cell groups in a
//   fixed order: deterministic, no atomics.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TH = 8;
constexpr int TW = 16;
constexpr int BM = TH * TW;  // 128 cells a tile
constexpr int BN = 128;      // output channels a block
constexpr int KC = 8;        // reduction channels a chunk
constexpr int THREADS = 256;
constexpr int HALO_W = TW + 2;
constexpr int HALO_CELLS = (TH + 2) * HALO_W;  // 180
constexpr int PAT_ROW = TW * KC + 16;          // a patch-tile row, padded: its two cell groups on other banks
constexpr int A_FLOATS = HALO_CELLS * KC;      // >= TH * PAT_ROW
constexpr int B_FLOATS = 9 * KC * BN;
constexpr int STAGE_FLOATS = A_FLOATS + B_FLOATS;
constexpr size_t SMEM_BYTES = 2 * STAGE_FLOATS * 4;  // 85,248
static_assert(TH * PAT_ROW <= A_FLOATS, "the patch tile fits the halo's room");
static_assert(2 * 16 * BN <= 2 * STAGE_FLOATS, "the moment partials fit the stages");

enum ImageTerm { kPatches = 0, kImgFull = 1, kImgNone = 2, kImgPhase = 3 };
enum ArgError { kBadTile = -1, kBadShape = -2 };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zeros when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, 2)
conv_f32_kernel(const float* __restrict__ tp, const float* __restrict__ kph, const float* __restrict__ pat,
                const float* __restrict__ wm, const float* __restrict__ img, const float* __restrict__ bias_all,
                int bias_bstride, float* __restrict__ z, float* __restrict__ psum, float* __restrict__ psq,
                int h, int w, int C, int KP, int N, int cout) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool kPat = MODE == kPatches;
  constexpr bool kHasImg = MODE == kImgFull || MODE == kImgPhase;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, tile = blockIdx.y, b = blockIdx.z;
  const int ntx = (w + TW - 1) / TW;
  const int T = ntx * ((h + TH - 1) / TH);
  const int y0 = (tile / ntx) * TH, x0 = (tile % ntx) * TW;
  const int hp = h + 2, wp = w + 2;
  const int nc = C / KC, total = nc + (kPat ? KP / KC : 0);

  // chunk i into stage st: a trunk chunk (halo [cell][KC], kph [tap][KC][BN])
  // or a patch chunk (patch rows [row][PAT_ROW], wm[b] [KC][BN])
  auto load = [&](int i, int st) {
    float* sA = smem + st * STAGE_FLOATS;
    float* sB = sA + A_FLOATS;
    if (i < nc) {
      const int c0 = i * KC;
#pragma unroll 1
      for (int e = tid; e < HALO_CELLS * 2; e += THREADS) {
        const int cell = e >> 1, q = e & 1;
        const int gy = y0 + cell / HALO_W, gx = x0 + cell % HALO_W;
        const bool ok = gy < hp && gx < wp;
        cp_async16(sA + cell * KC + 4 * q, ok ? tp + ((size_t(b) * hp + gy) * wp + gx) * C + c0 + 4 * q : tp, ok);
      }
#pragma unroll 1
      for (int e = tid; e < 9 * KC * (BN / 4); e += THREADS) {
        const int row = e / (BN / 4), n4 = e % (BN / 4);  // row = tap * KC + k
        const int tap = row / KC, k = row % KC;
        cp_async16(sB + row * BN + 4 * n4, kph + (size_t(tap) * C + c0 + k) * N + n0 + 4 * n4, true);
      }
    } else if constexpr (kPat) {
      const int p0 = (i - nc) * KC;
#pragma unroll 1
      for (int e = tid; e < BM * 2; e += THREADS) {
        const int cell = e >> 1, q = e & 1;
        const int ty = cell / TW, tx = cell % TW, gy = y0 + ty, gx = x0 + tx;
        const bool ok = gy < h && gx < w;
        cp_async16(sA + ty * PAT_ROW + tx * KC + 4 * q,
                   ok ? pat + ((size_t(b) * h + gy) * w + gx) * KP + p0 + 4 * q : pat, ok);
      }
#pragma unroll 1
      for (int e = tid; e < KC * (BN / 4); e += THREADS) {
        const int k = e / (BN / 4), n4 = e % (BN / 4);
        cp_async16(sB + k * BN + 4 * n4, wm + (size_t(b) * KP + p0 + k) * N + n0 + 4 * n4, true);
      }
    }
    cp_async_commit();
  };

  const int tc = tid >> 4, tn = tid & 15;
  const int r = tc & 7, cb = (tc >> 3) * 8;  // tile row, first tile column of this thread's 8 cells
  float acc[8][8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[j][i] = 0.f;

  auto fma8 = [&](const float (&a)[8], const float* bp) {
    const float4 b0 = *reinterpret_cast<const float4*>(bp + 4 * tn);
    const float4 b1 = *reinterpret_cast<const float4*>(bp + 64 + 4 * tn);
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[j][i] = fmaf(a[j], bv[i], acc[j][i]);
  };

  load(0, 0);
  for (int i = 0; i < total; ++i) {
    if (i + 1 < total) {
      load(i + 1, (i + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk i has landed for every thread
    const float* sA = smem + (i & 1) * STAGE_FLOATS;
    const float* sB = sA + A_FLOATS;
    if (i < nc) {
#pragma unroll 1
      for (int k = 0; k < KC; ++k)
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          float a[10];
#pragma unroll
          for (int j = 0; j < 10; ++j) a[j] = sA[((r + dy) * HALO_W + cb + j) * KC + k];
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            float as[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) as[j] = a[j + dx];
            fma8(as, sB + ((dy * 3 + dx) * KC + k) * BN);
          }
        }
    } else {
#pragma unroll 1
      for (int k = 0; k < KC; ++k) {
        float a[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) a[j] = sA[r * PAT_ROW + (cb + j) * KC + k];
        fma8(a, sB + k * BN);
      }
    }
    __syncthreads();  // every thread is done with stage i & 1 before chunk i + 2 overwrites it
  }

  // epilogue: z = acc + bias (+ Z), and this thread's sums of z, z^2 over its valid cells
  const int y = y0 + r;
  const float* bias = bias_all + size_t(b) * bias_bstride + n0;
  float bv[8];
  {
    const float4 b0 = *reinterpret_cast<const float4*>(bias + 4 * tn);
    const float4 b1 = *reinterpret_cast<const float4*>(bias + 64 + 4 * tn);
    bv[0] = b0.x, bv[1] = b0.y, bv[2] = b0.z, bv[3] = b0.w;
    bv[4] = b1.x, bv[5] = b1.y, bv[6] = b1.z, bv[7] = b1.w;
  }
  float sum[8] = {}, sq[8] = {};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int x = x0 + cb + j;
    if (y >= h || x >= w) continue;
    const size_t cell = (size_t(b) * h + y) * w + x;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = n0 + 64 * half + 4 * tn;  // 4 channels of one phase: Cout % 8 == 0
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = acc[j][4 * half + i] + bv[4 * half + i];
      if constexpr (kHasImg) {
        const float* src;
        if constexpr (MODE == kImgFull) {
          const int ph = n / cout, cc = n % cout;
          const size_t fy = 4 * size_t(y) + ph / 4, fx = 4 * size_t(x) + ph % 4;
          src = img + ((size_t(b) * 4 * h + fy) * (4 * size_t(w)) + fx) * cout + cc;
        } else {
          src = img + cell * N + n;
        }
        const float4 zi = __ldg(reinterpret_cast<const float4*>(src));
        v[0] += zi.x, v[1] += zi.y, v[2] += zi.z, v[3] += zi.w;
      }
      __stcs(reinterpret_cast<float4*>(z + cell * N + n), make_float4(v[0], v[1], v[2], v[3]));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sum[4 * half + i] += v[i];
        sq[4 * half + i] += v[i] * v[i];
      }
    }
  }
  // column sums over the 16 cell groups, in a fixed order, through the
  // stages' memory (free since the last barrier of the loop)
  float* red_s = smem;            // [16][BN]
  float* red_q = smem + 16 * BN;  // [16][BN]
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int o = tc * BN + 64 * half + 4 * tn;
    *reinterpret_cast<float4*>(red_s + o) = make_float4(sum[4 * half], sum[4 * half + 1], sum[4 * half + 2],
                                                        sum[4 * half + 3]);
    *reinterpret_cast<float4*>(red_q + o) = make_float4(sq[4 * half], sq[4 * half + 1], sq[4 * half + 2],
                                                        sq[4 * half + 3]);
  }
  __syncthreads();
  const int ch = tid % BN;
  const float* src = tid < BN ? red_s : red_q;
  float t = 0.f;
#pragma unroll
  for (int g = 0; g < 16; ++g) t += src[g * BN + ch];
  (tid < BN ? psum : psq)[(size_t(b) * T + tile) * N + n0 + ch] = t;
}

int check_common(int B, int h, int w, int C, int N, int th, int tw) {
  if (th != TH || tw != TW) return kBadTile;
  if (C < KC || C % KC || N % BN || B < 1 || B > 65535 || h < 1 || w < 1) return kBadShape;
  const long T = long((h + TH - 1) / TH) * ((w + TW - 1) / TW);
  if (T > 65535) return kBadShape;
  return 0;
}

template <typename Kernel>
int allow_smem(Kernel kernel) {
  return int(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_BYTES)));
}

}  // namespace

extern "C" {

// tp [B, h+2, w+2, C], kph [9, C, N], pat [B, h, w, KP], wm [B, KP, N],
// b2b [B, N], all f32; z [B, h, w, N] f32; psum, psq [B, T, N]. Returns 0, a
// cudaError_t value, or a negative error code of posfeat_error_string.
int posfeat_conv_phase_f32(const void* tp, const void* kph, const void* pat, const void* wm,
                           const void* b2b, void* z, void* psum, void* psq, int B, int h, int w,
                           int C, int KP, int N, int th, int tw, void* stream) {
  if (int rc = check_common(B, h, w, C, N, th, tw)) return rc;
  if (KP < 0 || KP % KC) return kBadShape;
  if (int rc = allow_smem(conv_f32_kernel<kPatches>)) return rc;
  const dim3 grid(N / BN, ((h + TH - 1) / TH) * ((w + TW - 1) / TW), B);
  conv_f32_kernel<kPatches><<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tp), static_cast<const float*>(kph), static_cast<const float*>(pat),
      static_cast<const float*>(wm), nullptr, static_cast<const float*>(b2b), N, static_cast<float*>(z),
      static_cast<float*>(psum), static_cast<float*>(psq), h, w, C, KP, N, 0);
  return int(cudaGetLastError());
}

// tp [B, h+2, w+2, C], kph [9, C, N], img as in posfeat_conv_phase_img
// (layout 0 = full-res z_img [B, 4h, 4w, cout] (K3), 1 = none (T1), 2 =
// z_img in phase layout [B, h, w, N] (T2)), b2 [N], all f32.
int posfeat_conv_phase_img_f32(const void* tp, const void* kph, const void* img, const void* b2,
                               void* z, void* psum, void* psq, int B, int h, int w, int C, int N,
                               int cout, int layout, int th, int tw, void* stream) {
  if (int rc = check_common(B, h, w, C, N, th, tw)) return rc;
  if (cout % 8 || N != 16 * cout || layout < 0 || layout > 2) return kBadShape;
  using Kernel = void (*)(const float*, const float*, const float*, const float*, const float*, const float*,
                          int, float*, float*, float*, int, int, int, int, int, int);
  const Kernel kernels[3] = {conv_f32_kernel<kImgFull>, conv_f32_kernel<kImgNone>, conv_f32_kernel<kImgPhase>};
  const Kernel kernel = kernels[layout];
  if (int rc = allow_smem(kernel)) return rc;
  const dim3 grid(N / BN, ((h + TH - 1) / TH) * ((w + TW - 1) / TW), B);
  kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tp), static_cast<const float*>(kph), nullptr, nullptr,
      static_cast<const float*>(img), static_cast<const float*>(b2), 0, static_cast<float*>(z),
      static_cast<float*>(psum), static_cast<float*>(psq), h, w, C, 0, N, cout);
  return int(cudaGetLastError());
}

}  // extern "C"
