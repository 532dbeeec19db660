// Fused KeypointDet head kernels for Hopper (sm_90a), plain C interface.
//
// K1 posfeat_conv_phase replaces posfeat_tpu/ops/pallas/fused_head.py:148
// (_conv_kernel_v3). K2 posfeat_head_tail replaces fused_head.py:284
// (_tail_kernel). posfeat_conv_phase_img carries three more TPU kernels,
// one per treatment of the image term: K3 (fused_head.py:70 _conv_kernel,
// the v1 dataflow), T1 (tools/bench_fused_parts.py:105 _conv_kernel_noz)
// and T2 (bench_fused_parts.py:154 _conv_kernel_prephase). The conv
// kernels here are the bf16 instances; fused_head_f32.cu holds the f32
// ones. K2 has instances for bf16 and f32 z. The Python wrappers
// (posfeat_tpu_torch/ops/fused_head.py) check devices, dtypes, shapes and
// contiguity, allocate every output, pass PyTorch's current stream, and
// raise on a non-zero return code.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c
//        -Xcompiler -fPIC for each of fused_head.cu, fused_head_f32.cu and
//        reinforce.cu, then nvcc -shared of the three objects
// (posfeat_tpu_torch/ops/_build.py does this on first use). No link flag
// beyond these: <cuda.h> is read for the tensor-map types only, and
// cuTensorMapEncodeTiled (libcuda) is looked up at run time with
// cudaGetDriverEntryPointByVersion.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

using bf16 = __nv_bfloat16;

namespace {

// ------------------------------------------------------------- K1, K3, T1, T2
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
// Design (one block = one TH x TW = 8 x 16 tile of trunk cells, BM = 128
// GEMM rows, swept over all N in steps of BN = 256 channels):
// - The tile's halo (10 x 18 cells, the edge-padded trunk, so no boundary
//   tests in the MMA loop) and, for K1, its patch rows stay resident in
//   shared memory for the whole sweep, staged once by cp.async, in core
//   matrices: [C / 8][cells][8], so that any 8 consecutive cells of a halo
//   row are one 128-byte core matrix. Each staging thread fences its
//   cp.async writes to the async proxy (fence.proxy.async) before the
//   barrier after which wgmma reads them. Where halo and patch tile do not
//   fit beside the ring (K1 at C >= 224 with KP = 192, K3/T1/T2 at
//   C >= 256), they are cut into slices of channels that take turns in one
//   buffer, staged again for every N step (APlan): any C % 32 == 0 runs,
//   the wider ones at a cost in staging that the flagship C = 192 avoids.
// - The B operand (kph, and wm[b] for K1's image half) is streamed in
//   KC = 64-deep chunks of BN channels through a ring of 3 (K1) or 4
//   (K3/T1/T2) shared-memory stages, 32 KB each, by TMA with the 128-byte
//   swizzle, with full/empty mbarriers. The wrapper hands the kernel B
//   K-major ([9, N, C] and [B, N, KP]), the layout wgmma reads without a
//   transpose.
// - Warp specialisation: warpgroup 0 is the producer (one thread issues the
//   TMA loads; the warpgroup gives its registers back with setmaxnreg, 24
//   each, so that the consumers get 240); warpgroups 1 and 2 are the
//   consumers. Consumer warpgroup xh owns tile columns 8 xh .. 8 xh + 7 of
//   all 8 tile rows (64 GEMM rows) x 256 channels: 128 f32 accumulators per
//   thread.
// - MMAs are wgmma.m64n256k16 with both operands in shared memory. The A
//   descriptor's 8-row groups are the warpgroup's 8 tile rows, 18 cells
//   apart in the halo, so a 3x3 tap is only a different start address:
//   no im2col, no copies, no registers for A. One chunk stays queued
//   behind the one that runs; a stage is released as soon as its wgmmas
//   retire.
// - A chunk deeper than C (or KP, or its slice) is cut to its 16-deep
//   steps that exist: C % 32 == 0 is enough, and TMA zero-fills B beyond
//   C, N or KP.
// - Epilogue from the accumulator registers, at the end of each N step: a
//   4 x 4 transpose inside each quad of lanes gives each lane 8 contiguous
//   channels of one cell, so bias, image term and z move as 16-byte
//   accesses; z is stored with a streaming hint, the bias comes from shared
//   memory (copied during the step's MMAs) and the image term is read one
//   group of 32 channels ahead. The column sums of z and z^2 over the
//   tile's valid cells come from the f32 values, summed over each warp's
//   16 rows by a shuffle reduce-scatter, then across the 8 consumer warps
//   through shared memory in a fixed order (warpgroup 1's warps, then
//   warpgroup 2's). Each tile writes its own partials row: no atomics, so
//   the moments are deterministic.
// B traffic per launch at the flagship point: 16 * 150 tiles * 8 N steps
// * 30 chunks * 32 KB = 18.9 GB from L2 (it is 7 MB + 12.6 MB in memory);
// BM = 128 keeps that within what L2 delivers beside the MMAs. The
// epilogue does not overlap the MMAs: it costs a tenth (K1, T1) to a
// quarter (K3, T2) of a launch (tools/profile_torch_conv_stages.py).
//
// K3, T1 and T2 share the trunk half and differ in the epilogue, where an
// image term Z is added to the accumulator with the bias, before the
// moments (no patch tile, no image-half MMA):
//   K3 (kImgFull)  Z = z_img[b, 4y + ry, 4x + rx, c], full-res [B,4h,4w,Cout]
//                  (the phase reorder the TPU kernel did in VMEM,
//                  fused_head.py:137-140);
//   T1 (kImgNone)  Z = 0;
//   T2 (kImgPhase) Z = z_img_ph[b, y, x, n], already in phase layout.
// Channel n = (ry*4 + rx)*Cout + c. Bound: the same tensor work as K1's
// trunk half, 2.17 TFLOP per B=16 launch at the flagship point, against
// about 2.65 GB of traffic in K3 (z written, z_img read once): the tensor
// cores bound it.

constexpr int TH = 8;
constexpr int TW = 16;
constexpr int BM = TH * TW;  // 128
constexpr int BN = 256;
constexpr int KC = 64;  // one 128-byte swizzle row of bf16
constexpr int HALO_CELLS = (TH + 2) * (TW + 2);
constexpr int STAGE_BYTES = BN * KC * 2;
constexpr int K1_THREADS = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int CONSUMER_WARPS = 8;
constexpr int RED_BYTES = 4 * BN * 8;  // one warpgroup's column partials, float2 (s, q)
constexpr int MAX_SMEM = 232448;       // per block on sm_90
// registers per thread: the launch gives 168 to each of 384 threads; the
// producer warpgroup drops to 24 so that each consumer can rise to 240
constexpr int LAUNCH_REGS = 168, PRODUCER_REGS = 24, CONSUMER_REGS = 240;

// the image term of the conv's epilogue (see above)
enum ImageTerm { kPatches = 0, kImgFull = 1, kImgNone = 2, kImgPhase = 3 };

__host__ __device__ constexpr int ring_stages(int mode) { return mode == kPatches ? 3 : 4; }

// Shared memory other than the A operand: 1024 for aligning the ring to
// the swizzle's period, the ring, the reduction buffer, the step's bias,
// 2 mbarriers per stage. The A operand (halo, patch tile) gets the rest.
__host__ __device__ constexpr int fixed_smem(int mode) {
  return 1024 + ring_stages(mode) * STAGE_BYTES + RED_BYTES + BN * 4 + 16 * ring_stages(mode);
}

// Where the A operand lives. Its slices, in the order the MMAs take them
// within each N step: the halo in slices of cs channels (segments
// 0 .. nh-1), then the patch tile in slices of ps channels. When the halo
// and the patch tile fit beside each other (C + KP up to about 400 at
// KP = 192), each is one slice, staged once for the whole sweep
// (resident). Otherwise the slices, cs and ps a multiple of KC, take
// turns in one buffer and are staged again for every N step.
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }

struct APlan {
  int cs, ps, nh, nseg;
  bool resident;
  __host__ __device__ APlan(int C, int KP, int mode) {
    const int room = MAX_SMEM - fixed_smem(mode);
    resident = HALO_CELLS * C * 2 + BM * KP * 2 <= room;
    cs = resident ? C : imin(C, room / (HALO_CELLS * 2) / KC * KC);
    ps = resident ? KP : imin(KP, room / (BM * 2) / KC * KC);
    nh = (C + cs - 1) / cs;
    nseg = nh + (KP > 0 ? (KP + ps - 1) / ps : 0);
  }
  __host__ __device__ int base(int seg) const { return seg < nh ? seg * cs : (seg - nh) * ps; }
  __host__ __device__ int width(int seg, int C, int KP) const {
    return seg < nh ? imin(cs, C - base(seg)) : imin(ps, KP - base(seg));
  }
  // elements from the buffer's start: the resident patch tile follows the halo
  __host__ __device__ int offset(int seg) const { return resident && seg >= nh ? HALO_CELLS * cs : 0; }
  __host__ __device__ int bytes() const {
    const int halo = HALO_CELLS * cs * 2, ptile = BM * ps * 2;
    return resident ? halo + ptile : (halo > ptile ? halo : ptile);
  }
};

size_t conv_smem_bytes(int C, int KP, int mode) {
  return size_t(fixed_smem(mode)) + APlan(C, KP, mode).bytes();
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// 4 bytes global -> shared
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(src) : "memory");
}

// 16 bytes global -> shared; zeros when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// a[i] of lane t -> a[t] of lane i, inside each quad of lanes (t = lane % 4):
// two xor steps, each swapping the off-diagonal halves of 2 x 2 blocks
__device__ __forceinline__ void quad_transpose(uint32_t (&a)[4], int t) {
#pragma unroll
  for (int m = 2; m >= 1; m /= 2) {
    const bool hi = t & m;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i & m) continue;
      const uint32_t recv = __shfl_xor_sync(0xffffffffu, hi ? a[i] : a[i | m], m);
      if (hi) {
        a[i] = recv;
      } else {
        a[i | m] = recv;
      }
    }
  }
}

// one step of a reduce-scatter across the lanes that differ in bit M: the
// lane with the bit set keeps the sums of d[HALF .. 2 HALF), the other those
// of d[0 .. HALF), both in d[0 .. HALF)
template <int M, int HALF>
__device__ __forceinline__ void reduce_scatter_step(float (&d)[128], int lane) {
  const bool hi = lane & M;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float recv = __shfl_xor_sync(0xffffffffu, hi ? d[i] : d[i + HALF], M);
    d[i] = (hi ? d[i + HALF] : d[i]) + recv;
  }
}

// shared-memory descriptor of a K-major operand tile in the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

// d[64 x 256] (+)= A[64 x 16] * B[16 x 256], both bf16 in shared memory, K-major
__device__ __forceinline__ void wgmma_m64n256k16_ss(float (&d)[128], uint64_t desc_a,
                                                    uint64_t desc_b, uint32_t scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "
      "%87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// One block: a TH x TW tile of trunk cells of image b against all N output
// channels, in steps of BN. kmap is the TMA map of kph as [9][N][C]; wmap
// (kPatches only) of wm as [B][N][KP]; pat feeds the patch tile (kPatches
// only); img is the image term's tensor (kImgFull, kImgPhase); bias is
// [B][N] with bias_bstride N, or one [N] row with bias_bstride 0; cout is
// the full-res channel count.
template <int MODE>
__device__ __forceinline__ void conv_phase_body(
    const CUtensorMap& kmap, const CUtensorMap& wmap, const bf16* __restrict__ tp,
    const bf16* __restrict__ pat, const bf16* __restrict__ img, const float* __restrict__ bias_all,
    int bias_bstride, bf16* __restrict__ z, float* __restrict__ psum, float* __restrict__ psq,
    int h, int w, int C, int KP, int N, int cout) {
  constexpr int S = ring_stages(MODE);
  constexpr bool kPat = MODE == kPatches;
  constexpr bool kHasImg = MODE == kImgFull || MODE == kImgPhase;
  const APlan plan(C, KP, MODE);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // the A operand's slices in core matrices: a halo slice [cs/8][HALO_CELLS][8],
  // so that any 8 consecutive cells of a halo row form one 128-byte core
  // matrix; a patch slice (K1 only) [ps/8][BM][8]
  bf16* abuf = reinterpret_cast<bf16*>(ring + S * STAGE_BYTES);
  float2* red = reinterpret_cast<float2*>(ring + S * STAGE_BYTES + plan.bytes());  // [4][BN]
  const uint32_t ring_u = smem_u32(ring);
  float* sbias = reinterpret_cast<float*>(red + 4 * BN);  // [BN] this step's bias
  const uint32_t full_u = smem_u32(sbias + BN);  // S full barriers, then S empty ones
  const uint32_t empty_u = full_u + 8 * S;

  const int tid = threadIdx.x;
  const int ntx = (w + TW - 1) / TW;
  const int T = ntx * ((h + TH - 1) / TH);
  const int b = blockIdx.x / T;
  const int tile = blockIdx.x % T;
  const int y0 = (tile / ntx) * TH;
  const int x0 = (tile % ntx) * TW;
  // per N step: 9 taps of every halo slice, then the patch slices, in
  // chunks of KC channels (cs and ps are C and KP or multiples of KC)
  const int nchunks = 9 * ((C + KC - 1) / KC) + (kPat ? (KP + KC - 1) / KC : 0);
  const int nsteps = (N + BN - 1) / BN;

  // the producer's position: ring stage and phase, and the next chunk's
  // slice, tap, K offset within the slice and N step
  int p_stage = 0, p_phase = 0, p_seg = 0, p_tap = 0, p_k0 = 0, p_n0 = 0;
  auto produce_next = [&]() {
    const uint32_t bar = full_u + 8 * p_stage, dst = ring_u + p_stage * STAGE_BYTES;
    const bool halo = p_seg < plan.nh;
    mbar_expect_tx(bar, STAGE_BYTES);
    if (halo) {
      tma_load_3d(dst, &kmap, plan.base(p_seg) + p_k0, p_n0, p_tap, bar);
    } else if constexpr (kPat) {
      tma_load_3d(dst, &wmap, plan.base(p_seg) + p_k0, p_n0, b, bar);
    }
    if (++p_stage == S) {
      p_stage = 0;
      p_phase ^= 1;
    }
    p_k0 += KC;
    if (p_k0 >= plan.width(p_seg, C, KP)) {
      p_k0 = 0;
      if (halo && p_tap < 8) {
        ++p_tap;
      } else {
        p_tap = 0;
        if (++p_seg == plan.nseg) {
          p_seg = 0;
          p_n0 += BN;
        }
      }
    }
  };

  // stage slice seg of the A operand with threads t0, t0 + nt, ...: a halo
  // slice (rows y0..y0+TH+1, columns x0..x0+TW+1 of tp) or a slice of the
  // tile's patch rows; zeros outside the image
  const int hp = h + 2, wp = w + 2;
  auto stage_a = [&](int seg, int t0, int nt) {
    const int base = plan.base(seg), W8 = plan.width(seg, C, KP) / 8;
    bf16* dst = abuf + plan.offset(seg);
    if (seg < plan.nh) {
      for (int i = t0; i < HALO_CELLS * W8; i += nt) {
        const int cell = i / W8, c8 = i % W8;
        const int gy = y0 + cell / (TW + 2), gx = x0 + cell % (TW + 2);
        const bool ok = gy < hp && gx < wp;
        cp_async16(smem_u32(dst + (c8 * HALO_CELLS + cell) * 8),
                   ok ? tp + ((size_t(b) * hp + gy) * wp + gx) * C + base + c8 * 8 : tp, ok);
      }
    } else if constexpr (kPat) {
      for (int i = t0; i < BM * W8; i += nt) {
        const int cell = i / W8, k8 = i % W8;
        const int gy = y0 + cell / TW, gx = x0 + cell % TW;
        const bool ok = gy < h && gx < w;
        cp_async16(smem_u32(dst + (k8 * BM + cell) * 8),
                   ok ? pat + ((size_t(b) * h + gy) * w + gx) * KP + base + k8 * 8 : pat, ok);
      }
    }
  };
  // the staging threads' cp.async writes (generic proxy) become visible to
  // wgmma's reads (async proxy) once each thread fences and all meet at the
  // barrier that follows
  auto staged = []() {
    asm volatile("cp.async.wait_all;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  };

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full_u + 8 * s, 1);
      mbar_init(empty_u + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int total = nsteps * nchunks;
  if (tid == 0) {
    for (int i = 0; i < S && i < total; ++i) produce_next();  // the ring starts empty
  }

  // every slice when they are resident, else the first, by all threads
  for (int seg = 0; seg < (plan.resident ? plan.nseg : 1); ++seg) stage_a(seg, tid, K1_THREADS);
  staged();
  __syncthreads();

  if (tid < 128) {
    // producer warpgroup: one thread keeps the ring full
    setmaxnreg_dec<PRODUCER_REGS>();
    if (tid == 0) {
      for (int i = S; i < total; ++i) {
        mbar_wait(empty_u + 8 * p_stage, p_phase ^ 1);  // its previous load was consumed
        produce_next();
      }
    }
    return;
  }

  // consumer warpgroups
  setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = tid / 32 - 4;  // consumer warp 0..7
  const int lane = tid % 32;
  const int ct = tid - 128;  // consumer thread 0..255: column n0 + ct in the reduction
  // consumer warpgroup xh takes tile columns 8 xh .. 8 xh + 7 of all 8 tile
  // rows: its 64 GEMM rows are 8 core-matrix groups of 8 consecutive cells,
  // one per tile row, (TW + 2) cells apart in the halo at any tap
  const int xh = cw / 4;
  const uint32_t abuf_xh = smem_u32(abuf + 8 * xh * 8);

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  int it = 0;             // chunks consumed so far: the ring position
  bool pending = false;   // the last chunk's stage is not yet released

  // one chunk: A from descriptor da, a_step between its 16-deep steps, of
  // which ksteps exist; zero starts the accumulators afresh
  auto chunk = [&](uint64_t da, uint64_t a_step, int ksteps, bool zero) {
    const int s = it % S;
    mbar_wait(full_u + 8 * s, (it / S) & 1);
    wgmma_fence();
    const uint64_t db = desc_sw128(ring_u + s * STAGE_BYTES);
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk)
      if (kk < ksteps) wgmma_m64n256k16_ss(acc, da + a_step * kk, db + 2 * kk, !(zero && kk == 0));
    wgmma_commit();
    wgmma_wait<1>();  // the previous chunk's wgmmas have retired: free its stage
    if (pending && lane == 0) mbar_arrive(empty_u + 8 * ((it + S - 1) % S));
    pending = true;
    ++it;
  };
  // every wgmma retired, every stage released
  auto drain = [&]() {
    wgmma_wait<0>();
    if (pending && lane == 0) mbar_arrive(empty_u + 8 * ((it + S - 1) % S));
    pending = false;
  };
  // the MMAs of one N step, slice by slice
  auto mma_step = [&](int step) {
    bool zero = true;
    for (int seg = 0; seg < plan.nseg; ++seg) {
      if (!plan.resident && (step > 0 || seg > 0)) {
        // the slices take turns in one buffer: wait until no consumer reads it
        drain();
        named_bar_sync(1, 256);
        stage_a(seg, ct, 256);
        staged();
        named_bar_sync(1, 256);
      }
      const int width = plan.width(seg, C, KP);
      const uint32_t a_u = abuf_xh + plan.offset(seg) * 2;
      if (seg < plan.nh) {
        for (int tap = 0; tap < 9; ++tap)
          for (int k0 = 0; k0 < width; k0 += KC, zero = false)
            chunk(desc_interleave(a_u + ((k0 / 8) * HALO_CELLS + (tap / 3) * (TW + 2) + tap % 3) * 16,
                                  HALO_CELLS * 16, (TW + 2) * 16),
                  HALO_CELLS * 2, min(KC, width - k0) / 16, zero);
      } else {
        for (int k0 = 0; k0 < width; k0 += KC, zero = false)
          chunk(desc_interleave(a_u + (k0 / 8) * BM * 16, BM * 16, TW * 16), BM * 2,
                min(KC, width - k0) / 16, zero);
      }
    }
  };

  const int g = lane / 4, t = lane % 4;
  // accumulator rows g and g + 8 of this warp = tile rows 2 (cw % 4) and
  // 2 (cw % 4) + 1, both at tile column 8 xh + g
  const int y = y0 + 2 * (cw % 4), x = x0 + 8 * xh + g;
  const bool ok_row[2] = {y < h && x < w, y + 1 < h && x < w};
  const size_t cell0 = (size_t(b) * h + y) * w + x;
  const float* bias = bias_all + size_t(b) * bias_bstride;
  // the image term of channels n, n+1 at accumulator row rr (K3, T2)
  auto img_src = [&](int rr, int n) -> const bf16* {
    if constexpr (MODE == kImgFull) {
      // channels n, n+1 share a phase: Cout is a multiple of 8
      const int ph = n / cout, cc = n % cout;
      const size_t fy = 4 * size_t(y + rr) + ph / 4, fx = 4 * size_t(x) + ph % 4;
      return img + ((size_t(b) * 4 * h + fy) * (4 * size_t(w)) + fx) * cout + cc;
    } else {
      return img + (cell0 + size_t(rr) * w) * N + n;
    }
  };

  for (int step = 0; step < nsteps; ++step) {
    const int n0 = step * BN;
    if constexpr (kHasImg) {
      // pull this step's image term into L2 while the MMAs run, one
      // prefetch per 128-byte line of 64 channels, so that the epilogue's
      // reads do not wait on device memory
#pragma unroll
      for (int j = 0; j < BN / 8; j += 8)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
          if (ok_row[rr] && n0 + 8 * j < N)
            asm volatile("prefetch.global.L2 [%0];" ::"l"(img_src(rr, n0 + 8 * j + 2 * t)));
    }
    // this step's bias into shared memory, for the epilogue
    if (n0 + ct < N) cp_async4(smem_u32(sbias + ct), bias + n0 + ct);
    mma_step(step);
    drain();
    asm volatile("cp.async.wait_all;" ::: "memory");
    named_bar_sync(1, 256);  // every consumer's bias element has landed
    fence_acc(acc);

    // epilogue begin (tools/profile_torch_conv_stages.py cuts the kernel here)
    // The accumulator layout gives lane (g, t) channels 8j + 2t, 8j + 2t + 1
    // of rows g and g + 8. Per group of 32 channels (jq): a 4 x 4 transpose
    // inside each quad of lanes gives each lane 8 contiguous channels of one
    // row; z = acc + bias (+ Z) leaves as bf16, and this lane's sums of z,
    // z^2 over its two rows go to acc[16 jq .. 16 jq + 15]. The image term
    // is read one group ahead, so that its latency overlaps a group's work.
    uint4 zi[2];  // the image term of this lane's 8 channels in rows g, g + 8, one group ahead
    if constexpr (kHasImg) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        if (ok_row[rr]) zi[rr] = *reinterpret_cast<const uint4*>(img_src(rr, n0 + 8 * t));
    }
#pragma unroll
    for (int jq = 0; jq < BN / 32; ++jq) {
      const int n = n0 + 8 * (4 * jq + t);  // this lane's 8 channels
      uint32_t e[2][2][4];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          e[rr][0][i] = __float_as_uint(acc[4 * (4 * jq + i) + 2 * rr]);
          e[rr][1][i] = __float_as_uint(acc[4 * (4 * jq + i) + 2 * rr + 1]);
        }
      float sum[8] = {}, sq[8] = {};
      if (n0 + 32 * jq < N) {
        const float4 b0 = *reinterpret_cast<const float4*>(sbias + n - n0);
        const float4 b1 = *reinterpret_cast<const float4*>(sbias + n - n0 + 4);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          quad_transpose(e[rr][0], t);
          quad_transpose(e[rr][1], t);
          if (!ok_row[rr]) continue;
          float v[8];
#pragma unroll
          for (int k = 0; k < 8; ++k) v[k] = __uint_as_float(e[rr][k % 2][k / 2]) + bv[k];
          if constexpr (kHasImg) {
            const uint4 raw = zi[rr];
            const __nv_bfloat162* zi = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const float2 f = __bfloat1622float2(zi[k]);
              v[2 * k] += f.x;
              v[2 * k + 1] += f.y;
            }
          }
          uint4 out;
          __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
          for (int k = 0; k < 4; ++k) o2[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
          __stcs(reinterpret_cast<uint4*>(z + (cell0 + size_t(rr) * w) * N + n), out);  // streamed
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            sum[k] += v[k];
            sq[k] += v[k] * v[k];
          }
        }
      }
      if constexpr (kHasImg) {
        if (jq + 1 < BN / 32 && n0 + 32 * (jq + 1) < N) {
#pragma unroll
          for (int rr = 0; rr < 2; ++rr)
            if (ok_row[rr]) zi[rr] = *reinterpret_cast<const uint4*>(img_src(rr, n + 32));
        }
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        acc[16 * jq + k] = sum[k];
        acc[16 * jq + 8 + k] = sq[k];
      }
    }
    // sum over the warp's 16 rows as a reduce-scatter: lane (g, t) ends with
    // group jq = g, channels 8 (4g + t) .. + 7, sums then squares, in acc[0 .. 15]
    reduce_scatter_step<16, 64>(acc, lane);
    reduce_scatter_step<8, 32>(acc, lane);
    reduce_scatter_step<4, 16>(acc, lane);

    // across the 8 consumer warps, in a fixed order: warpgroup 1's four
    // warps through red, then warpgroup 2's
    float ts = 0.f, tq = 0.f;
#pragma unroll
    for (int round = 0; round < 2; ++round) {
      if (cw / 4 == round) {
        float4* dst = reinterpret_cast<float4*>(red + (cw % 4) * BN + 8 * (4 * g + t));
#pragma unroll
        for (int k = 0; k < 4; ++k)
          dst[k] = make_float4(acc[2 * k], acc[8 + 2 * k], acc[2 * k + 1], acc[8 + 2 * k + 1]);
      }
      named_bar_sync(1, 256);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 p = red[k * BN + ct];
        ts += p.x;
        tq += p.y;
      }
      named_bar_sync(1, 256);
    }
    if (n0 + ct < N) {
      const size_t o = (size_t(b) * T + tile) * N + n0 + ct;
      psum[o] = ts;
      psq[o] = tq;
    }
    // epilogue end
  }
}

__global__ void __launch_bounds__(K1_THREADS, 1)
conv_phase_kernel(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap wmap,
                  const bf16* __restrict__ tp, const bf16* __restrict__ pat,
                  const float* __restrict__ b2b, bf16* __restrict__ z,
                  float* __restrict__ psum, float* __restrict__ psq, int h, int w, int C,
                  int KP, int N) {
  conv_phase_body<kPatches>(kmap, wmap, tp, pat, nullptr, b2b, N, z, psum, psq, h, w, C, KP, N, 0);
}

// K3, T1, T2: one kernel name each, so that profiles and -Xptxas -v tell them apart
#define CONV_PHASE_IMG_KERNEL(NAME, MODE)                                                      \
  __global__ void __launch_bounds__(K1_THREADS, 1)                                             \
  NAME(const __grid_constant__ CUtensorMap kmap, const bf16* __restrict__ tp,                  \
       const bf16* __restrict__ img, const float* __restrict__ b2, bf16* __restrict__ z,      \
       float* __restrict__ psum, float* __restrict__ psq, int h, int w, int C, int N,         \
       int cout) {                                                                            \
    conv_phase_body<MODE>(kmap, kmap, tp, nullptr, img, b2, 0, z, psum, psq, h, w, C, 0, N,   \
                          cout);                                                              \
  }
CONV_PHASE_IMG_KERNEL(conv_phase_img_full_kernel, kImgFull)
CONV_PHASE_IMG_KERNEL(conv_phase_img_none_kernel, kImgNone)
CONV_PHASE_IMG_KERNEL(conv_phase_img_phase_kernel, kImgPhase)
#undef CONV_PHASE_IMG_KERNEL

// ------------------------------------------------------------------- K2
//
// For each phase row r of image b (R = h*w*16 rows of Cout channels):
//   x = PReLU((z[b, r, :] - mu[b]) * sc[b]);  u[b, r, o] = x . w3[:, o] + b3[o]
// plus per-block sums of u and u^2 per output channel; z is bf16 or f32
// (the head's compute dtype), the arithmetic f32 in both.
//
// What bounds it: it reads z once (78.6 MB per image at the flagship point
// in bf16, 157 MB in f32: 1.26 or 2.52 GB per B=16 launch) and writes u
// (1.2 MB per image for one output channel), a few FLOP per byte: device
// memory bandwidth bounds it (0.38 or 0.75 ms per B=16 launch at 3.35 TB/s).
//
// Design: one instance per (z dtype, LPR = Cout/8, OUT = out_ch), chosen by
// a table in posfeat_head_tail, so that every loop and shuffle count is a
// constant.
// - A row is read by LPR lanes, each with 16-byte loads of 8 channels (one
//   load of 8 bf16, or two of 4 f32: channels 4 li .. 4 li + 3 and
//   4 (LPR + li) .. + 3, so that each load of a row group is contiguous),
//   so a warp reads G = 32/LPR rows per load instruction, coalesced. Rows
//   of one instruction are consecutive (row = base + (i * G) + lane group).
// - Each lane issues all its loads of a trip (at least 4, 8 at the flagship
//   point) before any arithmetic, with a streaming hint that keeps z out of
//   L1 (z is read once and overflows L2), so enough bytes are in flight to
//   cover the memory latency.
// - The P x OUT partial dot products a lane holds for P rows of its group
//   are finished by a reduce-scatter over the group (P - 1 shuffles per
//   output for P rows; then log2(LPR / P) plain xor steps), after which
//   lane li < P owns row li of its P: the group stores P consecutive u
//   values, and the warp 32/LPR * P of them, in one coalesced store. An
//   f32 instance takes half the rows per reduce-scatter, so that its loads
//   per trip hold as many registers as the bf16 one's.
// - Each block takes a contiguous range of one image's rows (a few blocks
//   per SM: the wrapper picks the range, K2_BLOCKS); it writes one partials
//   row, its lanes' sums reduced by shuffles and then across its warps
//   through shared memory in a fixed order, so the moments are
//   deterministic, with no atomics.

constexpr int K2_THREADS = 256;
constexpr int K2_WARPS = K2_THREADS / 32;
constexpr int MAXO = 4;

template <typename ZT, int LPR, int OUT>
struct K2Shape {
  static constexpr int VEC = 16 / int(sizeof(ZT));  // channels per 16-byte load: 8 bf16, 4 f32
  static constexpr int NLD = 8 / VEC;               // 16-byte loads per lane and row
  // rows per reduce-scatter: P x OUT partials per lane stay at most 8
  // (4 for f32), P x NLD loads at most 8
  static constexpr int PMAX0 = OUT == 1 ? 8 : (OUT == 2 ? 4 : 2);
  static constexpr int PMAX = PMAX0 / NLD > 0 ? PMAX0 / NLD : 1;
  static constexpr int P = LPR < PMAX ? LPR : PMAX;
  static constexpr int U = P >= 4 ? 1 : 4 / P;  // reduce-scatter groups per trip: >= 4 loads
  static constexpr int G = 32 / LPR;            // rows per load instruction of a warp
  static constexpr int ROWS = G * P * U;        // rows per warp trip
  // this lane's k-th channel (k < 8) of a row, lane li of its group
  static __device__ __forceinline__ int channel(int li, int k) { return VEC * (li + (k / VEC) * LPR) + k % VEC; }
};

// 16 bytes of z, read once: no L1 allocation
__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// the 8 channels of a lane's loads as f32
__device__ __forceinline__ void to_floats(const uint4 (&raw)[1], float (&f)[8]) {
  const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&raw[0]);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 t = __bfloat1622float2(v2[k]);
    f[2 * k] = t.x;
    f[2 * k + 1] = t.y;
  }
}
__device__ __forceinline__ void to_floats(const uint4 (&raw)[2], float (&f)[8]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    f[4 * j] = __uint_as_float(raw[j].x);
    f[4 * j + 1] = __uint_as_float(raw[j].y);
    f[4 * j + 2] = __uint_as_float(raw[j].z);
    f[4 * j + 3] = __uint_as_float(raw[j].w);
  }
}

// at least 2 blocks per SM: up to 128 registers a thread, which every
// instance fits without spilling
template <typename ZT, int LPR, int OUT>
__global__ void __launch_bounds__(K2_THREADS, 2)
head_tail_kernel(const void* __restrict__ zv, const float* __restrict__ mu,
                 const float* __restrict__ sc, const float* __restrict__ a,
                 const float* __restrict__ w3, const float* __restrict__ b3,
                 float* __restrict__ u, float* __restrict__ usum,
                 float* __restrict__ usq, int R, int rows_per_block) {
  using S = K2Shape<ZT, LPR, OUT>;
  constexpr int P = S::P, U = S::U, G = S::G, COUT = 8 * LPR, NLD = S::NLD, VEC = S::VEC;
  __shared__ float red[K2_WARPS][2 * OUT];
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(r0 + rows_per_block, R);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gi = lane / LPR;   // row within a load instruction
  const int li = lane % LPR;   // lane within the row's group
  const float slope = a[0];

  float m[8], s[8], wv[8][OUT];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = S::channel(li, j);
    m[j] = mu[size_t(b) * COUT + c];
    s[j] = sc[size_t(b) * COUT + c];
#pragma unroll
    for (int o = 0; o < OUT; ++o) wv[j][o] = w3[c * OUT + o];
  }
  float bias[OUT], tsum[OUT], tsq[OUT];
#pragma unroll
  for (int o = 0; o < OUT; ++o) {
    bias[o] = b3[o];
    tsum[o] = 0.f;
    tsq[o] = 0.f;
  }

  const ZT* zb = static_cast<const ZT*>(zv) + size_t(b) * R * COUT + VEC * li;
  float* ub = u + size_t(b) * R * OUT;
  for (int base = r0 + warp * S::ROWS; base < r1; base += K2_WARPS * S::ROWS) {
    uint4 raw[U][P][NLD];
#pragma unroll
    for (int q = 0; q < U; ++q)
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int r = base + (q * P + j) * G + gi;
#pragma unroll
        for (int l = 0; l < NLD; ++l)
          raw[q][j][l] = r < r1 ? ld_stream(zb + size_t(r) * COUT + l * VEC * LPR) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
    for (int q = 0; q < U; ++q) {
      float p[P][OUT];
#pragma unroll
      for (int j = 0; j < P; ++j) {
        float f[8];
        to_floats(raw[q][j], f);
#pragma unroll
        for (int o = 0; o < OUT; ++o) p[j][o] = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float x0 = (f[2 * k] - m[2 * k]) * s[2 * k];
          float x1 = (f[2 * k + 1] - m[2 * k + 1]) * s[2 * k + 1];
          x0 = x0 >= 0.f ? x0 : slope * x0;
          x1 = x1 >= 0.f ? x1 : slope * x1;
#pragma unroll
          for (int o = 0; o < OUT; ++o) p[j][o] += x0 * wv[2 * k][o] + x1 * wv[2 * k + 1][o];
        }
      }
      // reduce-scatter over the P rows: at distance d the lane keeps the
      // upper half of its rows if bit d of li is set, and sends the other
      // half to its partner; lane li ends with row li % P
#pragma unroll
      for (int d = P / 2; d >= 1; d /= 2) {
        const bool upper = li & d;
#pragma unroll
        for (int j = 0; j < d; ++j)
#pragma unroll
          for (int o = 0; o < OUT; ++o) {
            const float send = upper ? p[j][o] : p[j + d][o];
            const float keep = upper ? p[j + d][o] : p[j][o];
            p[j][o] = keep + __shfl_xor_sync(0xffffffffu, send, d);
          }
      }
      // lanes P apart in the group hold the same row: finish the sum
#pragma unroll
      for (int d = P; d < LPR; d *= 2)
#pragma unroll
        for (int o = 0; o < OUT; ++o) p[0][o] += __shfl_xor_sync(0xffffffffu, p[0][o], d);
      const int r = base + (q * P + li % P) * G + gi;
      if (li < P && r < r1) {
        float v[OUT];
#pragma unroll
        for (int o = 0; o < OUT; ++o) {
          v[o] = p[0][o] + bias[o];
          tsum[o] += v[o];
          tsq[o] += v[o] * v[o];
        }
        float* dst = ub + size_t(r) * OUT;
        if constexpr (OUT == 4) {
          *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
        } else if constexpr (OUT == 2) {
          *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
        } else {
#pragma unroll
          for (int o = 0; o < OUT; ++o) dst[o] = v[o];
        }
      }
    }
  }
  // block reduction in a fixed order: lanes, then warps
#pragma unroll
  for (int o = 0; o < OUT; ++o) {
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      tsum[o] += __shfl_xor_sync(0xffffffffu, tsum[o], off);
      tsq[o] += __shfl_xor_sync(0xffffffffu, tsq[o], off);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int o = 0; o < OUT; ++o) {
      red[warp][o] = tsum[o];
      red[warp][OUT + o] = tsq[o];
    }
  }
  __syncthreads();
  if (threadIdx.x < OUT) {
    const int o = threadIdx.x;
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < K2_WARPS; ++i) {
      s1 += red[i][o];
      s2 += red[i][OUT + o];
    }
    const size_t idx = (size_t(b) * gridDim.x + blockIdx.x) * OUT + o;
    usum[idx] = s1;
    usq[idx] = s2;
  }
}

using HeadTailKernel = void (*)(const void*, const float*, const float*, const float*,
                                const float*, const float*, float*, float*, float*, int, int);
#define K2_ROW(ZT, LPR) \
  {head_tail_kernel<ZT, LPR, 1>, head_tail_kernel<ZT, LPR, 2>, head_tail_kernel<ZT, LPR, 3>, head_tail_kernel<ZT, LPR, 4>}
#define K2_TABLE(ZT) {K2_ROW(ZT, 1), K2_ROW(ZT, 2), K2_ROW(ZT, 4), K2_ROW(ZT, 8), K2_ROW(ZT, 16), K2_ROW(ZT, 32)}
// [z is f32][log2(LPR)][out_ch - 1]
const HeadTailKernel kHeadTail[2][6][MAXO] = {K2_TABLE(bf16), K2_TABLE(float)};
#undef K2_TABLE
#undef K2_ROW

enum ArgError {
  kBadTile = -1,
  kBadShape = -2,
  kNoTensorMap = -4,
  kRegisterBudget = -5,
};

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                  : nullptr;
  }();
  return fn;
}

// TMA map of a K-major bf16 tensor [outer][N][K] read in KC x BN x 1 boxes
// with the 128-byte swizzle; out-of-range elements arrive as zeros
bool encode_kmajor(CUtensorMap* map, const void* base, int K, int N, int outer) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[3] = {cuuint64_t(K), cuuint64_t(N), cuuint64_t(outer)};
  const cuuint64_t strides[2] = {cuuint64_t(K) * 2, cuuint64_t(K) * N * 2};
  const cuuint32_t box[3] = {KC, BN, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Sets the kernel's dynamic shared memory, after checking that the launch
// gives the register pool that setmaxnreg redistributes (with fewer, the
// consumers' setmaxnreg.inc would wait forever).
template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return int(err);
  if (attr.numRegs < LAUNCH_REGS) return kRegisterBudget;
  return int(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem)));
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a conv block takes at C (and KP: 0 for
// K3/T1/T2, which stream no patches).
long posfeat_conv_smem_bytes(int C, int KP) {
  return long(conv_smem_bytes(C, KP, KP ? kPatches : kImgNone));
}

// kph_t is kph as [9, N, C] and wm_t is wm as [B, N, KP] (K-major).
// Returns 0, a cudaError_t value, or a negative ArgError.
int posfeat_conv_phase(const void* tp, const void* kph_t, const void* pat, const void* wm_t,
                       const void* b2b, void* z, void* psum, void* psq, int B, int h, int w,
                       int C, int KP, int N, int th, int tw, void* stream) {
  if (th != TH || tw != TW) return kBadTile;
  if (C < 32 || C % 32 || KP % 32 || N % 128 || B < 1 || h < 1 || w < 1) return kBadShape;
  const size_t smem = conv_smem_bytes(C, KP, kPatches);
  CUtensorMap kmap, wmap;
  if (!encode_kmajor(&kmap, kph_t, C, N, 9)) return kNoTensorMap;
  if (KP == 0) {
    wmap = kmap;  // no patch half: never read
  } else if (!encode_kmajor(&wmap, wm_t, KP, N, B)) {
    return kNoTensorMap;
  }
  const int rc = prepare(conv_phase_kernel, smem);
  if (rc) return rc;
  const int T = ((h + TH - 1) / TH) * ((w + TW - 1) / TW);
  conv_phase_kernel<<<B * T, K1_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      kmap, wmap, static_cast<const bf16*>(tp), static_cast<const bf16*>(pat),
      static_cast<const float*>(b2b), static_cast<bf16*>(z), static_cast<float*>(psum),
      static_cast<float*>(psq), h, w, C, KP, N);
  return int(cudaGetLastError());
}

// kph_t is kph as [9, N, C]. layout: 0 = full-res z_img (K3), 1 = no image
// term (T1), 2 = pre-phased z_img (T2). b2 is one [N] row. Returns 0, a
// cudaError_t value, or a negative ArgError.
int posfeat_conv_phase_img(const void* tp, const void* kph_t, const void* img, const void* b2,
                           void* z, void* psum, void* psq, int B, int h, int w, int C, int N,
                           int cout, int layout, int th, int tw, void* stream) {
  if (th != TH || tw != TW) return kBadTile;
  if (C < 32 || C % 32 || N % 128 || cout % 8 || N != 16 * cout || layout < 0 || layout > 2 ||
      B < 1 || h < 1 || w < 1)
    return kBadShape;
  const size_t smem = conv_smem_bytes(C, 0, kImgNone);
  CUtensorMap kmap;
  if (!encode_kmajor(&kmap, kph_t, C, N, 9)) return kNoTensorMap;
  using Kernel = void (*)(const CUtensorMap, const bf16*, const bf16*, const float*, bf16*, float*,
                          float*, int, int, int, int, int);
  const Kernel kernels[3] = {conv_phase_img_full_kernel, conv_phase_img_none_kernel,
                             conv_phase_img_phase_kernel};
  const Kernel kernel = kernels[layout];
  const int rc = prepare(kernel, smem);
  if (rc) return rc;
  const int T = ((h + TH - 1) / TH) * ((w + TW - 1) / TW);
  kernel<<<B * T, K1_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      kmap, static_cast<const bf16*>(tp), static_cast<const bf16*>(img),
      static_cast<const float*>(b2), static_cast<bf16*>(z), static_cast<float*>(psum),
      static_cast<float*>(psq), h, w, C, N, cout);
  return int(cudaGetLastError());
}

// z [B, R, cout] phase rows in bf16 (z_f32 = 0) or f32 (z_f32 = 1).
int posfeat_head_tail(const void* z, const void* mu, const void* sc,
                      const void* a, const void* w3, const void* b3, void* u,
                      void* usum, void* usq, int B, int R, int cout, int out_ch,
                      int rows_per_block, int z_f32, void* stream) {
  const int lpr = cout / 8;
  if (cout % 8 || lpr < 1 || lpr > 32 || (lpr & (lpr - 1)) || out_ch < 1 || out_ch > MAXO ||
      rows_per_block < 1 || B < 1 || B > 65535 || R < 1 || z_f32 < 0 || z_f32 > 1)
    return kBadShape;
  int log2_lpr = 0;
  while ((1 << log2_lpr) < lpr) ++log2_lpr;
  dim3 grid((R + rows_per_block - 1) / rows_per_block, B);
  kHeadTail[z_f32][log2_lpr][out_ch - 1]<<<grid, K2_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      z, static_cast<const float*>(mu),
      static_cast<const float*>(sc), static_cast<const float*>(a),
      static_cast<const float*>(w3), static_cast<const float*>(b3),
      static_cast<float*>(u), static_cast<float*>(usum), static_cast<float*>(usq),
      R, rows_per_block);
  return int(cudaGetLastError());
}

const char* posfeat_error_string(int code) {
  switch (code) {
    case kBadTile:
      return "conv tile size differs from the compiled TH x TW";
    case kBadShape:
      return "shape outside what the kernel supports";
    case kNoTensorMap:
      return "cuTensorMapEncodeTiled unavailable or refused the operand";
    case kRegisterBudget:
      return "the conv kernel was compiled with fewer registers than its warp specialisation needs";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
