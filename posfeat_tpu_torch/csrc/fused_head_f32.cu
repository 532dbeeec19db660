// f32 instances of the fused head's conv kernels for Hopper (sm_90a),
// plain C interface.
//
// posfeat_conv_phase_f32 is K1 at f32 (replaces posfeat_tpu/ops/pallas/
// fused_head.py:148 _conv_kernel_v3 where the head runs at float32);
// posfeat_conv_phase_img_f32 is K3 (fused_head.py:70 _conv_kernel, the v1
// dataflow), T1 (tools/bench_fused_parts.py:105 _conv_kernel_noz) and T2
// (bench_fused_parts.py:154 _conv_kernel_prephase) at f32;
// posfeat_conv_split_f32 prepares the operands that both read. They compute
// what the bf16 kernels of fused_head.cu compute,
//   z[b, y, x, n] = sum_{dy,dx,c} tp[b, y+dy, x+dx, c] * kph[dy*3+dx, c, n]
//                 + (K1) sum_p pat[b, y, x, p] * wm[b, p, n] + b2b[b, n]
//                 + (K3, T2) the image term Z[b, y, x, n] + b2[n],
// with z stored as f32, plus per-tile column sums of z and z^2, in the same
// [B, T, N] partials layout over the same 8 x 16 trunk tiles. The Python
// wrappers (posfeat_tpu_torch/ops/fused_head.py) check devices, dtypes,
// shapes, contiguity and alignment, allocate every output and the split's
// scratch, pass PyTorch's current stream, and raise on a non-zero return
// code.
//
// Arithmetic: 3xTF32 on the tensor cores, as the REINFORCE passes run their
// product (reinforce.cu). The split writes each operand as x = hi + lo, hi =
// cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi); each 8-deep step forms
// lo.hi + hi.lo + hi.hi (the dropped lo.lo term is ~2^-22 relative), and
// each 16-deep chunk's six products are added to an f32 running sum with a
// rounded add: the tensor cores' own accumulation truncates, always the
// same way, and over K = 1920 (K1) its drift would reach ~1e-5 of z. The
// Pallas kernel at f32 forms exact f32 products; so does this one, to
// ~2^-22, and its sums are f32 sums in another order.
//
// What bounds it: at the flagship point (B = 16, h = 120, w = 160, C = 192,
// N = 16 * 128 = 2048, KP = 192) K1 is 2.42 TFLOP of f32 products per
// launch, 7.25 TFLOP as three TF32 products: 14.6 ms at 495 TFLOP/s, against
// about 2.6 GB of traffic (mostly the z write): the tensor cores bound it
// (K3, T1, T2: 2.17 TFLOP, 13.2 ms).
//
// Design:
// - The split (split_tiles_kernel, split_b_kernel, one launch per operand)
//   writes hi and lo into scratch laid out as the conv kernel reads it, so
//   that every operand reaches shared memory by a bulk copy (async proxy, no
//   thread work), completing on an mbarrier: the edge-padded trunk as one
//   halo (10 x 18 cells) per 8 x 16 tile and (K1) the patch rows in the same
//   10 x 18 geometry (the tile's 8 x 16 at its origin: one descriptor layout
//   for both), in slices of 16 channels, [hi, lo][4][180][4] (K-major core
//   matrices: 8 consecutive cells x 4 channels); kph and wm[b] in chunks of 16 depths
//   x 128 output channels, [hi, lo][4][128][4], in the order the kernel takes
//   them. Halo and patch tile as hi and lo (276 KB each at C = KP = 192)
//   do not fit a block's 227 KB, so they stream in slices too: each tile
//   reads them once per N step (16 per launch at N = 2048).
// - One block = one 8 x 16 tile of trunk cells (BM = 128 GEMM rows) of one
//   image, swept over all N in steps of BN = 128 channels. Warp
//   specialisation: consumer warpgroup xh (warps 4 xh .. 4 xh + 3) owns
//   tile columns 8 xh .. 8 xh + 7 of all 8 tile rows (64 GEMM rows) x 128
//   channels; warpgroup 2 is the producer (one thread starts the bulk
//   copies; the warpgroup gives its registers back with setmaxnreg, 24
//   each, so that the consumers get 240).
// - Two rings with full/empty mbarriers: A (NA = 4 slots of a 23,040-byte
//   halo or patch slice) and B (NB = 8 chunks of 16 KB). Per
//   N step the kernel takes the halo slices in turn, each against the 9 taps
//   of kph's chunk for its channels (a 3x3 tap is only a shifted start
//   address in the halo: 16 B a column, 288 B a row), then (K1) the patch
//   slices against wm[b]'s chunks.
// - MMAs are wgmma.m64n128k8 tf32 with both operands in shared memory. A
//   16-deep chunk's six products (one commit group) go into one of two
//   accumulator sets that take turns (d0, d1), and each set is added into
//   the running sum acc once the chunk two back has retired, as
//   product_tiles does in reinforce.cu per 8-deep step: 192 registers of
//   accumulators, and each warpgroup keeps up to 12 wgmmas queued. A
//   chunk's B slot (and, with a slice's last chunk, its A slot) is released
//   once its wgmmas retire.
// - Epilogue from the registers at the end of each N step: z = acc + bias
//   (+ Z) leaves as 8-byte stores (each quad of lanes writes 32 contiguous
//   bytes), streamed; the column sums of z and z^2 over the tile's valid
//   cells are summed over each warp's 16 rows by a shuffle reduce-scatter,
//   then over the 8 consumer warps through shared memory in a fixed order:
//   deterministic, no atomics.
// B traffic: each tile reads K x N x 8 B of B (31.5 MB at the flagship
// point, 75.5 GB per K1 launch, from L2) and its A slices once per N step.
// Neither 256 rows a block (four consumer warpgroups' 192 accumulator
// registers do not fit the register file) nor a two-block cluster sharing
// B by multicast is taken: tools/profile_torch_conv_stages.py --dtype
// float32 timed the wgmma loop alone (staging and epilogue cut) at 20.7 ms
// for K3 and 22.8 for K1 on an H100 at 700 W, as long as the whole kernel
// (19.9-20.2 and 21.6-22.5 ms), while the operand stream alone took 7.4
// and 11.1 ms: the stream hides behind the wgmmas, which run at 66-72% of
// the 3xTF32 peak, and the epilogue adds at most about 1 ms.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int TH = 8;
constexpr int TW = 16;
constexpr int BM = TH * TW;  // 128 cells a tile
constexpr int BN = 128;      // output channels a step
constexpr int SLICE = 16;    // channels of an A slice = depths of a B chunk: two 8-deep steps
constexpr int HALO_W = TW + 2;
constexpr int HALO_CELLS = (TH + 2) * HALO_W;           // 180
constexpr int HALO_FLOATS = 2 * SLICE * HALO_CELLS;     // a halo or patch slice, hi and lo: 23,040 B
constexpr int CHUNK_FLOATS = 2 * SLICE * BN;            // a B chunk, hi and lo: 16,384 B
constexpr int NA = 4;                                   // A slots
constexpr int NB = 8;                                   // B slots
constexpr int THREADS = 384;                            // 2 consumer warpgroups + a producer warpgroup
constexpr int CONSUMER_WARPS = 8;
constexpr int RED_FLOATS = CONSUMER_WARPS * 2 * BN;     // column sums of z, z^2 per consumer warp
constexpr size_t SMEM_BYTES = size_t(NB * CHUNK_FLOATS + NA * HALO_FLOATS + RED_FLOATS) * 4 + 8 * 2 * (NA + NB);
static_assert(SMEM_BYTES <= 232448, "over a block's shared memory");
// registers per thread: the launch gives 168 to each of 384 threads; the
// producer warpgroup drops to 24 so that each consumer can rise to 240
constexpr int LAUNCH_REGS = 168, PRODUCER_REGS = 24, CONSUMER_REGS = 240;
static_assert(128 * PRODUCER_REGS + 256 * CONSUMER_REGS <= THREADS * LAUNCH_REGS, "over the launch's registers");
constexpr int SPLIT_THREADS = 256;

// the image term of the epilogue (fused_head.cu's codes)
enum ImageTerm { kPatches = 0, kImgFull = 1, kImgNone = 2, kImgPhase = 3 };
// posfeat_error_string's codes (fused_head.cu)
enum ArgError { kBadTile = -1, kBadShape = -2, kRegisterBudget = -5 };

// x [B][HH][WW][CC] -> for each (b, tile) the region of RH x RW cells at
// the tile's origin (row (tile / ntx) * TH, column (tile % ntx) * TW),
// split into TF32 hi and lo: out [B][T][CC / SLICE][hi, lo][SLICE / 4]
// [RH * RW][4], zeros outside x. One thread per 4 channels of a cell,
// consecutive threads on consecutive cells (contiguous stores).
__global__ void __launch_bounds__(SPLIT_THREADS) split_tiles_kernel(
    const float* __restrict__ x, int HH, int WW, int CC, int RH, int RW, int ntx, int T, size_t total,
    float* __restrict__ out) {
  const size_t i = size_t(blockIdx.x) * SPLIT_THREADS + threadIdx.x;
  if (i >= total) return;
  const int cells = RH * RW;
  const int cell = int(i % cells);
  const size_t r = i / cells;
  const int c4 = int(r % (CC / 4));
  const size_t bt = r / (CC / 4);
  const int tile = int(bt % T), b = int(bt / T);
  const int y = (tile / ntx) * TH + cell / RW, xx = (tile % ntx) * TW + cell % RW;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (y < HH && xx < WW) v = __ldg(reinterpret_cast<const float4*>(x + ((size_t(b) * HH + y) * WW + xx) * CC) + c4);
  float* o = out + ((bt * (CC / SLICE) + c4 / 4) * 8 * cells + size_t(c4 % 4) * cells + cell) * 4;
  split_store(o, o + 16 * size_t(cells), v);
}

// x [G][K][N] -> chunks of SLICE depths x BN columns split into TF32 hi and
// lo, [hi, lo][SLICE / 4][BN][4], chunk ((n / BN) * (K / SLICE) + k / SLICE)
// * G + g when taps_inner (kph, G = 9: the kernel takes the 9 taps of a
// halo slice in turn), else (g * (N / BN) + n / BN) * (K / SLICE) + k /
// SLICE (wm, G = B). One thread per 4 depths of a column, consecutive
// threads on consecutive columns.
__global__ void __launch_bounds__(SPLIT_THREADS) split_b_kernel(
    const float* __restrict__ x, int G, int K, int N, int taps_inner, size_t total, float* __restrict__ out) {
  const size_t i = size_t(blockIdx.x) * SPLIT_THREADS + threadIdx.x;
  if (i >= total) return;
  const int n = int(i % N);
  const size_t r = i / N;
  const int k4 = int(r % (K / 4)), g = int(r / (K / 4));
  const float* src = x + (size_t(g) * K + 4 * k4) * N + n;
  const float4 v = make_float4(__ldg(src), __ldg(src + N), __ldg(src + 2 * size_t(N)), __ldg(src + 3 * size_t(N)));
  const int ns = n / BN, kc = k4 / 4, nk = K / SLICE;
  const size_t chunk = taps_inner ? (size_t(ns) * nk + kc) * G + g : (size_t(g) * (N / BN) + ns) * nk + kc;
  float* o = out + chunk * CHUNK_FLOATS + (size_t(k4 % 4) * BN + n % BN) * 4;
  split_store(o, o + CHUNK_FLOATS / 2, v);
}

// one step of a reduce-scatter across the lanes that differ in bit M: the
// lane with the bit set keeps the sums of d[HALF .. 2 HALF), the other those
// of d[0 .. HALF), both in d[0 .. HALF)
template <int M, int HALF>
__device__ __forceinline__ void reduce_scatter_step(float (&d)[64], int lane) {
  const bool hi = lane & M;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float recv = __shfl_xor_sync(0xffffffffu, hi ? d[i] : d[i + HALF], M);
    d[i] = (hi ? d[i + HALF] : d[i]) + recv;
  }
}

// One block: a TH x TW tile of trunk cells of image b against all N output
// channels, in steps of BN. halo_s, kph_s, pat_s, wm_s: the split's
// scratch (pat_s and wm_s for kPatches only); img is the image term's
// tensor (kImgFull: full-res [B, 4h, 4w, cout]; kImgPhase: [B, h, w, N]);
// bias is [B][N] with bias_bstride N, or one [N] row with bias_bstride 0.
template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
conv_phase_f32_kernel(const float* __restrict__ halo_s, const float* __restrict__ kph_s,
                      const float* __restrict__ pat_s, const float* __restrict__ wm_s,
                      const float* __restrict__ img, const float* __restrict__ bias_all, int bias_bstride,
                      float* __restrict__ z, float* __restrict__ psum, float* __restrict__ psq, int h, int w,
                      int C, int KP, int N, int cout) {
  constexpr bool kPat = MODE == kPatches;
  constexpr bool kHasImg = MODE == kImgFull || MODE == kImgPhase;
  extern __shared__ __align__(128) float smem[];
  float* bring = smem;                        // [NB][CHUNK_FLOATS]
  float* aring = bring + NB * CHUNK_FLOATS;   // [NA][HALO_FLOATS]
  float* red = aring + NA * HALO_FLOATS;      // [8 warps][z, z^2][BN]
  const uint32_t full_b = smem_u32(red + RED_FLOATS), empty_b = full_b + 8 * NB;
  const uint32_t full_a = empty_b + 8 * NB, empty_a = full_a + 8 * NA;

  const int tid = threadIdx.x;
  const int ntx = (w + TW - 1) / TW;
  const int T = ntx * ((h + TH - 1) / TH);
  const int b = blockIdx.x / T, tile = blockIdx.x % T;
  const int y0 = (tile / ntx) * TH, x0 = (tile % ntx) * TW;
  // per N step: nq chunks, 9 per halo slice (one per tap), then one per
  // patch slice
  const int nh = C / SLICE, np = kPat ? KP / SLICE : 0, nq = 9 * nh + np;
  const int nsteps = N / BN;

  if (tid == 0) {
    for (int s = 0; s < NB; ++s) {
      mbar_init(full_b + 8 * s, 1);
      mbar_init(empty_b + 8 * s, CONSUMER_WARPS);
    }
    for (int s = 0; s < NA; ++s) {
      mbar_init(full_a + 8 * s, 1);
      mbar_init(empty_a + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // producer warpgroup (warpgroup 2): one thread keeps both rings full, in
    // the order the consumers take the operands.
    // A slot's first fill waits on parity 1 of its fresh empty barrier,
    // which counts as complete.
    setmaxnreg_dec<PRODUCER_REGS>();
    // staging begin (tools/profile_torch_conv_stages.py cuts the copies and the waits for them)
    if (tid == 256) {
      // kph's chunks (all N steps) and wm[b]'s lie in the order they are
      // taken: two running offsets from the kernel's parameters, so that
      // the producer's 24 registers hold no pointer
      int ia = 0, ib = 0;
      uint32_t kb = 0, wb = uint32_t(b) * nsteps * np * CHUNK_FLOATS;
      for (int step = 0; step < nsteps; ++step) {
        for (int q = 0; q < nq; ++q, ++ib) {
          const bool is_halo = q < 9 * nh;
          if (!is_halo || q % 9 == 0) {
            const int sa = ia % NA;
            mbar_wait(empty_a + 8 * sa, ((ia / NA) & 1) ^ 1);
            mbar_expect_tx(full_a + 8 * sa, HALO_FLOATS * 4);
            const size_t bt = blockIdx.x;  // b * T + tile
            bulk_load(smem_u32(aring + sa * HALO_FLOATS),
                      is_halo ? halo_s + (bt * nh + q / 9) * HALO_FLOATS : pat_s + (bt * np + q - 9 * nh) * HALO_FLOATS,
                      HALO_FLOATS * 4, full_a + 8 * sa);
            ++ia;
          }
          const int sb = ib % NB;
          mbar_wait(empty_b + 8 * sb, ((ib / NB) & 1) ^ 1);
          mbar_expect_tx(full_b + 8 * sb, CHUNK_FLOATS * 4);
          bulk_load(smem_u32(bring + sb * CHUNK_FLOATS), is_halo ? kph_s + kb : wm_s + wb, CHUNK_FLOATS * 4,
                    full_b + 8 * sb);
          if (is_halo) {
            kb += CHUNK_FLOATS;
          } else {
            wb += CHUNK_FLOATS;
          }
        }
      }
    }
    // staging end
    return;
  }

  // consumer warpgroups (warps 0-7)
  setmaxnreg_inc<CONSUMER_REGS>();
  const int ct = tid;     // consumer thread 0..255
  const int cw = ct / 32;  // consumer warp 0..7
  const int lane = tid % 32;
  // consumer warpgroup xh takes tile columns 8 xh .. 8 xh + 7 of all 8 tile
  // rows: its 64 GEMM rows are 8 core-matrix groups of 8 consecutive cells,
  // one per tile row, HALO_W cells apart in a slice at any tap
  const int xh = cw / 4;
  const uint32_t aring_u = smem_u32(aring) + 8 * xh * 16, bring_u = smem_u32(bring);

  float acc[64], d0[64], d1[64];
  auto add = [&](float (&d)[64]) {
    fence_acc(d);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += d[i];
  };
  // one chunk's six products into d: lo.hi and hi.lo of both 8-deep steps
  // (channels 0-7: 4-channel groups 0, 1; channels 8-15: groups 2, 3), then
  // hi.hi of both, the small terms first. A at a0 (hi; lo 4 groups
  // further), in core matrices LBO bytes apart along K and SBO along M; B
  // at b_u (hi; lo 4 BN * 16 further). first: d is written without being
  // read (its old values were added), so that nothing holds d0 and d1
  // through the epilogue before an N step's first chunks.
  constexpr uint32_t LBO = HALO_CELLS * 16, SBO = HALO_W * 16;
  auto products = [&](auto first, float (&d)[64], uint32_t a0, uint32_t b_u) {
    const uint64_t ah0 = desc_interleave(a0, LBO, SBO), al0 = desc_interleave(a0 + 4 * LBO, LBO, SBO);
    const uint64_t ah1 = desc_interleave(a0 + 2 * LBO, LBO, SBO), al1 = desc_interleave(a0 + 6 * LBO, LBO, SBO);
    const uint64_t bh0 = desc_interleave(b_u, BN * 16, 128), bl0 = desc_interleave(b_u + 4 * BN * 16, BN * 16, 128);
    const uint64_t bh1 = desc_interleave(b_u + 2 * BN * 16, BN * 16, 128);
    const uint64_t bl1 = desc_interleave(b_u + 6 * BN * 16, BN * 16, 128);
    wgmma_fence();
    if constexpr (decltype(first)::value)
      wgmma_m64n128k8_tf32_first(d, al0, bh0);
    else
      wgmma_m64n128k8_tf32(d, al0, bh0, 0);
    wgmma_m64n128k8_tf32(d, ah0, bl0, 1);
    wgmma_m64n128k8_tf32(d, al1, bh1, 1);
    wgmma_m64n128k8_tf32(d, ah1, bl1, 1);
    wgmma_m64n128k8_tf32(d, ah0, bh0, 1);
    wgmma_m64n128k8_tf32(d, ah1, bh1, 1);
    wgmma_commit();
    fence_acc(d);
  };
  int ia = 0, ib = 0;  // A slices and B chunks taken so far: the rings' positions
  int sa = 0;          // the current slice's A slot
  // per accumulator set: its last chunk's A slot if that chunk ended its
  // slice (else -1), freed with the chunk
  int rel0 = -1, rel1 = -1;
  // chunk q of an N step into d (d0 for even q, d1 for odd q, with their
  // rel): q < 9 nh is tap q % 9 of halo slice q / 9, then patch slice
  // q - 9 nh; a slice's first chunk waits for its A slot. first
  // (std::true_type for q = 0, 1 only): d holds nothing to add, and no
  // chunk of this N step is to be freed yet.
  auto chunk = [&](auto first, int q, float (&d)[64], int& rel) {
    const bool is_halo = q < 9 * nh;
    const int c = is_halo ? q % 9 : 0;
    if (c == 0) {
      sa = ia % NA;
      // staging begin
      mbar_wait(full_a + 8 * sa, (ia / NA) & 1);
      // staging end
      ++ia;
    }
    const int sb = ib % NB;
    // staging begin
    mbar_wait(full_b + 8 * sb, (ib / NB) & 1);
    // staging end
    wgmma_wait<1>();  // chunk ib - 2, d's last, has retired: add it, free its slots
    if constexpr (!decltype(first)::value) {
      add(d);
      if (lane == 0) {
        mbar_arrive(empty_b + 8 * ((ib - 2) % NB));
        if (rel >= 0) mbar_arrive(empty_a + 8 * rel);
      }
    }
    products(first, d, aring_u + sa * HALO_FLOATS * 4 + ((c / 3) * HALO_W + c % 3) * 16,  // tap c
          bring_u + sb * CHUNK_FLOATS * 4);
    rel = !is_halo || c == 8 ? sa : -1;
    ++ib;
  };

  for (int step = 0; step < nsteps; ++step) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    // nq is even (C and KP are multiples of 32): chunks in pairs, d0 then d1
    chunk(std::true_type{}, 0, d0, rel0);
    chunk(std::true_type{}, 1, d1, rel1);
    for (int q = 2; q < nq; q += 2) {
      chunk(std::false_type{}, q, d0, rel0);
      chunk(std::false_type{}, q + 1, d1, rel1);
    }
    // every wgmma retired and added, every slot released
    wgmma_wait<0>();
    add(d0);
    add(d1);
    if (lane == 0) {
      mbar_arrive(empty_b + 8 * ((ib - 2) % NB));
      if (rel0 >= 0) mbar_arrive(empty_a + 8 * rel0);
      mbar_arrive(empty_b + 8 * ((ib - 1) % NB));
      if (rel1 >= 0) mbar_arrive(empty_a + 8 * rel1);
    }

    // epilogue begin (tools/profile_torch_conv_stages.py cuts the kernel here)
    // The accumulator layout gives lane (g, t) channels 8j + 2t, 8j + 2t + 1
    // of rows g and g + 8: z = acc + bias (+ Z) leaves as float2, and this
    // lane's sums of z, z^2 over its two rows go to part[2j + e], part[32 +
    // 2j + e].
    const int n0 = step * BN;
    const int g = lane / 4, t = lane % 4;
    // accumulator rows g and g + 8 of this warp = tile rows 2 (cw % 4) and
    // 2 (cw % 4) + 1, both at tile column 8 xh + g
    const int y = y0 + 2 * (cw % 4), x = x0 + 8 * xh + g;
    const bool ok_row[2] = {y < h && x < w, y + 1 < h && x < w};
    const float* bias_b = bias_all + size_t(b) * bias_bstride;
    float part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) part[i] = 0.f;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      if (!ok_row[rr]) continue;
      const size_t cell = (size_t(b) * h + y + rr) * w + x;
      [[maybe_unused]] float2 zi[16];  // the image term of this lane's channels
      if constexpr (kHasImg) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int n = n0 + 8 * j + 2 * t;
          const float* src;
          if constexpr (MODE == kImgFull) {
            // channels n, n+1 share a phase: Cout is a multiple of 8
            const int ph = n / cout, cc = n % cout;
            const size_t fy = 4 * size_t(y + rr) + ph / 4, fx = 4 * size_t(x) + ph % 4;
            src = img + ((size_t(b) * 4 * h + fy) * (4 * size_t(w)) + fx) * cout + cc;
          } else {
            src = img + cell * N + n;
          }
          zi[j] = __ldg(reinterpret_cast<const float2*>(src));
        }
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int n = n0 + 8 * j + 2 * t;
        const float2 bv = __ldg(reinterpret_cast<const float2*>(bias_b + n));
        float2 v = make_float2(acc[4 * j + 2 * rr] + bv.x, acc[4 * j + 2 * rr + 1] + bv.y);
        if constexpr (kHasImg) {
          v.x += zi[j].x;
          v.y += zi[j].y;
        }
        __stcs(reinterpret_cast<float2*>(z + cell * N + n), v);
        part[2 * j] += v.x;
        part[2 * j + 1] += v.y;
        part[32 + 2 * j] += v.x * v.x;
        part[33 + 2 * j] += v.y * v.y;
      }
    }
    // over the warp's 16 rows as a reduce-scatter: lane (g, t) ends with the
    // sums (g < 4) or squares (g >= 4) of channels 8j + 2t + e, j = j0 ..
    // j0 + 3, in part[2 (j - j0) + e]
    reduce_scatter_step<16, 32>(part, lane);
    reduce_scatter_step<8, 16>(part, lane);
    reduce_scatter_step<4, 8>(part, lane);
    {
      float* dst = red + (cw * 2 + (lane >> 4)) * BN + 2 * t;
      const int j0 = ((lane >> 3) & 1) * 8 + ((lane >> 2) & 1) * 4;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        *reinterpret_cast<float2*>(dst + 8 * (j0 + jj)) = make_float2(part[2 * jj], part[2 * jj + 1]);
    }
    named_bar_sync(1, 256);
    // over the 8 consumer warps in a fixed order: thread ct takes the sums
    // (ct < BN) or the squares of channel n0 + ct % BN
    {
      const int kind = ct / BN, ch = ct % BN;
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < CONSUMER_WARPS; ++k) s += red[(k * 2 + kind) * BN + ch];
      (kind ? psq : psum)[(size_t(b) * T + tile) * N + n0 + ch] = s;
    }
    named_bar_sync(1, 256);  // red is free for the next step
    // epilogue end
  }
}

// K1 and K3, T1, T2: one kernel name each, so that profiles and -Xptxas -v
// tell them apart
template <int MODE>
int launch_conv(const float* halo_s, const float* kph_s, const float* pat_s, const float* wm_s, const float* img,
                const float* bias, int bias_bstride, float* z, float* psum, float* psq, int B, int h, int w, int C,
                int KP, int N, int cout, cudaStream_t stream) {
  // the launch must give the register pool that setmaxnreg redistributes
  // (with fewer, the consumers' setmaxnreg.inc would wait forever)
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, conv_phase_f32_kernel<MODE>);
  if (err != cudaSuccess) return int(err);
  if (attr.numRegs < LAUNCH_REGS) return kRegisterBudget;
  err = cudaFuncSetAttribute(conv_phase_f32_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(SMEM_BYTES));
  if (err != cudaSuccess) return int(err);
  const int T = ((h + TH - 1) / TH) * ((w + TW - 1) / TW);
  conv_phase_f32_kernel<MODE><<<B * T, THREADS, SMEM_BYTES, stream>>>(
      halo_s, kph_s, pat_s, wm_s, img, bias, bias_bstride, z, psum, psq, h, w, C, KP, N, cout);
  return int(cudaGetLastError());
}

// C and KP multiples of 2 SLICE: a step's chunks come in pairs (d0, d1)
int check_common(int B, int h, int w, int C, int N) {
  if (C < 2 * SLICE || C % (2 * SLICE) || N < BN || N % BN || B < 1 || h < 1 || w < 1) return kBadShape;
  if (long(B) * ((h + TH - 1) / TH) * ((w + TW - 1) / TW) > 0x7fffffffL) return kBadShape;
  return 0;
}

int launch_split_tiles(const void* x, int B, int HH, int WW, int CC, int RH, int RW, int h, int w, void* out,
                       cudaStream_t stream) {
  const int ntx = (w + TW - 1) / TW, T = ntx * ((h + TH - 1) / TH);
  const size_t total = size_t(B) * T * (CC / 4) * RH * RW;
  split_tiles_kernel<<<unsigned((total + SPLIT_THREADS - 1) / SPLIT_THREADS), SPLIT_THREADS, 0, stream>>>(
      static_cast<const float*>(x), HH, WW, CC, RH, RW, ntx, T, total, static_cast<float*>(out));
  return int(cudaGetLastError());
}

int launch_split_b(const void* x, int G, int K, int N, int taps_inner, void* out, cudaStream_t stream) {
  const size_t total = size_t(G) * (K / 4) * N;
  split_b_kernel<<<unsigned((total + SPLIT_THREADS - 1) / SPLIT_THREADS), SPLIT_THREADS, 0, stream>>>(
      static_cast<const float*>(x), G, K, N, taps_inner, total, static_cast<float*>(out));
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// The split of the f32 conv kernels' operands into TF32 hi and lo, in the
// layouts they read (see above): tp [B, h+2, w+2, C] -> halo_s; kph
// [9, C, N] -> kph_s; with KP > 0 (K1), pat [B, h, w, KP] -> pat_s and
// wm [B, KP, N] -> wm_s. Returns 0, a cudaError_t value, or a negative
// error code of posfeat_error_string.
int posfeat_conv_split_f32(const void* tp, const void* kph, const void* pat, const void* wm, void* halo_s,
                           void* kph_s, void* pat_s, void* wm_s, int B, int h, int w, int C, int KP, int N,
                           void* stream) {
  if (int rc = check_common(B, h, w, C, N)) return rc;
  if (KP < 0 || KP % (2 * SLICE)) return kBadShape;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int rc = launch_split_tiles(tp, B, h + 2, w + 2, C, TH + 2, TW + 2, h, w, halo_s, s)) return rc;
  if (int rc = launch_split_b(kph, 9, C, N, 1, kph_s, s)) return rc;
  if (KP > 0) {
    if (int rc = launch_split_tiles(pat, B, h, w, KP, TH + 2, TW + 2, h, w, pat_s, s)) return rc;
    if (int rc = launch_split_b(wm, B, KP, N, 0, wm_s, s)) return rc;
  }
  return 0;
}

// K1 on the split of posfeat_conv_split_f32 (KP as given there); b2b [B, N]
// f32; z [B, h, w, N] f32; psum, psq [B, T, N].
int posfeat_conv_phase_f32(const void* halo_s, const void* kph_s, const void* pat_s, const void* wm_s,
                           const void* b2b, void* z, void* psum, void* psq, int B, int h, int w, int C, int KP,
                           int N, int th, int tw, void* stream) {
  if (th != TH || tw != TW) return kBadTile;
  if (int rc = check_common(B, h, w, C, N)) return rc;
  if (KP < 0 || KP % (2 * SLICE)) return kBadShape;
  return launch_conv<kPatches>(static_cast<const float*>(halo_s), static_cast<const float*>(kph_s),
                               static_cast<const float*>(pat_s), static_cast<const float*>(wm_s), nullptr,
                               static_cast<const float*>(b2b), N, static_cast<float*>(z),
                               static_cast<float*>(psum), static_cast<float*>(psq), B, h, w, C, KP, N, 0,
                               static_cast<cudaStream_t>(stream));
}

// K3 (layout 0: full-res z_img [B, 4h, 4w, cout]), T1 (1: no image term)
// and T2 (2: z_img in phase layout [B, h, w, N]) on the split of
// posfeat_conv_split_f32 (KP = 0); b2 [N] f32.
int posfeat_conv_phase_img_f32(const void* halo_s, const void* kph_s, const void* img, const void* b2, void* z,
                               void* psum, void* psq, int B, int h, int w, int C, int N, int cout, int layout,
                               int th, int tw, void* stream) {
  if (th != TH || tw != TW) return kBadTile;
  if (int rc = check_common(B, h, w, C, N)) return rc;
  if (cout % 8 || N != 16 * cout || layout < 0 || layout > 2) return kBadShape;
  using Launch = int (*)(const float*, const float*, const float*, const float*, const float*, const float*, int,
                         float*, float*, float*, int, int, int, int, int, int, int, cudaStream_t);
  const Launch launches[3] = {launch_conv<kImgFull>, launch_conv<kImgNone>, launch_conv<kImgPhase>};
  return launches[layout](static_cast<const float*>(halo_s), static_cast<const float*>(kph_s), nullptr, nullptr,
                          static_cast<const float*>(img), static_cast<const float*>(b2), 0,
                          static_cast<float*>(z), static_cast<float*>(psum), static_cast<float*>(psq), B, h, w,
                          C, 0, N, cout, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
