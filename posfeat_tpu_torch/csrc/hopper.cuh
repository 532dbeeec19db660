// Hopper (sm_90a) helpers shared by fused_head.cu, fused_head_f32.cu and
// reinforce.cu: shared-memory addresses, mbarriers, bulk copies, named
// barriers, setmaxnreg, wgmma operand descriptors of K-major tiles in core
// matrices without swizzle, the wgmma fence, commit and wait, and the 3xTF32
// pieces (the TF32 split, the m64n128k8 TF32 wgmma, a 16-deep chunk's six
// of them in one block).

#pragma once

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

// Spins on the barrier's phase; traps after about 2^24 polls (seconds)
// so that a fault in the pipeline ends the launch with an error.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls > (1u << 24)) __trap();
  }
}

// mbar_wait as one asm block (the poll loop and its trap inside it), for
// consumers that wait between wgmmas: a loop in C++ there made ptxas cap
// their registers below what setmaxnreg gives and spill the accumulators
__device__ __forceinline__ void mbar_wait_asm(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u32 n;\nmov.u32 n, 0;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra.uni DONE;\n"
      "add.u32 n, n, 1;\n"
      "setp.lt.u32 p, n, 16777216;\n"
      "@p bra.uni WAIT;\n"
      "trap;\n"
      "DONE:\n}\n" ::"r"(bar), "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// shared-memory descriptor of a K-major operand in core matrices (8 rows of
// 16 bytes) without swizzle: lbo bytes between core matrices along K, sbo
// bytes between 8-row groups along M or N
__device__ __forceinline__ uint64_t desc_interleave(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) | (uint64_t(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads of the accumulators above a wait,
// or from touching accumulators that a wgmma may still write
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// bytes global -> shared by the bulk copy engine, completing on mbarrier bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
               ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}

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

// d[64 x 128] = A[64 x 8] * B[8 x 128], d written without being read: its
// old values are dead from here back to their last read
__device__ __forceinline__ void wgmma_m64n128k8_tf32_first(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 0, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(da), "l"(db));
}

// The low word of desc_interleave(addr, lbo, sbo) for lbo = 2048 (128-row
// tiles) and sbo = 128; its high word is sbo >> 4 = 8. An offset of k
// bytes (addr + k below 256 KB) adds k >> 4 to it.
__device__ __forceinline__ uint32_t desc_lo_128rows(uint32_t addr) {
  return ((addr & 0x3FFFF) >> 4) | (uint32_t(2048 >> 4) << 16);
}

// the 64 accumulator operands %0 .. %63 of an m64n128 wgmma in an asm block
#define POSFEAT_WGMMA_D64 \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" \
  "}"

// d[64 x 128] = the six TF32 products of one 16-deep chunk of 3xTF32 on
// 128-row tiles in core matrices (K-major, 128 rows, [depth / 4][128][4]
// floats, hi then lo 8 KB further): A (64 rows) at the descriptor word
// a_lo, B (128 rows) at b_lo (desc_lo_128rows); lo.hi and hi.lo of depths
// 0-7 and 8-15 (2 KB further), then hi.hi of both, the small terms first,
// in one tensor-core accumulator that starts from zero: d is written
// without being read. One asm block, so that the eight descriptors live
// only inside it.
__device__ __forceinline__ void wgmma_chunk16_3xtf32(float (&d)[64], uint32_t a_lo, uint32_t b_lo) {
  asm volatile(
      "{\n.reg .pred p0, p1;\n.reg .b32 t;\n"
      ".reg .b64 ah0, al0, ah1, al1, bh0, bl0, bh1, bl1;\n"
      "setp.ne.b32 p0, 0, 0;\nsetp.eq.b32 p1, 0, 0;\n"
      "cvt.u64.u32 ah0, %64;\nor.b64 ah0, ah0, 34359738368;\n"
      "add.u32 t, %64, 512;\ncvt.u64.u32 al0, t;\nor.b64 al0, al0, 34359738368;\n"
      "add.u32 t, %64, 256;\ncvt.u64.u32 ah1, t;\nor.b64 ah1, ah1, 34359738368;\n"
      "add.u32 t, %64, 768;\ncvt.u64.u32 al1, t;\nor.b64 al1, al1, 34359738368;\n"
      "cvt.u64.u32 bh0, %65;\nor.b64 bh0, bh0, 34359738368;\n"
      "add.u32 t, %65, 512;\ncvt.u64.u32 bl0, t;\nor.b64 bl0, bl0, 34359738368;\n"
      "add.u32 t, %65, 256;\ncvt.u64.u32 bh1, t;\nor.b64 bh1, bh1, 34359738368;\n"
      "add.u32 t, %65, 768;\ncvt.u64.u32 bl1, t;\nor.b64 bl1, bl1, 34359738368;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " POSFEAT_WGMMA_D64 ", al0, bh0, p0, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " POSFEAT_WGMMA_D64 ", ah0, bl0, p1, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " POSFEAT_WGMMA_D64 ", al1, bh1, p1, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " POSFEAT_WGMMA_D64 ", ah1, bl1, p1, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " POSFEAT_WGMMA_D64 ", ah0, bh0, p1, 1, 1;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " POSFEAT_WGMMA_D64 ", ah1, bh1, p1, 1, 1;\n"
      "}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "r"(a_lo), "r"(b_lo));
}
#undef POSFEAT_WGMMA_D64

}  // namespace
