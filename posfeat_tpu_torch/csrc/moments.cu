// Per-row moments of an NHWC map for Hopper (sm_90a), plain C interface.
//
// posfeat_row_moments replaces no TPU kernel. The JAX head's instance norms
// sum their f32 moments through XLA, and the port's spatial program needs
// them in an order that does not depend on how many rows a call holds: the
// H-banded program (parallel/) normalises a map whose rows lie on several
// devices, and its moments must be the unsharded program's bit for bit. So
// the head's instance norms (models/keypoint_det.py instance_norm,
// parallel/banded_ops.py instance_norm) take Sx and Sx^2 of every row of the
// map from this kernel, and both programs add the same [B, rows, C] partials
// over the rows in one fixed-shape sum (ops/moments.py).
//
// The map x [B, R, ..., C] (contiguous; bf16, f16 or f32) is B * R rows of
// E = (product of the inner dims) * C elements each; channel of flat element
// e of a row is e % C. One block sums one row into s1[row][C] and
// s2[row][C] (f32). Thread t of T holds V accumulators for the elements
// t * V + k + i * T * V (i = 0, 1, ...), read as one 16-byte vector a step
// (V = 8 for 2-byte types, 4 for f32) where E % V == 0, one element a step
// (V = 1) otherwise; T * V is a multiple of C, so each accumulator stays on
// one channel. The T * V accumulators then meet in shared memory and fold
// onto the first C slots in a fixed tree (each step adds the upper part of
// a channel's entries onto the lower). Every add's order depends only on
// E, C, T and V, which the wrapper picks from the row's shape and dtype:
// never on R, the grid or the run. No atomics, no cross-block reduction.
//
// What bounds it: the map is read once and [B, R, C] written twice, so
// bytes bound it (the head's phase-layout norm of a 2048 x 3072 frame reads
// 1.61 GB: 0.48 ms at 3.35 TB/s). Four vectors a thread are in flight
// before they are added (kUnroll), in the order of e.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBadShape = 1101;
constexpr int kBadDtype = 1102;
constexpr int kUnroll = 4;
constexpr int kMaxSlots = 2048;  // T * V: two f32 arrays of it in shared memory, 16 KB

template <typename Elem, int V>
struct Load;

template <>
struct Load<float, 4> {
  __device__ static void run(const float* p, float* v) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
};

template <>
struct Load<__nv_bfloat16, 8> {
  __device__ static void run(const __nv_bfloat16* p, float* v) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};

template <>
struct Load<__half, 8> {
  __device__ static void run(const __half* p, float* v) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const __half2* h = reinterpret_cast<const __half2*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};

__device__ inline float to_float(float x) { return x; }
__device__ inline float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ inline float to_float(__half x) { return __half2float(x); }

template <typename Elem>
struct Load<Elem, 1> {
  __device__ static void run(const Elem* p, float* v) { v[0] = to_float(p[0]); }
};

template <typename Elem, int V>
__global__ void row_moments_kernel(const Elem* __restrict__ x, float* __restrict__ s1, float* __restrict__ s2,
                                   long long row_elems, int C) {
  extern __shared__ float slots[];  // [2][T * V]
  const int T = blockDim.x, t = threadIdx.x;
  const long long row = blockIdx.x;
  const Elem* xr = x + row * row_elems;
  float a1[V], a2[V];
#pragma unroll
  for (int k = 0; k < V; ++k) a1[k] = a2[k] = 0.f;
  const long long step = static_cast<long long>(T) * V;
  long long e = static_cast<long long>(t) * V;
  for (; e + (kUnroll - 1) * step < row_elems; e += kUnroll * step) {
    float v[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) Load<Elem, V>::run(xr + e + u * step, v[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        a1[k] += v[u][k];
        a2[k] = fmaf(v[u][k], v[u][k], a2[k]);
      }
    }
  }
  for (; e < row_elems; e += step) {
    float v[V];
    Load<Elem, V>::run(xr + e, v);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      a1[k] += v[k];
      a2[k] = fmaf(v[k], v[k], a2[k]);
    }
  }
  const int n = T * V;
  float* q1 = slots;
  float* q2 = slots + n;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    q1[t * V + k] = a1[k];
    q2[t * V + k] = a2[k];
  }
  __syncthreads();
  // slot j * C + c holds channel c's j-th entry; fold the upper entries onto
  // the lower ones until one is left
  for (int m = n / C; m > 1;) {
    const int h = m >> 1, keep = m - h;
    for (int i = t; i < h * C; i += T) {
      q1[i] += q1[keep * C + i];
      q2[i] += q2[keep * C + i];
    }
    __syncthreads();
    m = keep;
  }
  for (int c = t; c < C; c += T) {
    s1[row * C + c] = q1[c];
    s2[row * C + c] = q2[c];
  }
}

template <typename Elem, int V>
int launch(const void* x, void* s1, void* s2, long long rows, long long row_elems, int C, int threads,
           cudaStream_t stream) {
  const size_t smem = 2 * sizeof(float) * threads * V;
  row_moments_kernel<Elem, V><<<static_cast<unsigned>(rows), threads, smem, stream>>>(
      static_cast<const Elem*>(x), static_cast<float*>(s1), static_cast<float*>(s2), row_elems, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: the map as rows x row_elems elements (dtype 0 f32, 1 bf16, 2 f16);
// s1, s2: [rows][C] f32. vec: 1, or 4 (f32) / 8 (bf16, f16) with row_elems
// and x's address multiples of it in bytes of 16; threads * vec a multiple
// of C and at most kMaxSlots. Returns 0 or an error code.
int posfeat_row_moments(const void* x, void* s1, void* s2, int dtype, long long rows, long long row_elems, int C,
                        int vec, int threads, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || rows > 0x7fffffffLL || row_elems <= 0 || C <= 0 || row_elems % C || threads <= 0 ||
      threads > 1024 || (threads * vec) % C || threads * vec > kMaxSlots || row_elems % vec)
    return kBadShape;
  if (dtype == 0 && vec == 4) return launch<float, 4>(x, s1, s2, rows, row_elems, C, threads, s);
  if (dtype == 1 && vec == 8) return launch<__nv_bfloat16, 8>(x, s1, s2, rows, row_elems, C, threads, s);
  if (dtype == 2 && vec == 8) return launch<__half, 8>(x, s1, s2, rows, row_elems, C, threads, s);
  if (vec != 1) return kBadShape;
  if (dtype == 0) return launch<float, 1>(x, s1, s2, rows, row_elems, C, threads, s);
  if (dtype == 1) return launch<__nv_bfloat16, 1>(x, s1, s2, rows, row_elems, C, threads, s);
  if (dtype == 2) return launch<__half, 1>(x, s1, s2, rows, row_elems, C, threads, s);
  return kBadDtype;
}

const char* posfeat_moments_error_string(int code) {
  switch (code) {
    case kBadShape:
      return "shape outside what the row-moments kernel takes (rows in [1, 2^31), a row a whole number of "
             "channels, threads * vec a multiple of C and at most 2048)";
    case kBadDtype:
      return "the row-moments kernel takes float32, bfloat16 and float16 maps";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
