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
// e of a row is e % C. The kernel writes s [2][B * R][C]: Sx, then Sx^2. Two
// plans, which ops/moments.py launch_shape picks from (E, C, dtype) alone, so
// that every add's order depends on those and never on R, the grid, the card
// or the run. No atomics, no cross-block reduction: a row is summed by the
// threads of one block.
//
// The lane plan (row_moments_kernel<Elem>), for rows of whole 16-byte vectors
// (V = 8 bf16 / f16, 4 f32 elements) and C a power of two up to 32 * V (the
// head's score norms, C = 1, and its 64- and 128-channel ones): `lanes`
// threads a row (32 to 512, from the row's length: about 16 vectors a
// lane), 256 / lanes rows a block (one row of 512). Lane t adds the vectors t + n * lanes,
// n = 0, 1, ..., in the order of n, kInFlight loads in flight (a guarded,
// unrolled body: past the row's end it reads zeros); its V accumulators each
// stay on one channel. Then, in a fixed tree: where C < V a lane folds its
// upper accumulators onto its lower ones, a warp's lanes that hold the same
// channels (lanes equal mod P = C / min(C, V)) meet in a butterfly of
// __shfl_xor_sync (masks P .. 16: no shared memory, no barrier), and where a
// row has more than one warp, lane c adds channel c of its warps in warp
// order through shared memory (one barrier).
//
// The slot plan (row_moments_slots_kernel<Elem, V>), for any other row (the
// head's 192-channel trunk norm, channel counts such as 7 or 520, rows not of
// whole vectors): one block a row; thread t of T holds V accumulators for
// the elements t * V + k + i * T * V, T * V a multiple of C (a power of two
// times C where the plan allows); the T * V slots meet in shared memory and
// fold onto the first C in a fixed tree, each step adding a channel's upper
// entries onto its lower ones.
//
// What bounds it: the map is read once and [2, B, R, C] written, so bytes
// bound it (the head's phase-layout norm of a 2048 x 3072 frame reads
// 1.61 GB: 0.48 ms at 3.35 TB/s). The lane plan sizes the threads of a row
// by its length, so that the 480 x 640 score norm's rows of 640 elements take
// one warp each, eight to a block, with no shared memory and no barrier,
// where the slot plan gave each its own block of 256 threads and a 10-step
// fold (0.0223 -> 0.0057 ms on an H100 at B = 16); long rows keep up to 512
// lanes of loads in flight. For 192 channels a lane would hold 3 vectors (48
// accumulators): that plan ran 4-19% slower than the slot plan on an H100
// (fewer threads resident), so those rows keep the slot plan, with 96
// threads a row for the 480 x 640 trunk norm (0.0477 -> 0.0428 ms against
// 240). tools/profile_torch_moments.py times every plan.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBadShape = 1101;
constexpr int kBadDtype = 1102;
constexpr int kUnroll = 4;         // slot plan: vectors a thread loads before it adds them
constexpr int kMaxSlots = 4096;    // slot plan: T * V, two f32 arrays of it in shared memory, 32 KB
constexpr int kBlock = 256;        // lane plan: threads a block, or a row's lanes where more
constexpr int kMaxLanes = 512;     // lane plan: threads a row
constexpr int kInFlight = 8;       // lane plan: 16-byte loads a lane issues before it adds them
constexpr int kLaneSmem = 48 * 1024;

// a 16-byte vector of Elem as V floats
template <typename Elem>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int V = 4;
  __device__ static void cvt(const uint4& q, float* v) {
    v[0] = __uint_as_float(q.x);
    v[1] = __uint_as_float(q.y);
    v[2] = __uint_as_float(q.z);
    v[3] = __uint_as_float(q.w);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int V = 8;
  __device__ static void cvt(const uint4& q, float* v) {
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // the lower half is the first element
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <>
struct Vec<__half> {
  static constexpr int V = 8;
  __device__ static void cvt(const uint4& q, float* v) {
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
};

__device__ inline float to_float(float x) { return x; }
__device__ inline float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ inline float to_float(__half x) { return __half2float(x); }

template <typename Elem, int V>
struct Load {  // V == Vec<Elem>::V: one 16-byte vector
  __device__ static void run(const Elem* p, float* v) { Vec<Elem>::cvt(__ldg(reinterpret_cast<const uint4*>(p)), v); }
};

template <typename Elem>
struct Load<Elem, 1> {
  __device__ static void run(const Elem* p, float* v) { v[0] = to_float(p[0]); }
};

template <typename Elem>
__global__ void __launch_bounds__(kMaxLanes)
    row_moments_kernel(const Elem* __restrict__ x, float* __restrict__ s, long long rows, long long nvec, int C,
                       int lanes) {
  constexpr int V = Vec<Elem>::V;
  extern __shared__ float part[];  // [rows a block][warps a row][2][C], for rows of more than one warp
  const int t = threadIdx.x % lanes, g = threadIdx.x / lanes, l = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * (blockDim.x / lanes) + g;
  float a1[V], a2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) a1[i] = a2[i] = 0.f;
  if (row < rows) {
    const uint4* xr = reinterpret_cast<const uint4*>(x) + row * nvec;
    for (long long j = t; j < nvec; j += static_cast<long long>(kInFlight) * lanes) {
      uint4 q[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const long long i = j + static_cast<long long>(u) * lanes;
        q[u] = i < nvec ? __ldg(xr + i) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        float v[V];
        Vec<Elem>::cvt(q[u], v);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          a1[k] += v[k];
          a2[k] = fmaf(v[k], v[k], a2[k]);
        }
      }
    }
  }
  // slot k of lane t is channel (t * V + k) % C; where C < V, fold each
  // lane's upper half onto its lower until its C channels are left
#pragma unroll
  for (int h = V / 2; h >= 1; h >>= 1) {
    if (h >= C) {
#pragma unroll
      for (int i = 0; i < h; ++i) {
        a1[i] += a1[i + h];
        a2[i] += a2[i + h];
      }
    }
  }
  // M slots a lane; lane l holds channels (l % P) * M .. + M - 1, and the
  // lanes of a warp with equal l % P meet in a butterfly
  const int M = C < V ? C : V, P = C / M;
  for (int m = P; m < 32; m <<= 1) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (i < M) {
        a1[i] += __shfl_xor_sync(0xffffffffu, a1[i], m);
        a2[i] += __shfl_xor_sync(0xffffffffu, a2[i], m);
      }
    }
  }
  float* s1 = s + row * C;
  float* s2 = s1 + rows * C;
  const int W = lanes / 32;
  if (W == 1) {
    if (row < rows && l < P) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        if (i < M) {
          s1[l * M + i] = a1[i];
          s2[l * M + i] = a2[i];
        }
      }
    }
    return;
  }
  float* q = part + static_cast<size_t>(g) * W * 2 * C;  // this row's warps
  if (l < P) {
    float* p = q + static_cast<size_t>(t / 32) * 2 * C;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (i < M) {
        p[l * M + i] = a1[i];
        p[C + l * M + i] = a2[i];
      }
    }
  }
  __syncthreads();
  if (row < rows) {
    for (int c = t; c < C; c += lanes) {
      float v1 = q[c], v2 = q[C + c];
      for (int w = 1; w < W; ++w) {
        v1 += q[w * 2 * C + c];
        v2 += q[w * 2 * C + C + c];
      }
      s1[c] = v1;
      s2[c] = v2;
    }
  }
}

template <typename Elem, int V>
__global__ void row_moments_slots_kernel(const Elem* __restrict__ x, float* __restrict__ s, long long row_elems,
                                         int C) {
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
    s[row * C + c] = q1[c];
    s[(gridDim.x + row) * C + c] = q2[c];
  }
}

bool pow2(int n) { return n > 0 && (n & (n - 1)) == 0; }

template <typename Elem>
int lane_plan(const void* x, void* s, long long rows, long long row_elems, int C, int vec, int lanes,
              cudaStream_t stream) {
  const int m = C < vec ? C : vec;
  const int block = lanes > kBlock ? lanes : kBlock;
  const size_t smem = lanes > 32 ? sizeof(float) * 2 * C * (block / 32) : 0;
  if (vec != Vec<Elem>::V || row_elems % vec || vec % m || C % m || !pow2(vec / m) || !pow2(C / m) || C / m > 32 ||
      !pow2(lanes) || lanes < 32 || lanes > kMaxLanes || smem > kLaneSmem)
    return kBadShape;
  const long long per_block = block / lanes;
  row_moments_kernel<Elem><<<static_cast<unsigned>((rows + per_block - 1) / per_block), block, smem, stream>>>(
      static_cast<const Elem*>(x), static_cast<float*>(s), rows, row_elems / vec, C, lanes);
  return static_cast<int>(cudaGetLastError());
}

template <typename Elem, int V>
int launch_slots(const void* x, void* s, long long rows, long long row_elems, int C, int threads,
                 cudaStream_t stream) {
  const size_t smem = 2 * sizeof(float) * threads * V;
  row_moments_slots_kernel<Elem, V><<<static_cast<unsigned>(rows), threads, smem, stream>>>(
      static_cast<const Elem*>(x), static_cast<float*>(s), row_elems, C);
  return static_cast<int>(cudaGetLastError());
}

int slot_plan(const void* x, void* s, int dtype, long long rows, long long row_elems, int C, int vec, int threads,
              cudaStream_t st) {
  if (threads > 1024 || (threads * vec) % C || threads * vec > kMaxSlots || row_elems % vec) return kBadShape;
  if (dtype == 0 && vec == 4) return launch_slots<float, 4>(x, s, rows, row_elems, C, threads, st);
  if (dtype == 1 && vec == 8) return launch_slots<__nv_bfloat16, 8>(x, s, rows, row_elems, C, threads, st);
  if (dtype == 2 && vec == 8) return launch_slots<__half, 8>(x, s, rows, row_elems, C, threads, st);
  if (vec != 1) return kBadShape;
  if (dtype == 0) return launch_slots<float, 1>(x, s, rows, row_elems, C, threads, st);
  if (dtype == 1) return launch_slots<__nv_bfloat16, 1>(x, s, rows, row_elems, C, threads, st);
  return launch_slots<__half, 1>(x, s, rows, row_elems, C, threads, st);
}

}  // namespace

extern "C" {

// x: the map as rows x row_elems elements (dtype 0 f32, 1 bf16, 2 f16), its
// address a multiple of 16 bytes; s: [2][rows][C] f32, Sx then Sx^2.
// lane != 0: the lane plan, vec the 16-byte vector's elements, `threads`
// threads a row; lane == 0: the slot plan, vec 1 or the 16-byte vector's
// elements (a row a whole number of them), `threads` the block's threads,
// threads * vec a multiple of C and at most kMaxSlots. Returns 0 or an
// error code.
int posfeat_row_moments(const void* x, void* s, int dtype, long long rows, long long row_elems, int C, int vec,
                        int lane, int threads, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || rows > 0x7fffffffLL || row_elems <= 0 || C <= 0 || row_elems % C || vec <= 0 || threads <= 0)
    return kBadShape;
  if (dtype < 0 || dtype > 2) return kBadDtype;
  if (!lane) return slot_plan(x, s, dtype, rows, row_elems, C, vec, threads, st);
  if (dtype == 0) return lane_plan<float>(x, s, rows, row_elems, C, vec, threads, st);
  if (dtype == 1) return lane_plan<__nv_bfloat16>(x, s, rows, row_elems, C, vec, threads, st);
  return lane_plan<__half>(x, s, rows, row_elems, C, vec, threads, st);
}

const char* posfeat_moments_error_string(int code) {
  switch (code) {
    case kBadShape:
      return "shape or plan outside what the row-moments kernel takes (rows in [1, 2^31), a row a whole number of "
             "channels; the lane plan: 16-byte vectors, C a power of two up to 32 * vec, lanes 32-512; the slot plan: threads * vec a multiple of C and at most 4096)";
    case kBadDtype:
      return "the row-moments kernel takes float32, bfloat16 and float16 maps";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

}  // extern "C"
