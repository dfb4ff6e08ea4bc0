// K5, fused RMSNorm forward: y = x * rsqrt(mean(x^2) + eps) * scale, the
// mean of squares and the product in f32, y cast to x's dtype.
//
// Replaces `_rmsnorm_kernel` / `rmsnorm_2d` of src/repro/kernels/rmsnorm.py.
// Bound on an H100: bytes at prefill rows ((8192, 4096) bf16 reads and
// writes 134 MB: 40 us at 3.35 TB/s); at decode rows ((4, 4096), 64 KB) the
// time is the launch, so the design keeps one pass and the host path short.
//
// Design.  A group of TPR threads (a multiple of 32) owns one row; a block
// holds one or more such groups (blockDim = (TPR, rows per block)).  Each
// thread loads one vector of 16 bytes (8 bf16 / f16, 4 f32; two vectors
// for rows wider than 1024 of them), neighbouring threads on neighbouring
// vectors, together with the matching scale entries, and keeps both in
// registers: the row is read once and written once, and the scale's load
// hides under the row's.  The sum of squares goes through a butterfly of
// warp shuffles, then across the row's warps through shared memory and a
// second butterfly.  A row whose width is not a multiple of the vector,
// or whose base or stride is not 16-byte aligned, takes the scalar path
// with the same register layout.  The data fit 32 registers a thread, so
// an SM holds two blocks of 1024 threads: 2048 threads' loads in flight.
// At decode rows one row per block makes the launch one short pass; at
// prefill rows, narrow rows are packed several to a block.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

// 32-bit component k of a 16-byte word (k known at compile time)
__device__ __forceinline__ uint32_t comp(const uint4& w, int k) {
  return k == 0 ? w.x : k == 1 ? w.y : k == 2 ? w.z : w.w;
}

// element j of a 16-byte word of T, as f32 (bit operations: no word is
// addressed through a pointer, so every word stays in registers)
template <typename T> __device__ __forceinline__ float elem(const uint4&, int);
template <> __device__ __forceinline__ float elem<float>(const uint4& w,
                                                         int j) {
  return __uint_as_float(comp(w, j));
}
template <> __device__ __forceinline__ float elem<__nv_bfloat16>(
    const uint4& w, int j) {
  const uint32_t u = comp(w, j / 2);
  return __uint_as_float(j % 2 ? u & 0xFFFF0000u : u << 16);
}
template <> __device__ __forceinline__ float elem<__half>(const uint4& w,
                                                          int j) {
  const uint32_t u = comp(w, j / 2);
  return __half2float(__ushort_as_half((unsigned short)(j % 2 ? u >> 16
                                                                : u)));
}

// two f32 rounded to T, packed low then high (T of 2 bytes)
template <typename T> __device__ __forceinline__ uint32_t pair(float, float);
template <> __device__ __forceinline__ uint32_t pair<__nv_bfloat16>(float a,
                                                                    float b) {
  return __bfloat16_as_ushort(__float2bfloat16(a)) |
         (uint32_t)__bfloat16_as_ushort(__float2bfloat16(b)) << 16;
}
template <> __device__ __forceinline__ uint32_t pair<__half>(float a,
                                                             float b) {
  return __half_as_ushort(__float2half(a)) |
         (uint32_t)__half_as_ushort(__float2half(b)) << 16;
}

// a 16-byte word of T from 16 / sizeof(T) f32
template <typename T>
__device__ __forceinline__ uint4 word(const float* f) {
  if constexpr (sizeof(T) == 4)
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  else
    return make_uint4(pair<T>(f[0], f[1]), pair<T>(f[2], f[3]),
                      pair<T>(f[4], f[5]), pair<T>(f[6], f[7]));
}

// N scale entries from p as f32: 16-byte loads when the run is whole
// 16-byte words and p is aligned, else one load each
template <typename S, int N>
__device__ __forceinline__ void load_scale(const S* p, float* out,
                                           bool aligned) {
  constexpr int BYTES = N * (int)sizeof(S);
  if constexpr (BYTES % 16 == 0) {
    if (aligned) {
      constexpr int PER = 16 / (int)sizeof(S);
#pragma unroll
      for (int w = 0; w < BYTES / 16; ++w) {
        const uint4 raw = reinterpret_cast<const uint4*>(p)[w];
#pragma unroll
        for (int j = 0; j < PER; ++j) out[w * PER + j] = elem<S>(raw, j);
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) out[j] = to_f32(p[j]);
}

constexpr int MAX_WARPS = 32;     // 1024 threads
// blocks of up to 1024 threads, two of them on an SM when a thread holds
// one vector: 32 registers a thread, so that an SM keeps 2048 threads'
// loads in flight (left to itself, ptxas took more registers, fewer
// threads fit, and the prefill rows ran slower).  A 2-byte row with a
// 2-byte scale spilled at 32 registers: those take what they need.
constexpr int MAX_THREADS = 1024;

template <typename T, typename S, int VPT>
constexpr int min_blocks() {
  return VPT == 1 && (sizeof(T) == 4 || sizeof(S) == 4) ? 2 : 1;
}

template <typename T, typename S, int VPT>
__global__ void __launch_bounds__(MAX_THREADS, min_blocks<T, S, VPT>())
rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
               T* __restrict__ out, int R, int d, int64_t xs, float eps,
               int vec, int vec_scale) {
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int N = VPT * VEC;
  __shared__ float part[MAX_WARPS];
  const int tpr = blockDim.x;
  const int t = threadIdx.x;
  const int lane = t % 32;
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  const bool live = row < R;
  const T* xr = x + (int64_t)row * xs;
  T* orow = out + (int64_t)row * d;         // out is contiguous

  // vector path: the row as loaded (16-byte words in raw) and its scale
  // in f32 (in f), loaded together so that the scale's latency hides under
  // the row's; scalar path: the row in f32 (in f), the scale loaded at the
  // store
  uint4 raw[VPT];
  float f[N];
  float ss = 0.f;
  if (vec) {
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = (i * tpr + t) * VEC;
      raw[i] = make_uint4(0, 0, 0, 0);
      if (live && c < d) {
        raw[i] = *reinterpret_cast<const uint4*>(xr + c);
        load_scale<S, VEC>(scale + c, f + i * VEC, vec_scale);
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float e = elem<T>(raw[i], j);
        ss += e * e;
      }
    }
  } else {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int c = n * tpr + t;
      f[n] = live && c < d ? to_f32(xr[c]) : 0.f;
      ss += f[n] * f[n];
    }
  }
  // the sum of squares: a butterfly over the warp (every lane ends with the
  // same bits: each step adds the same two values in either order), then
  // one partial per warp of the row through shared memory, summed by a
  // second butterfly
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (tpr > 32) {
    const int warps = tpr / 32;
    const int w0 = threadIdx.y * warps;
    if (lane == 0) part[w0 + t / 32] = ss;
    __syncthreads();
    ss = lane < warps ? part[w0 + lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
  }
  if (!live) return;
  const float r = rsqrtf(ss / (float)d + eps);

  if (vec) {
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = (i * tpr + t) * VEC;
      if (c < d) {
        float y[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          y[j] = elem<T>(raw[i], j) * r * f[i * VEC + j];
        *reinterpret_cast<uint4*>(orow + c) = word<T>(y);
      }
    }
  } else {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int c = n * tpr + t;
      if (c < d) orow[c] = from_f32<T>(f[n] * r * to_f32(scale[c]));
    }
  }
}

// the launch shape: one vector per thread while 1024 threads hold the row
// (two above that), one row per block; from MANY_ROWS rows on (prefill),
// narrow rows are packed ROWS_BLOCK threads to a block
constexpr int MANY_ROWS = 1024;
constexpr int ROWS_BLOCK = 512;

template <typename T, typename S, int VPT>
int launch_vpt(const void* x, const void* scale, void* out, int R, int d,
               int64_t xs, float eps, int vec, int vec_scale, int tpr,
               cudaStream_t stream) {
  const int rows = R < MANY_ROWS || tpr >= ROWS_BLOCK ? 1 : ROWS_BLOCK / tpr;
  const dim3 block(tpr, rows);
  const int grid = (R + rows - 1) / rows;
  rmsnorm_kernel<T, S, VPT><<<grid, block, 0, stream>>>(
      (const T*)x, (const S*)scale, (T*)out, R, d, xs, eps, vec, vec_scale);
  return (int)cudaGetLastError();
}

template <typename T, typename S>
int launch(const void* x, const void* scale, void* out, int R, int d,
           int64_t xs, float eps, cudaStream_t stream) {
  constexpr int VEC = 16 / (int)sizeof(T);
  const auto a16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec = d % VEC == 0 && a16(x) && a16(out) &&
                  (xs * (int64_t)sizeof(T)) % 16 == 0;
  const int vec_scale = a16(scale);
  const int units = (d + VEC - 1) / VEC;          // vectors per row
  const int vpt = units <= MAX_THREADS ? 1 : 2;
  if (units > 2 * MAX_THREADS) return (int)cudaErrorInvalidValue;
  const int tpr = ((units + vpt - 1) / vpt + 31) / 32 * 32;
  return vpt == 1 ? launch_vpt<T, S, 1>(x, scale, out, R, d, xs, eps, vec,
                                        vec_scale, tpr, stream)
                  : launch_vpt<T, S, 2>(x, scale, out, R, d, xs, eps, vec,
                                        vec_scale, tpr, stream);
}

template <typename T>
int launch_t(const void* x, const void* scale, void* out, int R, int d,
             int64_t xs, float eps, int s_dtype, cudaStream_t stream) {
  switch (s_dtype) {
    case 0:
      return launch<T, float>(x, scale, out, R, d, xs, eps, stream);
    case 1:
      return launch<T, __nv_bfloat16>(x, scale, out, R, d, xs, eps, stream);
    case 2:
      return launch<T, __half>(x, scale, out, R, d, xs, eps, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x (R, d) with row stride xs elements, d contiguous, d at most 2048
// vectors of 16 bytes (16384 bf16 / f16, 8192 f32); out (R, d)
// contiguous; scale (d,) contiguous.  Dtype codes 0 f32, 1 bf16, 2 f16 (x
// and out share one).  Returns a cudaError_t.
extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* out,
                           int R, int d, int64_t xs, float eps, int x_dtype,
                           int s_dtype, void* stream) {
  if (d <= 0) return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (x_dtype) {
    case 0:
      return launch_t<float>(x, scale, out, R, d, xs, eps, s_dtype, s);
    case 1:
      return launch_t<__nv_bfloat16>(x, scale, out, R, d, xs, eps, s_dtype,
                                     s);
    case 2:
      return launch_t<__half>(x, scale, out, R, d, xs, eps, s_dtype, s);
  }
  return (int)cudaErrorInvalidValue;
}
