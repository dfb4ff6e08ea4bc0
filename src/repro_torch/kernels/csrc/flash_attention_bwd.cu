// K3a / K3b, flash-attention backward: dq, and dk with dv, from q, k, v,
// dO, the forward's per-row lse and delta = rowsum(dO * o), with the
// probabilities recomputed on chip and never stored.
//
// Replaces `_fa_dq_kernel` and `_fa_dkv_kernel` / `flash_attention_bwd_bhsd`
// of src/repro/kernels/flash_attention.py.  The TPU kernels walk a
// sequential grid axis and carry their sums in VMEM scratch; here the same
// split is kept, because it needs no atomics and so stays deterministic:
//   K3a (fa_dq_kernel)  one block per (b*h, 64-row q tile), a loop over
//                       32-key tiles; dq = scale * sum_k dS K.
//   K3b (fa_dkv_kernel) one block per (b*hkv, 64-key tile), a loop over
//                       the kv head's q heads (GQA: in a fixed order) and,
//                       for each, over 32-row q tiles; dv = sum P^T dO,
//                       dk = sum dS^T (q * scale).
// Each block recomputes p = exp(s - lse) from (q, k, lse), with masked
// scores at the finite -1e30 as in K2 and the reference, and
// dS = p * (dP - delta), dP = dO V^T.  Tiles that causal or window mask
// for the whole block are skipped; ragged edges are masked here.  Every
// sum runs in one fixed order, so a result is the same on every run.
//
// Bound: operations (8*B*H*D per unmasked query-key pair in the two
// kernels together, plus the 4*B*H*D of the recomputed scores in each),
// against 989 TFLOP/s bf16.  These kernels compute in f32 on the CUDA cores,
// far from that bound: they are the exact route that f32 inputs take (the
// f32 parity checks need it).  bf16 inputs, the serve and train paths'
// dtype, take the tensor-core kernels instead: flash_attention_dq_sm90.cu
// (K3a) and flash_attention_bwd_sm90.cu (K3b); the bf16 instantiations here
// stay callable by name for timing beside them.  Inputs are addressed
// through strides, so the model's (B, S, H, D) tensors need no transpose
// copy.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;           // threads per block
constexpr int QB = 64;            // K3a: query rows per block
constexpr int KB = 32;            // K3a: keys per tile
constexpr int KB2 = 64;           // K3b: keys per block
constexpr int QB2 = 32;           // K3b: query rows per tile
constexpr float NEG_BIG = -1.0e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct S3 { int64_t b, h, s; };   // element strides of (B, H, S, D), D = 1
struct Strides { S3 q, k, v, d_o, dq, dk, dv; };

__device__ __forceinline__ bool allowed(int qi, int kj, int causal,
                                        int window) {
  bool ok = true;
  if (causal) ok = ok && kj <= qi;
  if (window > 0) ok = ok && (qi - kj) < window;
  return ok;
}

template <int D>
constexpr size_t dq_smem_floats() {
  return 2 * (size_t)QB * (D + 1) + 2 * (size_t)KB * (D + 1) +
         (size_t)QB * (KB + 1) + 2 * QB;
}

template <int D>
constexpr size_t dkv_smem_floats() {
  return 2 * (size_t)KB2 * (D + 1) + 2 * (size_t)QB2 * (D + 1) +
         2 * (size_t)KB2 * (QB2 + 1) + 2 * QB2;
}

// K3a: dq for one (b*h, q tile)
template <int D, typename T>
__global__ void __launch_bounds__(NT)
fa_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ d_o,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dq, int H, int Hkv, int Sq, int Sk, Strides st,
             float scale, int causal, int window) {
  extern __shared__ float smem[];
  constexpr int DP = D + 1;
  constexpr int PP = KB + 1;
  constexpr int CW = D / 16;
  float* Qs = smem;               // q * scale
  float* Os = Qs + QB * DP;       // dO
  float* Ks = Os + QB * DP;
  float* Vs = Ks + KB * DP;
  float* Ss = Vs + KB * DP;       // dS of the tile
  float* lse_s = Ss + QB * PP;
  float* del_s = lse_s + QB;

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * QB;
  const T* qp = q + b * st.q.b + h * st.q.h;
  const T* op = d_o + b * st.d_o.b + h * st.d_o.h;
  const T* kp = k + b * st.k.b + hk * st.k.h;
  const T* vp = v + b * st.v.b + hk * st.v.h;

  for (int i = tid; i < QB * D; i += NT) {
    const int r = i / D, c = i % D, qi = q0 + r;
    const bool ok = qi < Sq;
    Qs[r * DP + c] = ok ? to_f32(qp[(int64_t)qi * st.q.s + c]) * scale : 0.f;
    Os[r * DP + c] = ok ? to_f32(op[(int64_t)qi * st.d_o.s + c]) : 0.f;
  }
  for (int r = tid; r < QB; r += NT) {
    const int qi = q0 + r;
    lse_s[r] = qi < Sq ? lse[(int64_t)bh * Sq + qi] : 0.f;
    del_s[r] = qi < Sq ? delta[(int64_t)bh * Sq + qi] : 0.f;
  }

  const int q_last = min(q0 + QB, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin = (k_begin / KB) * KB;

  const int sr = (tid / 8) * 2;   // scores: rows sr, sr+1
  const int sc = (tid % 8) * 4;   //         cols sc..sc+3
  const int orow = (tid / 16) * 4;  // dq: rows orow..orow+3,
  const int ocol = tid % 16;        //     cols ocol + 16*j
  float acc[4][CW];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < CW; ++j) acc[r][j] = 0.f;
  __syncthreads();

  for (int kt = k_begin; kt < k_end; kt += KB) {
    for (int i = tid; i < KB * D; i += NT) {
      const int r = i / D, c = i % D, kj = kt + r;
      const bool ok = kj < Sk;
      Ks[r * DP + c] = ok ? to_f32(kp[(int64_t)kj * st.k.s + c]) : 0.f;
      Vs[r * DP + c] = ok ? to_f32(vp[(int64_t)kj * st.v.s + c]) : 0.f;
    }
    __syncthreads();

    float s[2][4], dp[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float a0 = Qs[sr * DP + d], a1 = Qs[(sr + 1) * DP + d];
      const float o0 = Os[sr * DP + d], o1 = Os[(sr + 1) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float kk = Ks[(sc + j) * DP + d];
        const float vv = Vs[(sc + j) * DP + d];
        s[0][j] = fmaf(a0, kk, s[0][j]);
        s[1][j] = fmaf(a1, kk, s[1][j]);
        dp[0][j] = fmaf(o0, vv, dp[0][j]);
        dp[1][j] = fmaf(o1, vv, dp[1][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = sr + i, qi = q0 + r, kj = kt + sc + j;
        const float x = allowed(qi, kj, causal, window) ? s[i][j] : NEG_BIG;
        const float p = (qi < Sq && kj < Sk) ? expf(x - lse_s[r]) : 0.f;
        Ss[r * PP + sc + j] = p * (dp[i][j] - del_s[r]);
      }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < KB; ++kk) {
      float ds[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) ds[r] = Ss[(orow + r) * PP + kk];
#pragma unroll
      for (int j = 0; j < CW; ++j) {
        const float kv = Ks[kk * DP + ocol + 16 * j];
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][j] = fmaf(ds[r], kv, acc[r][j]);
      }
    }
    __syncthreads();
  }

  T* dqp = dq + b * st.dq.b + h * st.dq.h;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + orow + r;
    if (qi < Sq) {
#pragma unroll
      for (int j = 0; j < CW; ++j)
        dqp[(int64_t)qi * st.dq.s + ocol + 16 * j] =
            from_f32<T>(acc[r][j] * scale);
    }
  }
}

// K3b: dk and dv for one (b*hkv, key tile), summed over the kv head's q
// heads in order
template <int D, typename T>
__global__ void __launch_bounds__(NT)
fa_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ d_o,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dk, T* __restrict__ dv, int H, int Hkv, int Sq,
              int Sk, Strides st, float scale, int causal, int window) {
  extern __shared__ float smem[];
  constexpr int DP = D + 1;
  constexpr int PP = QB2 + 1;
  constexpr int CW = D / 16;
  float* Ks = smem;
  float* Vs = Ks + KB2 * DP;
  float* Qs = Vs + KB2 * DP;      // q * scale
  float* Os = Qs + QB2 * DP;      // dO
  float* Pt = Os + QB2 * DP;      // P^T of the tile (keys x queries)
  float* St = Pt + KB2 * PP;      // dS^T
  float* lse_s = St + KB2 * PP;
  float* del_s = lse_s + QB2;

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / Hkv, hk = bh % Hkv;
  const int rep = H / Hkv;
  const int k0 = blockIdx.x * KB2;
  const T* kp = k + b * st.k.b + hk * st.k.h;
  const T* vp = v + b * st.v.b + hk * st.v.h;

  for (int i = tid; i < KB2 * D; i += NT) {
    const int r = i / D, c = i % D, kj = k0 + r;
    const bool ok = kj < Sk;
    Ks[r * DP + c] = ok ? to_f32(kp[(int64_t)kj * st.k.s + c]) : 0.f;
    Vs[r * DP + c] = ok ? to_f32(vp[(int64_t)kj * st.v.s + c]) : 0.f;
  }

  const int k_last = min(k0 + KB2, Sk) - 1;
  const int q_begin = causal ? (k0 / QB2) * QB2 : 0;
  const int q_end = window > 0 ? min(Sq, k_last + window) : Sq;

  const int sr = (tid / 8) * 2;   // scores: key rows sr, sr+1
  const int sc = (tid % 8) * 4;   //         query cols sc..sc+3
  const int orow = (tid / 16) * 4;  // dk/dv: key rows orow..orow+3,
  const int ocol = tid % 16;        //        cols ocol + 16*j
  float dk_acc[4][CW], dv_acc[4][CW];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < CW; ++j) dk_acc[r][j] = dv_acc[r][j] = 0.f;

  for (int hh = 0; hh < rep; ++hh) {
    const int h = hk * rep + hh;
    const int64_t row0 = ((int64_t)b * H + h) * Sq;
    const T* qp = q + b * st.q.b + h * st.q.h;
    const T* op = d_o + b * st.d_o.b + h * st.d_o.h;
    for (int qt = q_begin; qt < q_end; qt += QB2) {
      __syncthreads();            // the previous tile's readers are done
      for (int i = tid; i < QB2 * D; i += NT) {
        const int r = i / D, c = i % D, qi = qt + r;
        const bool ok = qi < Sq;
        Qs[r * DP + c] =
            ok ? to_f32(qp[(int64_t)qi * st.q.s + c]) * scale : 0.f;
        Os[r * DP + c] = ok ? to_f32(op[(int64_t)qi * st.d_o.s + c]) : 0.f;
      }
      for (int r = tid; r < QB2; r += NT) {
        const int qi = qt + r;
        lse_s[r] = qi < Sq ? lse[row0 + qi] : 0.f;
        del_s[r] = qi < Sq ? delta[row0 + qi] : 0.f;
      }
      __syncthreads();

      float s[2][4], dp[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float k0v = Ks[sr * DP + d], k1v = Ks[(sr + 1) * DP + d];
        const float v0 = Vs[sr * DP + d], v1 = Vs[(sr + 1) * DP + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float qq = Qs[(sc + j) * DP + d];
          const float oo = Os[(sc + j) * DP + d];
          s[0][j] = fmaf(k0v, qq, s[0][j]);
          s[1][j] = fmaf(k1v, qq, s[1][j]);
          dp[0][j] = fmaf(v0, oo, dp[0][j]);
          dp[1][j] = fmaf(v1, oo, dp[1][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kj = k0 + sr + i, c = sc + j, qi = qt + c;
          const float x =
              allowed(qi, kj, causal, window) ? s[i][j] : NEG_BIG;
          const float p = (qi < Sq && kj < Sk) ? expf(x - lse_s[c]) : 0.f;
          Pt[(sr + i) * PP + c] = p;
          St[(sr + i) * PP + c] = p * (dp[i][j] - del_s[c]);
        }
      __syncthreads();

#pragma unroll 4
      for (int qq = 0; qq < QB2; ++qq) {
        float pr[4], dr[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pr[r] = Pt[(orow + r) * PP + qq];
          dr[r] = St[(orow + r) * PP + qq];
        }
#pragma unroll
        for (int j = 0; j < CW; ++j) {
          const float o = Os[qq * DP + ocol + 16 * j];
          const float qv = Qs[qq * DP + ocol + 16 * j];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            dv_acc[r][j] = fmaf(pr[r], o, dv_acc[r][j]);
            dk_acc[r][j] = fmaf(dr[r], qv, dk_acc[r][j]);
          }
        }
      }
    }
  }

  T* dkp = dk + b * st.dk.b + hk * st.dk.h;
  T* dvp = dv + b * st.dv.b + hk * st.dv.h;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int kj = k0 + orow + r;
    if (kj < Sk) {
#pragma unroll
      for (int j = 0; j < CW; ++j) {
        dkp[(int64_t)kj * st.dk.s + ocol + 16 * j] = from_f32<T>(dk_acc[r][j]);
        dvp[(int64_t)kj * st.dv.s + ocol + 16 * j] = from_f32<T>(dv_acc[r][j]);
      }
    }
  }
}

Strides unpack(const int64_t* s) {
  Strides st;
  S3* out[7] = {&st.q, &st.k, &st.v, &st.d_o, &st.dq, &st.dk, &st.dv};
  for (int i = 0; i < 7; ++i) *out[i] = S3{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
  return st;
}

template <int D, typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* d_o,
              const void* lse, const void* delta, void* dq, int B, int H,
              int Hkv, int Sq, int Sk, const Strides& st, float scale,
              int causal, int window, cudaStream_t stream) {
  const size_t smem = dq_smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fa_dq_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + QB - 1) / QB, B * H);
  fa_dq_kernel<D, T><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)d_o,
      (const float*)lse, (const float*)delta, (T*)dq, H, Hkv, Sq, Sk, st,
      scale, causal, window);
  return (int)cudaGetLastError();
}

template <int D, typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* d_o,
               const void* lse, const void* delta, void* dk, void* dv, int B,
               int H, int Hkv, int Sq, int Sk, const Strides& st,
               float scale, int causal, int window, cudaStream_t stream) {
  const size_t smem = dkv_smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fa_dkv_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sk + KB2 - 1) / KB2, B * Hkv);
  fa_dkv_kernel<D, T><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)d_o,
      (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, H, Hkv, Sq,
      Sk, st, scale, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

// strides: 21 element strides, (q, k, v, dO, dq, dk, dv) x (b, h, s); lse
// and delta are (B, H, Sq) contiguous f32.  Return a cudaError_t.
extern "C" int fa_bwd_dq(const void* q, const void* k, const void* v,
                         const void* d_o, const void* lse, const void* delta,
                         void* dq, int B, int H, int Hkv, int Sq, int Sk,
                         int D, const int64_t* strides, float scale,
                         int causal, int window, int is_bf16, void* stream) {
  const Strides st = unpack(strides);
  cudaStream_t s = (cudaStream_t)stream;
#define DQ_CASE(DD)                                                          \
  if (D == DD)                                                               \
    return is_bf16                                                           \
        ? launch_dq<DD, __nv_bfloat16>(q, k, v, d_o, lse, delta, dq, B, H,   \
                                       Hkv, Sq, Sk, st, scale, causal,       \
                                       window, s)                            \
        : launch_dq<DD, float>(q, k, v, d_o, lse, delta, dq, B, H, Hkv, Sq,  \
                               Sk, st, scale, causal, window, s);
  DQ_CASE(32)
  DQ_CASE(64)
  DQ_CASE(128)
#undef DQ_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" int fa_bwd_dkv(const void* q, const void* k, const void* v,
                          const void* d_o, const void* lse,
                          const void* delta, void* dk, void* dv, int B, int H,
                          int Hkv, int Sq, int Sk, int D,
                          const int64_t* strides, float scale, int causal,
                          int window, int is_bf16, void* stream) {
  const Strides st = unpack(strides);
  cudaStream_t s = (cudaStream_t)stream;
#define DKV_CASE(DD)                                                         \
  if (D == DD)                                                               \
    return is_bf16                                                           \
        ? launch_dkv<DD, __nv_bfloat16>(q, k, v, d_o, lse, delta, dk, dv, B, \
                                        H, Hkv, Sq, Sk, st, scale, causal,   \
                                        window, s)                           \
        : launch_dkv<DD, float>(q, k, v, d_o, lse, delta, dk, dv, B, H, Hkv, \
                                Sq, Sk, st, scale, causal, window, s);
  DKV_CASE(32)
  DKV_CASE(64)
  DKV_CASE(128)
#undef DKV_CASE
  return (int)cudaErrorInvalidValue;
}
