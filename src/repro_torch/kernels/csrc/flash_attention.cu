// K2, flash-attention forward: o = softmax(q k^T * scale [soft-cap, masks]) v
// and the per-row lse, with the score matrix never leaving shared memory.
//
// Replaces `_fa_kernel` / `flash_attention_fwd_bhsd` of
// src/repro/kernels/flash_attention.py.  The TPU kernel walks a (B, H, nQ,
// nK) grid in order and carries (m, l, acc) across the nK axis in VMEM
// scratch; Hopper runs blocks in parallel and in no order, so here one
// block owns one (b*h, 64-row q tile) and a loop over 32-key tiles takes the
// place of the nK axis, with m and l in shared memory and acc in registers.
// Tiles wholly masked by causal or window for every row of the block are
// skipped; ragged edges (S not a multiple of the tile) are masked here.
//
// Numerics follow the TPU kernel: q is cast to f32 BEFORE the scale, scores
// and the accumulator are f32, masked scores are the finite -1e30 (so a row
// that meets a wholly masked tile first matches the reference), and
// lse = m + log(max(l, 1e-30)).  GQA: KV head h / (H / Hkv) is read
// directly, which equals expanding the KV heads first.
//
// Bound: at prefill lengths the work (4*B*H*Sq*Sk_eff*D operations) bounds
// it; this first version runs the products on the CUDA cores in f32 (one
// code path for bf16 and f32 inputs, exact f32 accumulation) and is far
// from the bf16 tensor-core rate: wgmma/TMA tiles are later work.  The
// (B, H, S, D) inputs are addressed through strides, so the model's
// (B, S, H, D) tensors need no transpose copy.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;            // query rows per block
constexpr int BK = 32;            // keys per tile
constexpr int NT = 256;           // threads per block
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

struct Strides {                  // element strides of (B, H, S, D), D = 1
  int64_t qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

template <int D>
constexpr size_t smem_floats() {
  return (size_t)BQ * (D + 1) + (size_t)BK * (D + 1) + (size_t)BK * D +
         (size_t)BQ * (BK + 1) + 3 * BQ;
}

template <int D, typename T>
__global__ void __launch_bounds__(NT)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o,
              float* __restrict__ lse, int H, int Hkv, int Sq, int Sk,
              Strides st, float scale, int causal, int window, float cap) {
  extern __shared__ float smem[];
  constexpr int DP = D + 1;       // padded rows: conflict-free column reads
  constexpr int PP = BK + 1;
  constexpr int CW = D / 16;      // output columns per thread
  float* Qs = smem;
  float* Ks = Qs + BQ * DP;
  float* Vs = Ks + BK * DP;
  float* Ps = Vs + BK * D;
  float* m_s = Ps + BQ * PP;
  float* l_s = m_s + BQ;
  float* a_s = l_s + BQ;

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.x * BQ;
  const T* qp = q + b * st.qb + h * st.qh;
  const T* kp = k + b * st.kb + hk * st.kh;
  const T* vp = v + b * st.vb + hk * st.vh;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D, qi = q0 + r;
    Qs[r * DP + c] = qi < Sq ? to_f32(qp[(int64_t)qi * st.qs + c]) * scale
                             : 0.f;
  }
  for (int r = tid; r < BQ; r += NT) {
    m_s[r] = NEG_BIG;
    l_s[r] = 0.f;
  }

  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin = (k_begin / BK) * BK;

  const int sr = (tid / 8) * 2;   // scores: rows sr, sr+1
  const int sc = (tid % 8) * 4;   //         cols sc..sc+3
  const int xr = tid / 4;         // softmax: row xr, cols xp*8..xp*8+7
  const int xp = tid % 4;
  const int orow = (tid / 16) * 4;  // output: rows orow..orow+3,
  const int ocol = tid % 16;        //         cols ocol + 16*j
  float acc[4][CW];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < CW; ++j) acc[r][j] = 0.f;
  __syncthreads();

  for (int kt = k_begin; kt < k_end; kt += BK) {
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D, kj = kt + r;
      const bool ok = kj < Sk;
      Ks[r * DP + c] = ok ? to_f32(kp[(int64_t)kj * st.ks + c]) : 0.f;
      Vs[r * D + c] = ok ? to_f32(vp[(int64_t)kj * st.vs + c]) : 0.f;
    }
    __syncthreads();

    float s[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float a0 = Qs[sr * DP + d], a1 = Qs[(sr + 1) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float kk = Ks[(sc + j) * DP + d];
        s[0][j] = fmaf(a0, kk, s[0][j]);
        s[1][j] = fmaf(a1, kk, s[1][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = q0 + sr + i, kj = kt + sc + j;
        float x = s[i][j];
        if (cap > 0.f) x = cap * tanhf(x / cap);
        bool allow = true;
        if (causal) allow = allow && kj <= qi;
        if (window > 0) allow = allow && (qi - kj) < window;
        x = allow ? x : NEG_BIG;
        if (kj >= Sk) x = -INFINITY;  // past the sequence: not a key at all
        Ps[(sr + i) * PP + sc + j] = x;
      }
    __syncthreads();

    {
      float* prow = Ps + xr * PP + xp * 8;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, prow[j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[xr];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float e = prow[j] == -INFINITY ? 0.f : expf(prow[j] - m_new);
        prow[j] = e;
        sum += e;
      }
      // the shuffles also order every lane's m_s read before the write
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (xp == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[xr] = alpha;
        l_s[xr] = l_s[xr] * alpha + sum;
        m_s[xr] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float al = a_s[orow + r];
#pragma unroll
      for (int j = 0; j < CW; ++j) acc[r][j] *= al;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) p[r] = Ps[(orow + r) * PP + kk];
#pragma unroll
      for (int j = 0; j < CW; ++j) {
        const float vv = Vs[kk * D + ocol + 16 * j];
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][j] = fmaf(p[r], vv, acc[r][j]);
      }
    }
    __syncthreads();
  }

  T* op = o + b * st.ob + h * st.oh;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = orow + r, qi = q0 + row;
    if (qi < Sq) {
      const float l = fmaxf(l_s[row], 1e-30f);
#pragma unroll
      for (int j = 0; j < CW; ++j)
        op[(int64_t)qi * st.os + ocol + 16 * j] = from_f32<T>(acc[r][j] / l);
    }
  }
  for (int r = tid; r < BQ; r += NT) {
    const int qi = q0 + r;
    if (qi < Sq)
      lse[(int64_t)bh * Sq + qi] = m_s[r] + logf(fmaxf(l_s[r], 1e-30f));
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int H, int Hkv, int Sq, int Sk, const Strides& st,
           float scale, int causal, int window, float cap,
           cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  fa_fwd_kernel<D, T><<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, H, Hkv, Sq,
      Sk, st, scale, causal, window, cap);
  return (int)cudaGetLastError();
}

}  // namespace

// strides: 12 element strides (q, k, v, o) x (b, h, s); lse is (B, H, Sq)
// contiguous f32.  Returns a cudaError_t (0 = launched).
extern "C" int fa_fwd(const void* q, const void* k, const void* v, void* o,
                      void* lse, int B, int H, int Hkv, int Sq, int Sk, int D,
                      const int64_t* strides, float scale, int causal,
                      int window, float cap, int is_bf16, void* stream) {
  const Strides st{strides[0], strides[1], strides[2],  strides[3],
                   strides[4], strides[5], strides[6],  strides[7],
                   strides[8], strides[9], strides[10], strides[11]};
  cudaStream_t s = (cudaStream_t)stream;
#define FA_CASE(DD)                                                          \
  if (D == DD)                                                               \
    return is_bf16 ? launch<DD, __nv_bfloat16>(q, k, v, o, lse, B, H, Hkv,  \
                                               Sq, Sk, st, scale, causal,    \
                                               window, cap, s)               \
                   : launch<DD, float>(q, k, v, o, lse, B, H, Hkv, Sq, Sk,   \
                                       st, scale, causal, window, cap, s);
  FA_CASE(32)
  FA_CASE(64)
  FA_CASE(128)
#undef FA_CASE
  return (int)cudaErrorInvalidValue;
}
