// K2, flash-attention forward, bf16 route: o = softmax(q k^T * scale
// [soft-cap, masks]) v and the per-row lse, with the products on Hopper's
// tensor cores (wgmma) and the tiles brought in by TMA.
//
// Replaces `_fa_kernel` / `flash_attention_fwd_bhsd` of
// src/repro/kernels/flash_attention.py for bf16 inputs; f32 inputs keep the
// exact CUDA-core kernel (flash_attention.cu).  What it computes is that
// kernel's: o and the f32 lse = m + log(max(l, 1e-30)); causal, window and
// soft cap; GQA with KV head h / (H / Hkv) read directly; masked scores at
// the finite -1e30 (keys past the sequence at -inf); inputs and output
// addressed through the strides of the model's (B, S, H, D) tensors.
//
// Design.  One block per (b*h, 128-row q tile), q tiles issued longest
// first under causal masking.  Thread 0 loads the q tile and keeps a ring
// of STAGES (k, v) tiles of BK keys in flight through TMA, each signalled by
// its own mbarrier, refilling a slot as soon as both warpgroups have
// released it.  The two warpgroups own 64 q rows each:
//   S = Q K^T        wgmma, A = Q and B = K from shared memory (K-major),
//                    f32 accumulator;
//   online softmax   on the accumulator fragments, each row's max from a
//                    quad shuffle, its sum kept per thread until the end;
//   O += P V         P rounded to bf16 in registers as wgmma's A operand,
//                    B = V from shared memory (MN-major: the transpose bit).
// Per-element masks run only on tiles that need them (the diagonal, window
// edges, keys past the sequence); tiles every row of the block masks are
// never loaded.  There is no producer warp: a ninth warp would put three
// warps on one quarter of the register file and cap every thread at 168
// registers.  Without it, D = 128 (BK = 128) has up to 255 registers for
// the two 64 x 128 f32 accumulators and P, and D <= 64 (BK = 64) fits 128
// registers, so that two blocks share an SM and one block's loads and
// softmax overlap the other's products.  o is stored from registers, rows
// past the sequence clipped; TMA zero-fills rows past the tensor's end.
//
// Numerics against the plain version (q cast to f32, scaled, f32 products):
// the score is (q . k) * scale, the scale applied to the f32 accumulator
// after the product.  For D = 64 the scale is 2^-3 and the two agree
// exactly; for D = 32 and 128 they differ by one f32 rounding.  P is rounded
// to bf16 before P V (SDPA's flash path does the same); l sums the unrounded
// f32 p.  Bound: operations (4*D per unmasked query-key pair) against
// 989 TFLOP/s bf16 at prefill lengths.
#include "sm90.cuh"

#include <math.h>

namespace {

using namespace sm90;

constexpr int BQ = 128;           // q rows per block (64 per warpgroup)
constexpr int STAGES = 2;         // (k, v) tiles in flight
constexpr int THREADS = 256;      // two warpgroups

template <int D>
__host__ __device__ constexpr int block_k() { return D == 128 ? 128 : 64; }
template <int D>
__host__ __device__ constexpr int blocks_per_sm() { return D == 128 ? 1 : 2; }

struct Args {
  __nv_bfloat16* o;
  float* lse;
  int64_t ob, oh, os;             // o's element strides (b, h, s)
  int H, Hkv, Sq, Sk;
  float scale;
  int causal, window;
  float cap;
};

template <int D>
constexpr int smem_bytes() {
  return 1024 + Tile<D, BQ>::BYTES +
         2 * STAGES * Tile<D, block_k<D>()>::BYTES + (1 + 3 * STAGES) * 8;
}

template <int D>
__global__ void __launch_bounds__(THREADS, blocks_per_sm<D>())
fa_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const Args a) {
  constexpr int BK = block_k<D>();
  using TQ = Tile<D, BQ>;
  using TK = Tile<D, BK>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align1024(smem_raw);
  uint8_t* sK = sQ + TQ::BYTES;
  uint8_t* sV = sK + STAGES * TK::BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + STAGES * TK::BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  const int n_q = (a.Sq + BQ - 1) / BQ;
  const int q0 = (n_q - 1 - (int)blockIdx.x) * BQ;   // longest first
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int hk = h / (a.H / a.Hkv);
  const int q_last = min(q0 + BQ, a.Sq) - 1;
  const int k_end = a.causal ? min(a.Sk, q_last + 1) : a.Sk;
  const int k_begin =
      (a.window > 0 ? max(0, q0 - a.window + 1) : 0) / BK * BK;
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], 256);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // thread 0 fills slot i % STAGES, free by then, with k/v tile i
  const auto load_kv = [&](int i) {
    const int s = i % STAGES;
    const int kt = k_begin + i * BK;
    mbar_expect_tx(&k_full[s], TK::BYTES);
    TK::load(sK + s * TK::BYTES, &tk, &k_full[s], kt, hk, b);
    mbar_expect_tx(&v_full[s], TK::BYTES);
    TK::load(sV + s * TK::BYTES, &tv, &v_full[s], kt, hk, b);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(q_full, TQ::BYTES);
    TQ::load(sQ, &tq, q_full, q0, h, b);
    for (int i = 0; i < min(STAGES, n_tiles); ++i) load_kv(i);
  }
  __syncwarp();

  const int c = threadIdx.x / 128;                  // warpgroup
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int r0 = q0 + c * 64;                       // its first q row
  const int row_lo = r0 + (t / 32) * 16 + lane / 4, row_hi = row_lo + 8;
  const int col0 = 2 * (lane % 4);
  const uint32_t q_addr = smem_u32(sQ);

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_lo = NEG_BIG, m_hi = NEG_BIG, l_lo = 0.f, l_hi = 0.f;

  mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES;
    const uint32_t ph = (i / STAGES) & 1;
    const int kt = k_begin + i * BK;
    const uint32_t k_addr = smem_u32(sK + s * TK::BYTES);
    const uint32_t v_addr = smem_u32(sV + s * TK::BYTES);

    float sc[BK / 2];
    mbar_wait(&k_full[s], ph);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<BK>::template ss<0>(sc, TQ::kmajor(q_addr, c * 64, kk),
                                TK::kmajor(k_addr, 0, kk), kk > 0);
    wg_commit();
    wg_wait_all();
    fence_regs<BK / 2>(sc);

    const bool edge = (a.causal && kt + BK - 1 > r0) ||
                      (a.window > 0 && r0 + 63 - kt >= a.window) ||
                      kt + BK > a.Sk;
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * j + e] * a.scale;
        if (a.cap > 0.f) x = a.cap * tanhf(x / a.cap);
        if (edge) {
          const int qi = e < 2 ? row_lo : row_hi;
          const int kj = kt + 8 * j + col0 + (e & 1);
          bool allow = true;
          if (a.causal) allow = allow && kj <= qi;
          if (a.window > 0) allow = allow && (qi - kj) < a.window;
          x = allow ? x : NEG_BIG;
          if (kj >= a.Sk) x = -INFINITY;      // not a key at all
        }
        sc[4 * j + e] = x;
        if (e < 2) mx_lo = fmaxf(mx_lo, x);
        else mx_hi = fmaxf(mx_hi, x);
      }
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float al_lo = exp2f((m_lo - mn_lo) * LOG2E);
    const float al_hi = exp2f((m_hi - mn_hi) * LOG2E);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f((sc[4 * j + e] - (e < 2 ? mn_lo : mn_hi)) *
                              LOG2E);
        sc[4 * j + e] = p;
        if (e < 2) sum_lo += p;
        else sum_hi += p;
      }
    l_lo = l_lo * al_lo + sum_lo;
    l_hi = l_hi * al_hi + sum_hi;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j + 0] *= al_lo;
      o[4 * j + 1] *= al_lo;
      o[4 * j + 2] *= al_hi;
      o[4 * j + 3] *= al_hi;
    }
    uint32_t pa[BK / 16][4];
    acc_to_a<BK>(sc, pa);

    mbar_wait(&v_full[s], ph);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      Wgmma<D>::template rs<1>(o, pa[kk], TK::mnmajor(v_addr, kk), 1);
    wg_commit();
    wg_wait_all();
    fence_regs<D / 2>(o);
    mbar_arrive(&empty[s]);
    if (threadIdx.x == 0 && i + STAGES < n_tiles) {
      mbar_wait(&empty[s], (i / STAGES) & 1);
      load_kv(i + STAGES);
    }
    __syncwarp();                 // warp 0 whole again before the wgmma
  }

  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  l_lo = fmaxf(l_lo, 1e-30f);
  l_hi = fmaxf(l_hi, 1e-30f);
  __nv_bfloat16* op = a.o + b * a.ob + h * a.oh;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + col0;
    if (row_lo < a.Sq)
      *reinterpret_cast<uint32_t*>(op + (int64_t)row_lo * a.os + col) =
          pack_bf16(o[4 * j] / l_lo, o[4 * j + 1] / l_lo);
    if (row_hi < a.Sq)
      *reinterpret_cast<uint32_t*>(op + (int64_t)row_hi * a.os + col) =
          pack_bf16(o[4 * j + 2] / l_hi, o[4 * j + 3] / l_hi);
  }
  if (lane % 4 == 0) {
    float* lp = a.lse + (int64_t)bh * a.Sq;
    if (row_lo < a.Sq) lp[row_lo] = m_lo + logf(l_lo);
    if (row_hi < a.Sq) lp[row_hi] = m_hi + logf(l_hi);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int H, int Hkv, int Sq, int Sk, const int64_t* st,
           float scale, int causal, int window, float cap,
           cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = encode_bhsd(&tq, q, B, H, Sq, D, st[0], st[1], st[2], BQ);
  constexpr int BK = block_k<D>();
  if (!err) err = encode_bhsd(&tk, k, B, Hkv, Sk, D, st[3], st[4], st[5], BK);
  if (!err) err = encode_bhsd(&tv, v, B, Hkv, Sk, D, st[6], st[7], st[8], BK);
  if (err) return err;
  const Args a{(__nv_bfloat16*)o, (float*)lse, st[9], st[10], st[11],
               H, Hkv, Sq, Sk, scale, causal, window, cap};
  constexpr int smem = smem_bytes<D>();
  static bool attr_set = false;   // once per head dim, not per call
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        fa_fwd_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  fa_fwd_sm90_kernel<D><<<grid, THREADS, smem, stream>>>(tq, tk, tv, a);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q (B, H, Sq, D), k/v (B, Hkv, Sk, D) and o (B, H, Sq, D) through 12
// element strides (q, k, v, o) x (b, h, s), D contiguous; lse (B, H, Sq)
// contiguous f32.  Returns 0, a cudaError_t, or ENCODE_ERROR + a CUresult.
extern "C" int fa_fwd_sm90(const void* q, const void* k, const void* v,
                           void* o, void* lse, int B, int H, int Hkv, int Sq,
                           int Sk, int D, const int64_t* strides, float scale,
                           int causal, int window, float cap, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 32:
      return launch<32>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, strides, scale,
                        causal, window, cap, s);
    case 64:
      return launch<64>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, strides, scale,
                        causal, window, cap, s);
    case 128:
      return launch<128>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, strides, scale,
                         causal, window, cap, s);
  }
  return (int)cudaErrorInvalidValue;
}

// the dynamic shared memory the kernel launches with (0: no such head dim)
extern "C" int fa_fwd_sm90_smem(int D) {
  return D == 32 ? smem_bytes<32>() : D == 64 ? smem_bytes<64>()
         : D == 128 ? smem_bytes<128>() : 0;
}
