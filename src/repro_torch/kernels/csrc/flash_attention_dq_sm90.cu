// K3a, flash-attention backward dq, bf16 route: dq from q, k, v, dO, the
// forward's lse and delta = rowsum(dO * o), the probabilities recomputed on
// chip, with the products on Hopper's tensor cores (wgmma) and the tiles
// brought in by TMA.
//
// Replaces `_fa_dq_kernel` (src/repro/kernels/flash_attention.py) for bf16
// inputs; f32 inputs keep the exact CUDA-core kernel
// (flash_attention_bwd.cu).  What it computes is that kernel's:
// dq = scale * sum_k dS K, dS = P o (dP - delta), dP = dO V^T,
// P = exp(s - lse) with the finite -1e30 mask; GQA with KV head
// h / (H / Hkv) read directly; dq written through the strides of the
// model's (B, S, H, D) tensor.
//
// Design, K2's layout (flash_attention_sm90.cu) with a second product per
// tile.  One block per (b*h, 128-row q tile), q tiles issued longest first
// under causal masking.  Thread 0 loads the q and dO tiles once and keeps a
// ring of STAGES (k, v) tiles of BK keys in flight through TMA, each slot
// signalled by its own mbarrier and refilled once both warpgroups have
// released it.  The two warpgroups own 64 q rows each, their lse and delta
// in registers:
//   S = Q K^T, dP = dO V^T   wgmma, both operands from shared memory
//                            (K-major), f32 accumulators;
//   P, dS                    f32 in registers, then bf16: the m64nBK
//                            accumulator fragment is the A fragment of the
//                            next product's k16 steps, no shuffles;
//   dQ += dS K               wgmma with dS as the register A operand and K
//                            MN-major (the transpose bit), as K2's P V.
// The loop runs from the window's first tile to the causal diagonal; a tile
// that masks all 64 rows of a warpgroup costs that warpgroup no product,
// and per-element masks run only on tiles that need them.  dQ stays in f32
// registers for the whole loop, is multiplied by the scale once and stored
// once: no atomics, so a result is the same on every run.  There is no
// producer warp (a ninth warp caps every thread at 168 registers).  At
// D <= 64 a thread holds 64 f32 of S and dP beside dQ in at most 128
// registers, so two blocks share an SM; D = 128 runs one block per SM.
//
// Numerics against the plain version (q scaled first, f32 products): the
// score is (q . k) * scale, the scale applied to the f32 accumulator; dS is
// rounded to bf16 before dS K; dq's scale is applied after the sum.
// Bound: operations (6*D per unmasked pair: S, dP, dQ) against 989 TFLOP/s
// bf16, or the bytes at short sequences.
#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int BQ = 128;           // q rows per block (64 per warpgroup)
constexpr int BK = 64;            // keys per streamed (k, v) tile
constexpr int STAGES = 2;         // (k, v) tiles in flight
constexpr int THREADS = 256;      // two warpgroups

template <int D>
__host__ __device__ constexpr int blocks_per_sm() { return D == 128 ? 1 : 2; }

struct Args {
  const float* lse;
  const float* delta;
  __nv_bfloat16* dq;
  int64_t qb, qh, qs;             // dq's element strides (b, h, s)
  int H, Hkv, Sq, Sk;
  float scale;
  int causal, window;
};

template <int D>
constexpr int smem_bytes() {
  return 1024 + 2 * Tile<D, BQ>::BYTES + 2 * STAGES * Tile<D, BK>::BYTES +
         (1 + 2 * STAGES) * 8;
}

template <int D>
__global__ void __launch_bounds__(THREADS, blocks_per_sm<D>())
fa_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const Args a) {
  using TQ = Tile<D, BQ>;
  using TK = Tile<D, BK>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align1024(smem_raw);
  uint8_t* sO = sQ + TQ::BYTES;                   // dO
  uint8_t* sK = sO + TQ::BYTES;                   // STAGES k tiles
  uint8_t* sV = sK + STAGES * TK::BYTES;          // STAGES v tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + STAGES * TK::BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

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
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], THREADS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // thread 0 fills slot i % STAGES, free by then, with k/v tile i
  const auto load_kv = [&](int i) {
    const int s = i % STAGES;
    const int kt = k_begin + i * BK;
    mbar_expect_tx(&full[s], 2 * TK::BYTES);
    TK::load(sK + s * TK::BYTES, &tk, &full[s], kt, hk, b);
    TK::load(sV + s * TK::BYTES, &tv, &full[s], kt, hk, b);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(q_full, 2 * TQ::BYTES);
    TQ::load(sQ, &tq, q_full, q0, h, b);
    TQ::load(sO, &tdo, q_full, q0, h, b);
    for (int i = 0; i < min(STAGES, n_tiles); ++i) load_kv(i);
  }
  __syncwarp();

  const int c = threadIdx.x / 128;                  // warpgroup
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int r0 = q0 + c * 64;                       // its first q row
  const int row_lo = r0 + (t / 32) * 16 + lane / 4, row_hi = row_lo + 8;
  const int col0 = 2 * (lane % 4);
  const uint32_t q_addr = smem_u32(sQ), o_addr = smem_u32(sO);
  const int64_t lrow = (int64_t)bh * a.Sq;
  const float lse_lo = row_lo < a.Sq ? a.lse[lrow + row_lo] : 0.f;
  const float lse_hi = row_hi < a.Sq ? a.lse[lrow + row_hi] : 0.f;
  const float del_lo = row_lo < a.Sq ? a.delta[lrow + row_lo] : 0.f;
  const float del_hi = row_hi < a.Sq ? a.delta[lrow + row_hi] : 0.f;

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES;
    const int kt = k_begin + i * BK;
    const uint32_t k_addr = smem_u32(sK + s * TK::BYTES);
    const uint32_t v_addr = smem_u32(sV + s * TK::BYTES);
    // every key of the tile masked for all 64 rows of this warpgroup
    const bool dead = (a.causal && kt > r0 + 63) ||
                      (a.window > 0 && r0 - (kt + BK - 1) >= a.window);
    mbar_wait(&full[s], (i / STAGES) & 1);
    if (!dead) {
      float sc[BK / 2], dp[BK / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<BK>::template ss<0>(sc, TQ::kmajor(q_addr, c * 64, kk),
                                  TK::kmajor(k_addr, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<BK>::template ss<0>(dp, TQ::kmajor(o_addr, c * 64, kk),
                                  TK::kmajor(v_addr, 0, kk), kk > 0);
      wg_commit();
      wg_wait_all();
      fence_regs<BK / 2>(sc);
      fence_regs<BK / 2>(dp);

      const bool edge = (a.causal && kt + BK - 1 > r0) ||
                        (a.window > 0 && r0 + 63 - kt >= a.window) ||
                        kt + BK > a.Sk;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool lo = e < 2;
          bool keep = true;
          if (edge) {
            const int qi = lo ? row_lo : row_hi;
            const int kj = kt + 8 * j + col0 + (e & 1);
            if (a.causal) keep = keep && kj <= qi;
            if (a.window > 0) keep = keep && (qi - kj) < a.window;
            keep = keep && kj < a.Sk;
          }
          const float p =
              keep ? exp2f((sc[4 * j + e] * a.scale - (lo ? lse_lo : lse_hi))
                           * LOG2E)
                   : 0.f;
          dp[4 * j + e] = p * (dp[4 * j + e] - (lo ? del_lo : del_hi));
        }
      uint32_t da[BK / 16][4];
      acc_to_a<BK>(dp, da);

      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        Wgmma<D>::template rs<1>(dq, da[kk], TK::mnmajor(k_addr, kk), 1);
      wg_commit();
      wg_wait_all();
      fence_regs<D / 2>(dq);
    }
    mbar_arrive(&empty[s]);
    if (threadIdx.x == 0 && i + STAGES < n_tiles) {
      mbar_wait(&empty[s], (i / STAGES) & 1);
      load_kv(i + STAGES);
    }
    __syncwarp();                 // warp 0 whole again before the wgmma
  }

  __nv_bfloat16* qp = a.dq + b * a.qb + h * a.qh;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + col0;
    if (row_lo < a.Sq)
      *reinterpret_cast<uint32_t*>(qp + (int64_t)row_lo * a.qs + col) =
          pack_bf16(dq[4 * j] * a.scale, dq[4 * j + 1] * a.scale);
    if (row_hi < a.Sq)
      *reinterpret_cast<uint32_t*>(qp + (int64_t)row_hi * a.qs + col) =
          pack_bf16(dq[4 * j + 2] * a.scale, dq[4 * j + 3] * a.scale);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* d_o,
           const void* lse, const void* delta, void* dq, int B, int H,
           int Hkv, int Sq, int Sk, const int64_t* st, float scale,
           int causal, int window, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  int err = encode_bhsd(&tq, q, B, H, Sq, D, st[0], st[1], st[2], BQ);
  if (!err) err = encode_bhsd(&tk, k, B, Hkv, Sk, D, st[3], st[4], st[5], BK);
  if (!err) err = encode_bhsd(&tv, v, B, Hkv, Sk, D, st[6], st[7], st[8], BK);
  if (!err)
    err = encode_bhsd(&tdo, d_o, B, H, Sq, D, st[9], st[10], st[11], BQ);
  if (err) return err;
  // strides 12..14 are dq's; 15..20 (dk's, dv's) are unused here
  const Args a{(const float*)lse, (const float*)delta, (__nv_bfloat16*)dq,
               st[12], st[13], st[14], H, Hkv, Sq, Sk, scale, causal,
               window};
  constexpr int smem = smem_bytes<D>();
  static bool attr_set = false;   // once per head dim, not per call
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        fa_bwd_dq_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  fa_bwd_dq_sm90_kernel<D><<<grid, THREADS, smem, stream>>>(tq, tk, tv, tdo,
                                                            a);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q/dO/dq (B, H, Sq, D), k/v (B, Hkv, Sk, D) through 21 element
// strides (q, k, v, dO, dq, dk, dv) x (b, h, s) as the CUDA-core kernels
// take them (dk's and dv's unused), D contiguous; lse and delta (B, H, Sq)
// contiguous f32.  Returns 0, a cudaError_t, or ENCODE_ERROR + a CUresult.
extern "C" int fa_bwd_dq_sm90(const void* q, const void* k, const void* v,
                              const void* d_o, const void* lse,
                              const void* delta, void* dq, int B, int H,
                              int Hkv, int Sq, int Sk, int D,
                              const int64_t* strides, float scale,
                              int causal, int window, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 32:
      return launch<32>(q, k, v, d_o, lse, delta, dq, B, H, Hkv, Sq, Sk,
                        strides, scale, causal, window, s);
    case 64:
      return launch<64>(q, k, v, d_o, lse, delta, dq, B, H, Hkv, Sq, Sk,
                        strides, scale, causal, window, s);
    case 128:
      return launch<128>(q, k, v, d_o, lse, delta, dq, B, H, Hkv, Sq, Sk,
                         strides, scale, causal, window, s);
  }
  return (int)cudaErrorInvalidValue;
}

// the dynamic shared memory the kernel launches with (0: no such head dim)
extern "C" int fa_bwd_dq_sm90_smem(int D) {
  return D == 32 ? smem_bytes<32>() : D == 64 ? smem_bytes<64>()
         : D == 128 ? smem_bytes<128>() : 0;
}
