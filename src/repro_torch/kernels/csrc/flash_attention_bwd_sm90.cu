// K3b, flash-attention backward dk/dv, bf16 route: dk and dv from q, k, v,
// dO, the forward's lse and delta = rowsum(dO * o), the probabilities
// recomputed on chip, with the products on Hopper's tensor cores (wgmma)
// and the streamed tiles brought in by TMA.
//
// Replaces `_fa_dkv_kernel` (src/repro/kernels/flash_attention.py) for
// bf16 inputs; f32 inputs keep the exact CUDA-core kernel
// (flash_attention_bwd.cu).  K3a, dq, is flash_attention_dq_sm90.cu.
// What it computes is that kernel's: p = exp(s - lse) with the finite -1e30
// mask, dv = sum P^T dO, dk = sum dS^T (q * scale), dS = P o (dP - delta),
// dP = dO V^T; GQA's sum over the kv head's q heads in one fixed order.
//
// Design.  One block per (b*hkv, 128-key tile); k and v stay in shared
// memory, loaded once.  (q, dO) tiles of BQ rows stream through a ring of
// STAGES slots, per q head of the group and per q tile from the causal
// start: warp 0 refills a slot as soon as both warpgroups have released it,
// its lane 0 issuing the TMA loads and its 32 lanes copying the matching
// lse and delta rows, all signalled on the slot's mbarrier.  The two
// warpgroups own 64 keys each:
//   S^T  = K Q^T,  dP^T = V dO^T   wgmma, both operands in shared memory;
//   P^T, dS^T                      f32 in registers, then bf16;
//   dV += P^T dO,  dK += dS^T Q    wgmma with P^T / dS^T as the register A
//                                  operand, dO / Q MN-major (transpose bit).
// dK and dV stay in f32 registers for the whole loop and are written once,
// dK times the scale: no atomics, so a result is the same on every run.
// Registers bound the design at D = 128: each thread holds 128 f32 of dK
// and dV.  The register file is split in four quarters, one per group of
// warps: a block of 8 warps may give each thread 255 registers, a block
// with a ninth (producer) warp only 168, which spilled.  So there is no
// producer warp, and D = 128 streams BQ = 32 rows at a time so that the
// score fragments and their bf16 copies fit beside the accumulators.
//
// Numerics against the plain version (f32 products, q scaled first): the
// score is (q . k) * scale; P^T and dS^T are rounded to bf16 before their
// products; dk's scale is applied once at the end.  Bound: operations
// (8*D per unmasked pair: S, dP, dV, dK) against 989 TFLOP/s bf16, or the
// bytes at short sequences.
#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int BKV = 128;          // keys per block (64 per warpgroup)
constexpr int STAGES = 2;         // (q, dO, lse, delta) slots in flight
constexpr int THREADS = 256;      // two warpgroups

template <int D>
__host__ __device__ constexpr int block_q() { return D == 128 ? 32 : 64; }

struct Args {
  const float* lse;
  const float* delta;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int64_t kb, kh, ks, vb, vh, vs; // dk's and dv's element strides
  int H, Hkv, Sq, Sk;
  float scale;
  int causal, window;
};

template <int D>
constexpr int smem_bytes() {
  return 1024 + 2 * Tile<D, BKV>::BYTES +
         STAGES * (2 * Tile<D, block_q<D>()>::BYTES + 2 * block_q<D>() * 4) +
         (1 + 2 * STAGES) * 8;
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
fa_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const Args a) {
  constexpr int BQ = block_q<D>();
  using TK = Tile<D, BKV>;
  using TQ = Tile<D, BQ>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sK = align1024(smem_raw);
  uint8_t* sV = sK + TK::BYTES;
  uint8_t* sQ = sV + TK::BYTES;                   // STAGES q tiles
  uint8_t* sO = sQ + STAGES * TQ::BYTES;          // STAGES dO tiles
  float* sL = reinterpret_cast<float*>(sO + STAGES * TQ::BYTES);
  float* sD = sL + STAGES * BQ;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sD + STAGES * BQ);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;

  const int k0 = blockIdx.x * BKV;                // longest first
  const int bh = blockIdx.y;
  const int b = bh / a.Hkv, hk = bh % a.Hkv;
  const int rep = a.H / a.Hkv;
  const int k_last = min(k0 + BKV, a.Sk) - 1;
  const int q_begin = a.causal ? k0 / BQ * BQ : 0;
  const int q_end = a.window > 0 ? min(a.Sq, k_last + a.window) : a.Sq;
  const int n_qt = max(0, (q_end - q_begin + BQ - 1) / BQ);
  const int n_it = rep * n_qt;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1 + 32);                // TMA bytes + lse lanes
      mbar_init(&empty[s], 256);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // warp 0 fills slot it % STAGES, free by then, for iteration it
  const auto produce = [&](int it) {
    const int lane = threadIdx.x;
    const int s = it % STAGES;
    const int h = hk * rep + it / n_qt;
    const int qt = q_begin + (it % n_qt) * BQ;
    const int64_t row0 = ((int64_t)b * a.H + h) * a.Sq;
    if (lane == 0) {
      mbar_expect_tx(&full[s], 2 * TQ::BYTES);
      TQ::load(sQ + s * TQ::BYTES, &tq, &full[s], qt, h, b);
      TQ::load(sO + s * TQ::BYTES, &tdo, &full[s], qt, h, b);
    }
    for (int r = lane; r < BQ; r += 32) {
      const int qi = qt + r;
      sL[s * BQ + r] = qi < a.Sq ? a.lse[row0 + qi] : 0.f;
      sD[s * BQ + r] = qi < a.Sq ? a.delta[row0 + qi] : 0.f;
    }
    mbar_arrive(&full[s]);
  };
  const bool producer = threadIdx.x < 32;         // warp 0 also refills
  if (producer) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * TK::BYTES);
      TK::load(sK, &tk, kv_full, k0, hk, b);
      TK::load(sV, &tv, kv_full, k0, hk, b);
    }
    for (int it = 0; it < min(STAGES, n_it); ++it) produce(it);
  }
  __syncwarp();

  const int c = threadIdx.x / 128;                  // warpgroup
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int kc = k0 + c * 64;                       // its first key
  const int key_lo = kc + (t / 32) * 16 + lane / 4, key_hi = key_lo + 8;
  const int col0 = 2 * (lane % 4);
  const uint32_t k_addr = smem_u32(sK), v_addr = smem_u32(sV);

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(kv_full, 0);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % STAGES;
    const int qt = q_begin + (it % n_qt) * BQ;
    const uint32_t q_addr = smem_u32(sQ + s * TQ::BYTES);
    const uint32_t o_addr = smem_u32(sO + s * TQ::BYTES);
    const float* lse = sL + s * BQ;
    const float* delta = sD + s * BQ;

    float st[BQ / 2], dpt[BQ / 2];
    mbar_wait(&full[s], (it / STAGES) & 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<BQ>::template ss<0>(st, TK::kmajor(k_addr, c * 64, kk),
                                TQ::kmajor(q_addr, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<BQ>::template ss<0>(dpt, TK::kmajor(v_addr, c * 64, kk),
                                TQ::kmajor(o_addr, 0, kk), kk > 0);
    wg_commit();
    wg_wait_all();
    fence_regs<BQ / 2>(st);
    fence_regs<BQ / 2>(dpt);

    const bool edge = (a.causal && qt < kc + 63) ||
                      (a.window > 0 && qt + BQ - 1 - kc >= a.window) ||
                      qt + BQ > a.Sq || kc + 64 > a.Sk;
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + col0 + (e & 1);
        bool keep = true;
        if (edge) {
          const int qi = qt + col, kj = e < 2 ? key_lo : key_hi;
          if (a.causal) keep = keep && kj <= qi;
          if (a.window > 0) keep = keep && (qi - kj) < a.window;
          keep = keep && qi < a.Sq && kj < a.Sk;
        }
        const float p =
            keep ? exp2f((st[4 * j + e] * a.scale - lse[col]) * LOG2E) : 0.f;
        st[4 * j + e] = p;
        dpt[4 * j + e] = p * (dpt[4 * j + e] - delta[col]);
      }
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
    acc_to_a<BQ>(st, pa);
    acc_to_a<BQ>(dpt, da);

    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      Wgmma<D>::template rs<1>(dv, pa[kk], TQ::mnmajor(o_addr, kk), 1);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      Wgmma<D>::template rs<1>(dk, da[kk], TQ::mnmajor(q_addr, kk), 1);
    wg_commit();
    wg_wait_all();
    fence_regs<D / 2>(dv);
    fence_regs<D / 2>(dk);
    mbar_arrive(&empty[s]);
    if (producer && it + STAGES < n_it) {
      mbar_wait(&empty[s], (it / STAGES) & 1);
      produce(it + STAGES);
    }
    __syncwarp();                 // warp 0 whole again before the wgmma
  }

  __nv_bfloat16* kp = a.dk + b * a.kb + hk * a.kh;
  __nv_bfloat16* vp = a.dv + b * a.vb + hk * a.vh;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + col0;
    if (key_lo < a.Sk) {
      *reinterpret_cast<uint32_t*>(kp + (int64_t)key_lo * a.ks + col) =
          pack_bf16(dk[4 * j] * a.scale, dk[4 * j + 1] * a.scale);
      *reinterpret_cast<uint32_t*>(vp + (int64_t)key_lo * a.vs + col) =
          pack_bf16(dv[4 * j], dv[4 * j + 1]);
    }
    if (key_hi < a.Sk) {
      *reinterpret_cast<uint32_t*>(kp + (int64_t)key_hi * a.ks + col) =
          pack_bf16(dk[4 * j + 2] * a.scale, dk[4 * j + 3] * a.scale);
      *reinterpret_cast<uint32_t*>(vp + (int64_t)key_hi * a.vs + col) =
          pack_bf16(dv[4 * j + 2], dv[4 * j + 3]);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* d_o,
           const void* lse, const void* delta, void* dk, void* dv, int B,
           int H, int Hkv, int Sq, int Sk, const int64_t* st, float scale,
           int causal, int window, cudaStream_t stream) {
  constexpr int BQ = block_q<D>();
  CUtensorMap tq, tk, tv, tdo;
  int err = encode_bhsd(&tq, q, B, H, Sq, D, st[0], st[1], st[2], BQ);
  if (!err)
    err = encode_bhsd(&tk, k, B, Hkv, Sk, D, st[3], st[4], st[5], BKV);
  if (!err)
    err = encode_bhsd(&tv, v, B, Hkv, Sk, D, st[6], st[7], st[8], BKV);
  if (!err)
    err = encode_bhsd(&tdo, d_o, B, H, Sq, D, st[9], st[10], st[11], BQ);
  if (err) return err;
  // strides 12..14 are dq's, unused here
  const Args a{(const float*)lse, (const float*)delta, (__nv_bfloat16*)dk,
               (__nv_bfloat16*)dv, st[15], st[16], st[17], st[18], st[19],
               st[20], H, Hkv, Sq, Sk, scale, causal, window};
  constexpr int smem = smem_bytes<D>();
  static bool attr_set = false;   // once per head dim, not per call
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        fa_bwd_dkv_sm90_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((Sk + BKV - 1) / BKV, B * Hkv);
  fa_bwd_dkv_sm90_kernel<D><<<grid, THREADS, smem, stream>>>(tq, tk, tv, tdo,
                                                             a);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 q/dO (B, H, Sq, D), k/v (B, Hkv, Sk, D), dk/dv (B, Hkv, Sk, D)
// through 21 element strides (q, k, v, dO, dq, dk, dv) x (b, h, s) as the
// CUDA-core kernels take them (dq's unused), D contiguous; lse and delta
// (B, H, Sq) contiguous f32.  Returns 0, a cudaError_t, or ENCODE_ERROR + a
// CUresult.
extern "C" int fa_bwd_dkv_sm90(const void* q, const void* k, const void* v,
                               const void* d_o, const void* lse,
                               const void* delta, void* dk, void* dv, int B,
                               int H, int Hkv, int Sq, int Sk, int D,
                               const int64_t* strides, float scale,
                               int causal, int window, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 32:
      return launch<32>(q, k, v, d_o, lse, delta, dk, dv, B, H, Hkv, Sq, Sk,
                        strides, scale, causal, window, s);
    case 64:
      return launch<64>(q, k, v, d_o, lse, delta, dk, dv, B, H, Hkv, Sq, Sk,
                        strides, scale, causal, window, s);
    case 128:
      return launch<128>(q, k, v, d_o, lse, delta, dk, dv, B, H, Hkv, Sq,
                         Sk, strides, scale, causal, window, s);
  }
  return (int)cudaErrorInvalidValue;
}

// the dynamic shared memory the kernel launches with (0: no such head dim)
extern "C" int fa_bwd_dkv_sm90_smem(int D) {
  return D == 32 ? smem_bytes<32>() : D == 64 ? smem_bytes<64>()
         : D == 128 ? smem_bytes<128>() : 0;
}
