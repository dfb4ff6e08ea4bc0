// K4, the relay copy: rows [start, start+size) of a stacked (N, W) buffer
// moved into a (size, W) slot, bit-exact.
//
// Replaces `_copy_kernel` / `copy_rows` of src/repro/kernels/relay_copy.py,
// a Pallas kernel that moves the slot as DMAs, one per chunk of a static
// plan (one chunk per row, or two half rows for a single-row slot), paced
// by two rotating semaphores.
//
// Here the card's own engines do the moving: the source is pinned host
// memory, mapped into the card's address space, so a kernel reads it over
// PCIe and writes the slot in HBM.  Each chunk of the plan is one launch
// on the caller's stream (the relay's copy stream); stream order runs the
// chunks one after another, which is all the ordering the TPU's
// semaphores give.  A 16-byte-aligned chunk goes through the TMA: one
// thread per block streams 16 KB tiles host -> shared -> HBM with
// cp.async.bulk, four tiles in flight, so the copy holds one warp and
// 64 KB of shared memory per block and leaves the SMs to the layers it
// overlaps.  Any other chunk goes through a grid-stride load/store loop
// (4- or 1-byte words).  The same kernels copy a device-resident source.
//
// Bound: the slot's bytes over the link it crosses (PCIe 5.0 x16, 64 GB/s
// each way, for a pinned-host source; HBM for a device-resident one).  On
// one H100 the SM-side reads of host memory level off at 26-29 GB/s, for
// the TMA and the load/store loop alike and from 1 to 16 blocks per SM,
// while the copy engine (Tensor.copy_) reaches 44-52 GB/s on the same
// machines (chip_smoke.py, K4 row, `ms_by_method_blocks_per_sm`): the
// limit sits in the card's path to host memory, not in the kernel's
// parallelism.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

template <typename T>
__global__ void __launch_bounds__(kThreads)
copy_kernel(const T* __restrict__ src, T* __restrict__ dst, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  for (; i + (kUnroll - 1) * stride < n; i += kUnroll * stride) {
    T r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) r[u] = src[i + u * stride];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) dst[i + u * stride] = r[u];
  }
  for (; i < n; i += stride) dst[i] = src[i];
}

// TMA bulk copy: one thread per block moves kTile-byte tiles host ->
// shared -> HBM with cp.async.bulk, kStages tiles in flight per block.
// Tile k of this block is tile blockIdx.x + k * gridDim.x of the chunk.
constexpr int kTile = 16384;
constexpr int kStages = 4;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const char* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred P1;\n\t"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\t"
      "bra LAB_WAIT;\n\t"
      "DONE:\n\t}"
      :: "r"(bar), "r"(parity) : "memory");
}

__global__ void __launch_bounds__(32)
bulk_copy_kernel(const char* __restrict__ src, char* __restrict__ dst,
                 int64_t bytes) {
  extern __shared__ __align__(128) char buf[];
  __shared__ __align__(8) uint64_t bars[kStages];
  if (threadIdx.x != 0) return;
  const int64_t n_tiles = (bytes + kTile - 1) / kTile;
  const int64_t first = blockIdx.x;
  if (first >= n_tiles) return;
  const int64_t mine = (n_tiles - first + gridDim.x - 1) / gridDim.x;
  for (int s = 0; s < kStages; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(smem_addr(&bars[s])) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  auto tile_off = [&](int64_t k) { return (first + k * gridDim.x) * kTile; };
  auto tile_len = [&](int64_t k) {
    const int64_t off = tile_off(k);
    return (uint32_t)(bytes - off < kTile ? bytes - off : kTile);
  };
  for (int64_t k = 0; k < kStages && k < mine; ++k)
    bulk_load(smem_addr(buf + k * kTile), src + tile_off(k), tile_len(k),
              smem_addr(&bars[k]));
  for (int64_t k = 0; k < mine; ++k) {
    const int s = (int)(k % kStages);
    bar_wait(smem_addr(&bars[s]), (uint32_t)((k / kStages) & 1));
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
                 :: "l"(dst + tile_off(k)), "r"(smem_addr(buf + s * kTile)),
                    "r"(tile_len(k)) : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    // refill the stage the previous store read from, once it has read it
    const int64_t next = k - 1 + kStages;
    if (k >= 1 && next < mine) {
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      const int ps = (int)((k - 1) % kStages);
      bulk_load(smem_addr(buf + ps * kTile), src + tile_off(next),
                tile_len(next), smem_addr(&bars[ps]));
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <typename T>
cudaError_t launch(const char* src, char* dst, int64_t bytes, int blocks,
                   cudaStream_t s) {
  const int64_t n = bytes / (int64_t)sizeof(T);
  const int64_t need = (n + kThreads - 1) / kThreads;
  const int grid = (int)(need < blocks ? need : blocks);
  copy_kernel<T><<<grid, kThreads, 0, s>>>(
      reinterpret_cast<const T*>(src), reinterpret_cast<T*>(dst), n);
  return cudaGetLastError();
}

cudaError_t launch_bulk(const char* src, char* dst, int64_t bytes, int blocks,
                        cudaStream_t s) {
  const int smem = kTile * kStages;
  cudaError_t err = cudaFuncSetAttribute(
      bulk_copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int64_t need = (bytes + kTile - 1) / kTile;
  const int grid = (int)(need < blocks ? need : blocks);
  bulk_copy_kernel<<<grid, 32, smem, s>>>(src, dst, bytes);
  return cudaGetLastError();
}

}  // namespace

// chunks: n_chunks triples (row, byte_lo, byte_hi) relative to the slot.
// The fetch reads source rows [src_start + row] into slot rows [row]; the
// write-back (src_start = 0) writes slot rows [row] into destination rows
// [dst_start + row].  Either side may be pinned host memory (addressed
// through its mapped device address) or device memory.
extern "C" int rc_copy_rows(const void* src, void* dst, int64_t src_start,
                            int64_t dst_start, int64_t row_bytes,
                            const int64_t* chunks, int n_chunks, int blocks,
                            int bulk, void* stream) {
  cudaPointerAttributes attr;
  cudaError_t err = cudaPointerGetAttributes(&attr, src);
  if (err != cudaSuccess) return (int)err;
  if (attr.devicePointer == nullptr) return (int)cudaErrorInvalidValue;
  const char* src_b = (const char*)attr.devicePointer;
  err = cudaPointerGetAttributes(&attr, dst);
  if (err != cudaSuccess) return (int)err;
  if (attr.devicePointer == nullptr) return (int)cudaErrorInvalidValue;
  char* dst_b = (char*)attr.devicePointer;
  cudaStream_t s = (cudaStream_t)stream;
  for (int i = 0; i < n_chunks; ++i) {
    const int64_t row = chunks[3 * i];
    const int64_t lo = chunks[3 * i + 1];
    const int64_t hi = chunks[3 * i + 2];
    const char* from = src_b + (src_start + row) * row_bytes + lo;
    char* to = dst_b + (dst_start + row) * row_bytes + lo;
    const int64_t bytes = hi - lo;
    if (bytes <= 0) continue;
    const uintptr_t align = (uintptr_t)from | (uintptr_t)to | (uintptr_t)bytes;
    if (align % 16 == 0 && bulk)
      err = launch_bulk(from, to, bytes, blocks, s);
    else if (align % 16 == 0)
      err = launch<uint4>(from, to, bytes, blocks, s);
    else if (align % 4 == 0)
      err = launch<uint32_t>(from, to, bytes, blocks, s);
    else
      err = launch<uint8_t>(from, to, bytes, blocks, s);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
