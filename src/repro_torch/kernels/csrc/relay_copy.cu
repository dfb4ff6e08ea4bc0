// K4, the relay copy: byte spans moved between pinned host memory (through
// its mapped device address) and HBM, bit-exact.
//
// Replaces `_copy_kernel` / `copy_rows` / `writeback_slot` of
// src/repro/kernels/relay_copy.py, a Pallas kernel that moves a relay slot
// as DMAs, one per chunk of a static plan, paced by two rotating
// semaphores.  Here the SMs do the moving over PCIe (one side is host
// memory) and HBM.  kernels/relay_copy.py turns the chunk plan into spans;
// each span is one launch on the caller's stream (the relay's copy
// stream), whose order runs them one after another.
//
// Bound: the bytes over PCIe 5.0 x16, 64 GB/s each way.  What holds the
// SMs' reads of host memory below it is a budget of reads in flight on the
// host's side, not the kernel: chip_smoke.py's k4-sweep on one H100 finds
// every design below at the same rate on a host (TMA tiles of 4, 16 or 64
// KB; 16-byte loads in whole 128-byte lines, plain or with a 128- or
// 256-byte L2 prefetch; tiles interleaved or one contiguous run per
// block; 4 to 132 blocks; every host allocation kind): 26-28 GB/s on one
// host against the copy engine's 45, 49-51 against 54 on another.  One
// dependent read of host memory (chase_kernel) takes 1.34 us there, 1.49
// us from write-combined memory, and rate x round trip is ~36 KiB on both:
// more in flight from the SMs (8 blocks of the line loop keep 256 KB)
// does not raise it, a longer round trip lowers it.  SM stores are posted
// writes: 50-52 GB/s from 2 blocks on, whatever the design.
//
// So the relay's route (both directions) is the line loop on 8 blocks: the
// rate of any design, on 8 of 132 SMs and no shared memory, so the layers
// it overlaps keep the rest (a 2048-token prefill layer beside it runs far
// closer to its time alone than beside the TMA kernel: chip_smoke.py's
// layer line), and a fetch and
// write-backs on two streams run side by side (22 + 43 GB/s together
// against 27 and 49 alone; the kernels over every SM reached 22 + 18).
// The TMA kernel (16 KB tiles on every SM, 64 KB of shared memory each)
// and the word loop are the kernels the relay took before, kept for
// timing; the 128- and 256-byte prefetch loads and the latency probe serve
// the sweep.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---- word loop: any alignment (4- or 1-byte words), and 16-byte words --
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

// ---- tiles: which tiles a block takes ---------------------------------
// interleaved: tile blockIdx.x + k * gridDim.x; span: one contiguous run
// of ceil(n_tiles / gridDim.x) tiles per block.
struct Tiles {
  int64_t first, count, step;
};

__device__ __forceinline__ Tiles my_tiles(int64_t n_tiles, int span) {
  Tiles t;
  if (span) {
    const int64_t per = (n_tiles + gridDim.x - 1) / gridDim.x;
    t.first = (int64_t)blockIdx.x * per;
    const int64_t left = n_tiles - t.first;
    t.count = left < per ? (left > 0 ? left : 0) : per;
    t.step = 1;
  } else {
    t.first = blockIdx.x;
    t.count = t.first < n_tiles
                  ? (n_tiles - t.first + gridDim.x - 1) / gridDim.x : 0;
    t.step = gridDim.x;
  }
  return t;
}

// ---- line loop: 16-byte words in whole 128-byte lines -----------------
// A tile is kLineThreads * kLineUnroll words (32 KB); every thread loads
// its kLineUnroll words before it stores any, so a block keeps 32 KB of
// reads in flight.  Kind picks the load: 0 plain, 1 non-coherent with a
// 128-byte L2 prefetch, 2 the same with a 256-byte prefetch.
constexpr int kLineThreads = 512;
constexpr int kLineUnroll = 4;
constexpr int64_t kLineTile = (int64_t)kLineThreads * kLineUnroll;

template <int Kind>
__device__ __forceinline__ uint4 load16(const uint4* p) {
  uint4 r;
  if constexpr (Kind == 1) {
    asm("ld.global.nc.L1::no_allocate.L2::128B.v4.u32 {%0, %1, %2, %3}, [%4];"
        : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "l"(p));
  } else if constexpr (Kind == 2) {
    asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
        : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "l"(p));
  } else {
    r = *p;
  }
  return r;
}

template <int Kind>
__global__ void __launch_bounds__(kLineThreads)
line_copy_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst,
                 int64_t n16, int span) {
  const int64_t n_tiles = (n16 + kLineTile - 1) / kLineTile;
  const Tiles t = my_tiles(n_tiles, span);
  for (int64_t k = 0; k < t.count; ++k) {
    const int64_t base = (t.first + k * t.step) * kLineTile + threadIdx.x;
    uint4 r[kLineUnroll];
#pragma unroll
    for (int u = 0; u < kLineUnroll; ++u) {
      const int64_t i = base + u * kLineThreads;
      if (i < n16) r[u] = load16<Kind>(src + i);
    }
#pragma unroll
    for (int u = 0; u < kLineUnroll; ++u) {
      const int64_t i = base + u * kLineThreads;
      if (i < n16) dst[i] = r[u];
    }
  }
}

// ---- TMA bulk copy through shared memory ------------------------------
// One thread per block moves `tile`-byte tiles src -> shared -> dst with
// cp.async.bulk, `stages` (at least 2) tiles in flight per block: a
// stage is refilled once the store of the tile after it has been issued.
constexpr int kMaxStages = 16;

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
                 int64_t bytes, int tile, int stages, int span) {
  extern __shared__ __align__(128) char buf[];
  __shared__ __align__(8) uint64_t bars[kMaxStages];
  if (threadIdx.x != 0) return;
  const int64_t n_tiles = (bytes + tile - 1) / tile;
  const Tiles t = my_tiles(n_tiles, span);
  const int64_t mine = t.count;
  if (mine <= 0) return;
  for (int s = 0; s < stages; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(smem_addr(&bars[s])) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  auto tile_off = [&](int64_t k) { return (t.first + k * t.step) * tile; };
  auto tile_len = [&](int64_t k) {
    const int64_t off = tile_off(k);
    return (uint32_t)(bytes - off < tile ? bytes - off : tile);
  };
  for (int64_t k = 0; k < stages && k < mine; ++k)
    bulk_load(smem_addr(buf + k * tile), src + tile_off(k), tile_len(k),
              smem_addr(&bars[k]));
  for (int64_t k = 0; k < mine; ++k) {
    const int s = (int)(k % stages);
    bar_wait(smem_addr(&bars[s]), (uint32_t)((k / stages) & 1));
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
                 :: "l"(dst + tile_off(k)),
                    "r"(smem_addr(buf + (int64_t)s * tile)),
                    "r"(tile_len(k)) : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    // refill the stage the previous store read from, once it has read it
    const int64_t next = k - 1 + stages;
    if (k >= 1 && next < mine) {
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      const int ps = (int)((k - 1) % stages);
      bulk_load(smem_addr(buf + (int64_t)ps * tile), src + tile_off(next),
                tile_len(next), smem_addr(&bars[ps]));
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---- round trip: one thread follows a chain of indices ----------------
// p[i] holds the index of the next element to read; each load waits for
// the one before, so the kernel's time over `steps` is the latency of one
// read of that memory.
__global__ void chase_kernel(const volatile int64_t* p, int64_t steps,
                             int64_t* out) {
  int64_t i = 0;
  for (int64_t s = 0; s < steps; ++s) i = p[i];
  out[0] = i;
}

// ---- launches ----------------------------------------------------------
enum Method { kLdst = 0, kBulk = 1, kLine = 2, kLine128 = 3, kLine256 = 4 };

int grid_for(int64_t need, int blocks) {
  if (need < 1) need = 1;
  return (int)(need < blocks ? need : blocks);
}

template <typename T>
cudaError_t launch_words(const char* src, char* dst, int64_t bytes,
                         int blocks, cudaStream_t s) {
  const int64_t n = bytes / (int64_t)sizeof(T);
  copy_kernel<T><<<grid_for((n + kThreads - 1) / kThreads, blocks), kThreads,
                   0, s>>>(reinterpret_cast<const T*>(src),
                           reinterpret_cast<T*>(dst), n);
  return cudaGetLastError();
}

template <int Kind>
cudaError_t launch_lines(const char* src, char* dst, int64_t bytes,
                         int blocks, int span, cudaStream_t s) {
  const int64_t n16 = bytes / 16;
  line_copy_kernel<Kind><<<grid_for((n16 + kLineTile - 1) / kLineTile,
                                    blocks), kLineThreads, 0, s>>>(
      reinterpret_cast<const uint4*>(src), reinterpret_cast<uint4*>(dst),
      n16, span);
  return cudaGetLastError();
}

cudaError_t launch_bulk(const char* src, char* dst, int64_t bytes, int tile,
                        int stages, int blocks, int span, cudaStream_t s) {
  if (tile <= 0 || tile % 16 || stages < 2 || stages > kMaxStages)
    return cudaErrorInvalidValue;
  const int smem = tile * stages;
  cudaError_t err = cudaFuncSetAttribute(
      bulk_copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  bulk_copy_kernel<<<grid_for((bytes + tile - 1) / tile, blocks), 32, smem,
                     s>>>(src, dst, bytes, tile, stages, span);
  return cudaGetLastError();
}

cudaError_t device_address(const void* p, const char** out) {
  cudaPointerAttributes attr;
  cudaError_t err = cudaPointerGetAttributes(&attr, p);
  if (err != cudaSuccess) return err;
  if (attr.devicePointer == nullptr) return cudaErrorInvalidValue;
  *out = (const char*)attr.devicePointer;
  return cudaSuccess;
}

}  // namespace

// spans: n_spans triples (src_offset, dst_offset, bytes) from src and dst.
// Either side may be pinned host memory (addressed through its mapped
// device address) or device memory.  A span whose two addresses and size
// are 16-byte multiples takes `method` (tile and stages for the TMA;
// `span` 1 gives each block one contiguous run of tiles); any other span
// takes the 4- or 1-byte word loop.
extern "C" int rc_copy_spans(const void* src, void* dst, const int64_t* spans,
                             int n_spans, int method, int tile, int stages,
                             int blocks, int span, void* stream) {
  const char* src_b;
  const char* dst_c;
  cudaError_t err = device_address(src, &src_b);
  if (err != cudaSuccess) return (int)err;
  err = device_address(dst, &dst_c);
  if (err != cudaSuccess) return (int)err;
  char* dst_b = const_cast<char*>(dst_c);
  cudaStream_t s = (cudaStream_t)stream;
  for (int i = 0; i < n_spans; ++i) {
    const char* from = src_b + spans[3 * i];
    char* to = dst_b + spans[3 * i + 1];
    const int64_t bytes = spans[3 * i + 2];
    if (bytes <= 0) continue;
    const uintptr_t align = (uintptr_t)from | (uintptr_t)to | (uintptr_t)bytes;
    if (align % 16 == 0) {
      switch (method) {
        case kBulk:
          err = launch_bulk(from, to, bytes, tile, stages, blocks, span, s);
          break;
        case kLine: err = launch_lines<0>(from, to, bytes, blocks, span, s);
          break;
        case kLine128: err = launch_lines<1>(from, to, bytes, blocks, span, s);
          break;
        case kLine256: err = launch_lines<2>(from, to, bytes, blocks, span, s);
          break;
        default: err = launch_words<uint4>(from, to, bytes, blocks, s);
      }
    } else if (align % 4 == 0) {
      err = launch_words<uint32_t>(from, to, bytes, blocks, s);
    } else {
      err = launch_words<uint8_t>(from, to, bytes, blocks, s);
    }
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// Pinned host memory for the relay's rows: cudaHostAlloc / cudaFreeHost,
// and page-locking of memory the caller mapped (cudaHostRegister).
extern "C" int rc_host_alloc(int64_t bytes, unsigned flags, void** out) {
  return (int)cudaHostAlloc(out, (size_t)bytes, flags);
}

extern "C" int rc_host_free(void* p) { return (int)cudaFreeHost(p); }

extern "C" int rc_host_register(void* p, int64_t bytes, unsigned flags) {
  return (int)cudaHostRegister(p, (size_t)bytes, flags);
}

extern "C" int rc_host_unregister(void* p) {
  return (int)cudaHostUnregister(p);
}

// The latency probe: `steps` dependent reads along the chain in `chain`
// (host or device memory); the last index read goes to `out` (device).
extern "C" int rc_chase(const void* chain, int64_t steps, void* out,
                        void* stream) {
  const char* p;
  cudaError_t err = device_address(chain, &p);
  if (err != cudaSuccess) return (int)err;
  chase_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const volatile int64_t*>(p), steps, (int64_t*)out);
  return (int)cudaGetLastError();
}
