// B9: copy probes. out = x, or out = x + 1 per byte (wrapping in int8), over
// the layer1 activation of ResNet-50, (B, 56, 56, 256) s8, by three routes.
//
// Replaces the Pallas copy bodies of the TPU DMA studies:
//   grid_copy  one block per `bi` images (the auto-pipelined grid copies:
//              bench/fused_probe.py:45, bench/dma_ring_probe.py:132,
//              bench/dma_ring_probe3.py:89);
//   ring_copy  one persistent block per SM streaming `bi`-image steps through
//              an S-slot shared-memory ring filled by cp.async, D steps ahead
//              (the hand-rolled DMA rings: bench/dma_ring_probe.py:103,
//              bench/dma_ring_probe2.py:90, bench/dma_ring_probe3.py:164);
//   bulk_copy  TMA bulk copies, global -> shared -> global on an mbarrier,
//              issued by one thread per block with `streams` copies in flight
//              (the raw whole-array DMAs: bench/dma_ring_probe2.py:47,
//              bench/dma_ring_probe3.py:185).
//
// What bounds them on the H100: bytes only, 2 x the tensor over 3.35 TB/s.
// A TPU step of bi images (0.8 MB each) fits in VMEM; a Hopper block has at
// most 227 KB of shared memory, so the ring splits each step across the SMs:
// block b takes the b-th of gridDim.x equal pieces of every step, and a slot
// holds one piece. A TPU out-DMA frees its slot only when it completes, so
// the Pallas ring waits on it; here a thread stores a slot's words from
// registers, so the slot is free once they are read and only D (<= S) slots
// are ever in use. Each thread copies the same words of every piece, so
// cp.async.wait_group (per thread) orders the ring without a barrier.
// 16-byte loads and stores throughout; the bytes past the last whole 16 are
// copied one by one.

#include "int8_mma.cuh"

namespace {

constexpr int GRID_THREADS = 512;
constexpr int MAX_DEPTH = 8;         // cp.async.wait_group takes an immediate
constexpr int BULK_CHUNK = 32768;    // bytes of one TMA bulk copy
constexpr int MAX_STREAMS = 6;       // 6 x 32 KB of the 227 KB

template <typename T>
__host__ __device__ __forceinline__ T lo(T a, T b) { return a < b ? a : b; }

template <typename T>
__host__ __device__ __forceinline__ T hi(T a, T b) { return a < b ? b : a; }

__device__ __forceinline__ uint4 add1(uint4 v) {
  const uint32_t ones = 0x01010101u;
  return make_uint4(__vadd4(v.x, ones), __vadd4(v.y, ones), __vadd4(v.z, ones), __vadd4(v.w, ones));
}

__device__ __forceinline__ int8_t add1(int8_t b) {
  return static_cast<int8_t>(static_cast<uint8_t>(static_cast<uint8_t>(b) + 1u));
}

// bytes [b0, b1) of x into out (both 16-byte aligned), +1 each if add; all
// threads of the block
__device__ void copy_span(int8_t* __restrict__ out, const int8_t* __restrict__ x, size_t b0, size_t b1,
                          int add) {
  const size_t a0 = lo(b1, (b0 + 15) & ~static_cast<size_t>(15));
  const size_t a1 = hi(a0, b1 & ~static_cast<size_t>(15));
  const size_t step = blockDim.x;
  for (size_t i = b0 + threadIdx.x; i < a0; i += step) out[i] = add ? add1(x[i]) : x[i];
  for (size_t i = a1 + threadIdx.x; i < b1; i += step) out[i] = add ? add1(x[i]) : x[i];
  const uint4* src = reinterpret_cast<const uint4*>(x);
  uint4* dst = reinterpret_cast<uint4*>(out);
  size_t u = a0 / 16 + threadIdx.x;
  const size_t ue = a1 / 16;
  for (; u + 3 * step < ue; u += 4 * step) {  // four loads in flight per thread
    uint4 v0 = src[u], v1 = src[u + step], v2 = src[u + 2 * step], v3 = src[u + 3 * step];
    if (add) {
      v0 = add1(v0);
      v1 = add1(v1);
      v2 = add1(v2);
      v3 = add1(v3);
    }
    dst[u] = v0;
    dst[u + step] = v1;
    dst[u + 2 * step] = v2;
    dst[u + 3 * step] = v3;
  }
  for (; u < ue; u += step) dst[u] = add ? add1(src[u]) : src[u];
}

__global__ void __launch_bounds__(GRID_THREADS)
    grid_copy_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ out, long long total,
                     long long per_block, int add) {
  const size_t b0 = static_cast<size_t>(blockIdx.x) * static_cast<size_t>(per_block);
  copy_span(out, x, b0, lo(static_cast<size_t>(total), b0 + static_cast<size_t>(per_block)), add);
}

// ---- the cp.async ring

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// a 16-byte shared-memory load the compiler may not replace by a value it holds
__device__ __forceinline__ uint4 lds16(const uint4* p) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(smem_addr(p))
               : "memory");
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most `pending` of this thread's newest groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

enum RingCompute { RING_NONE = 0, RING_ADD = 1, RING_SEP = 2 };

struct RingShape {
  long long total, units;  // bytes; whole 16-byte units
  long long step, piece;   // units per step (bi images), per block's piece of a step
  long long nsteps;
  int slots, depth;
};

template <int COMPUTE>
__global__ void __launch_bounds__(qt::THREADS)
    ring_copy_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ out, RingShape s) {
  extern __shared__ __align__(16) uint4 ring[];  // slots x piece units (x 2 for RING_SEP)
  uint4* obuf = ring + static_cast<size_t>(s.slots) * s.piece;
  const uint4* src = reinterpret_cast<const uint4*>(x);
  uint4* dst = reinterpret_cast<uint4*>(out);

  // this block's piece of step j: units [begin, begin + count)
  auto piece = [&](long long j, long long& begin) -> long long {
    if (j >= s.nsteps) return 0;
    begin = j * s.step + static_cast<long long>(blockIdx.x) * s.piece;
    const long long end = lo(lo(begin + s.piece, (j + 1) * s.step), s.units);
    return hi(0LL, end - begin);
  };
  auto issue = [&](long long j) {
    long long begin = 0;
    const long long n = piece(j, begin);
    uint4* slot = ring + static_cast<size_t>(j % s.slots) * s.piece;
    for (long long u = threadIdx.x; u < n; u += blockDim.x) cp_async16(slot + u, src + begin + u);
    cp_async_commit();  // one group per step, empty or not
  };

  for (int j = 0; j < s.depth; ++j) issue(j);
  for (long long i = 0; i < s.nsteps; ++i) {
    cp_async_wait(s.depth - 1);  // step i's group has landed
    long long begin = 0;
    const long long n = piece(i, begin);
    const size_t off = static_cast<size_t>(i % s.slots) * s.piece;
    for (long long u = threadIdx.x; u < n; u += blockDim.x) {
      uint4 v = ring[off + u];
      if (COMPUTE == RING_ADD) v = add1(v);
      if (COMPUTE == RING_SEP) {  // the in -> out buffer copy, then the store from the out buffer
        obuf[off + u] = v;
        v = lds16(obuf + off + u);
      }
      dst[begin + u] = v;
    }
    issue(i + s.depth);
  }
  cp_async_wait(0);
  if (blockIdx.x == 0) {
    for (long long b = s.units * 16 + threadIdx.x; b < s.total; b += blockDim.x)
      out[b] = COMPUTE == RING_ADD ? add1(x[b]) : x[b];
  }
}

// ---- TMA bulk copies on an mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_load(void* smem, const void* gmem, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(bytes), "r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void bulk_store(void* gmem, const void* smem, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(gmem), "r"(smem_addr(smem)),
               "r"(bytes)
               : "memory");
}

__global__ void __launch_bounds__(qt::THREADS)
    bulk_copy_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ out, long long total, int streams) {
  extern __shared__ __align__(128) int8_t buf[];  // streams x BULK_CHUNK
  __shared__ __align__(8) uint64_t bars[MAX_STREAMS];
  const long long vbytes = total & ~15LL;  // whole 16-byte units: what a bulk copy takes
  const long long nchunks = (vbytes + BULK_CHUNK - 1) / BULK_CHUNK;
  if (threadIdx.x == 0) {
    for (int st = 0; st < streams; ++st) mbar_init(&bars[st]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    uint32_t parity = 0;
    for (long long g = static_cast<long long>(blockIdx.x) * streams; g < nchunks;
         g += static_cast<long long>(gridDim.x) * streams) {
      const int n = static_cast<int>(lo(static_cast<long long>(streams), nchunks - g));
      for (int st = 0; st < n; ++st) {  // `streams` loads in flight
        const long long at = (g + st) * BULK_CHUNK;
        const uint32_t bytes = static_cast<uint32_t>(lo(static_cast<long long>(BULK_CHUNK), vbytes - at));
        mbar_expect_tx(&bars[st], bytes);
        bulk_load(buf + st * BULK_CHUNK, x + at, bytes, &bars[st]);
      }
      for (int st = 0; st < n; ++st) {  // each stored as soon as it has landed
        const long long at = (g + st) * BULK_CHUNK;
        const uint32_t bytes = static_cast<uint32_t>(lo(static_cast<long long>(BULK_CHUNK), vbytes - at));
        mbar_wait(&bars[st], parity);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        bulk_store(out + at, buf + st * BULK_CHUNK, bytes);
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");  // the buffers may be refilled
      parity ^= 1u;
    }
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
  if (blockIdx.x == 0) {
    for (long long b = vbytes + threadIdx.x; b < total; b += blockDim.x) out[b] = x[b];
  }
}

}  // namespace

// out = x (+1 per byte if add); one block per per_block bytes (bi images).
extern "C" int qt_grid_copy(const void* x, void* out, long long total, long long per_block, int add,
                            void* stream) {
  if (total < 1 || per_block < 1 || !qt::aligned16(x) || !qt::aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (total + per_block - 1) / per_block;
  grid_copy_kernel<<<static_cast<unsigned>(blocks), GRID_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<int8_t*>(out), total, per_block, add);
  return static_cast<int>(cudaGetLastError());
}

// out = x through a ring of `slots` pieces per block, `depth` steps of
// step_bytes (bi images) ahead, on `blocks` persistent blocks; compute 0
// none, 1 +1 per byte, 2 a separate out buffer.
extern "C" int qt_ring_copy(const void* x, void* out, long long total, long long step_bytes, int slots,
                            int depth, int compute, int blocks, void* stream) {
  if (total < 1 || step_bytes < 16 || blocks < 1 || depth < 1 || depth > slots || depth > MAX_DEPTH ||
      compute < RING_NONE || compute > RING_SEP || !qt::aligned16(x) || !qt::aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  RingShape s{};
  s.total = total;
  s.units = total / 16;
  s.step = step_bytes / 16;
  s.piece = (s.step + blocks - 1) / blocks;
  s.nsteps = (s.units + s.step - 1) / s.step;
  s.slots = slots;
  s.depth = depth;
  const size_t smem = static_cast<size_t>(slots) * s.piece * 16 * (compute == RING_SEP ? 2 : 1);
  const dim3 grid(blocks);
  const auto* xi = static_cast<const int8_t*>(x);
  auto* oi = static_cast<int8_t*>(out);
  if (compute == RING_ADD) return qt::launch(ring_copy_kernel<RING_ADD>, grid, smem, stream, xi, oi, s);
  if (compute == RING_SEP) return qt::launch(ring_copy_kernel<RING_SEP>, grid, smem, stream, xi, oi, s);
  return qt::launch(ring_copy_kernel<RING_NONE>, grid, smem, stream, xi, oi, s);
}

// out = x by TMA bulk copies of 32 KB, `streams` in flight per block.
extern "C" int qt_bulk_copy(const void* x, void* out, long long total, int streams, int blocks, void* stream) {
  if (total < 1 || streams < 1 || streams > MAX_STREAMS || blocks < 1 || !qt::aligned16(x) ||
      !qt::aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long chunks = ((total & ~15LL) + BULK_CHUNK - 1) / BULK_CHUNK;
  const long long groups = (chunks + streams - 1) / streams;
  const dim3 grid(static_cast<unsigned>(hi(1LL, lo(static_cast<long long>(blocks), groups))));
  return qt::launch(bulk_copy_kernel, grid, static_cast<size_t>(streams) * BULK_CHUNK, stream,
                    static_cast<const int8_t*>(x), static_cast<int8_t*>(out), total, streams);
}
