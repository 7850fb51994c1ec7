// B9: copy probes. out = x, or out = x + 1 per byte (wrapping in int8), over
// the layer1 activation of ResNet-50, (B, 56, 56, 256) s8, by three routes.
//
// What bounds them on the H100: bytes only, 2 x the tensor over 3.35 TB/s.
// By Little's law that rate with about 1 us of loaded latency needs some
// 3 MB in flight across the card, some 20 KB on every SM, reads and writes
// together; each design below is about keeping that much in flight.
//
// grid_copy  replaces the auto-pipelined grid copies (bench/fused_probe.py:45,
//            bench/dma_ring_probe.py:132, bench/dma_ring_probe3.py:89). A TPU
//            grid step of `bi` images is a unit of order on one core; carried
//            over as one block per step it left 32 blocks on 132 SMs at batch
//            32 (2 at bi 16) and 1.6 TB/s. Here the step stays the unit a
//            block draws from (a block copies one piece of one step and never
//            crosses a step), but the plan (ops/copy_probe.py copy_plan) cuts
//            every step into pieces of whole 128-byte lines, at most 16 KB,
//            and enough of them for at least two blocks on every SM, whatever
//            bi. A piece goes by one TMA bulk load into shared memory on an
//            mbarrier (the +1 in shared memory) and one bulk store back, issued
//            by one thread, some 13 blocks an SM. Chosen by measurement over a
//            register form (256 threads, each with up to 8 independent 16-byte
//            loads in flight before its stores), since removed: on an H100
//            80GB HBM3 (700 W), `python -m quantized_tpu_torch.probes.dma_ring
//            32 --plans` timed the TMA form at 0.0218-0.0224 ms at 16 KB
//            pieces (0.0223-0.0239 at 4, 8, 32 and 64 KB), the register form
//            at 0.0232-0.0243 at every piece size, Tensor.copy_ at 0.0233.
//
// ring_copy  replaces the hand-rolled S-slot, D-deep DMA rings
//            (bench/dma_ring_probe.py:103, bench/dma_ring_probe2.py:90,
//            bench/dma_ring_probe3.py:164). One persistent block per SM takes
//            the b-th of gridDim.x pieces (whole 128-byte lines) of every
//            `bi`-image step (a step of 0.8 MB an image fits the TPU's VMEM;
//            a block has at most 227 KB). The ring is the TPU's: one thread
//            issues TMA bulk loads (global -> slot, mbarrier::complete_tx) D
//            steps ahead, and sends each slot out by a TMA bulk store (bulk
//            group) with no trip through registers; for "add" and "sep" the
//            block's threads first transform the slot in shared memory (or
//            copy it into the separate out buffer), then fence.proxy.async,
//            then the store. A slot is refilled only after
//            cp.async.bulk.wait_group.read says the store S - D steps back has
//            read it, so the S - D spare slots hold stores in flight while D
//            slots fill, as the TPU's out-DMAs drain there. As on the TPU, the
//            load of step i + D starts once step i has landed, so the card
//            holds at most D steps (D x bi images) of loads in flight: on the
//            H100 that, not the stores, sets the ring's rate (`--plans`: S 8
//            and S 4 at D 2 take the same time; D 1, 2, 4 and 6 at bi 1 take
//            0.043, 0.030, 0.026 and 0.025 ms).
//
// bulk_copy  replaces the raw whole-array DMAs (bench/dma_ring_probe2.py:47,
//            bench/dma_ring_probe3.py:185): the array cut into `streams`
//            contiguous slices, one DMA each on the TPU. Here each slice takes
//            its share of the blocks (ops/copy_probe.py bulk_plan: a few an
//            SM, the SMs counted on the device), and each block streams its share of
//            the slice, whole 128-byte lines, through a ring of `slots` chunk
//            slots in shared memory. One thread issues a TMA bulk load a slot
//            onto the slot's mbarrier and sends each slot out by a bulk store
//            as soon as it has landed, then refills that slot as soon as
//            cp.async.bulk.wait_group.read 0 says its store has read it, so
//            the other slots' loads stay in flight beside the stores, never a
//            wait for every store. The plan (16 KB chunks, 4 slots, 3 blocks
//            an SM: 192 KB of loads in flight an SM) was chosen by
//            `python -m quantized_tpu_torch.probes.dma_ring 32 --plans` on an
//            H100 80GB HBM3 (700 W): at (32, 56, 56, 256) it took 0.0227 ms,
//            as did every plan holding 192 KB an SM (4-32 KB chunks), with
//            Tensor.copy_ at 0.0236; less in flight was slower (16 KB, 4
//            slots at 1 and 2 blocks an SM: 0.0244 and 0.0238; 2 slots at 1
//            block: 0.0250); at batch 128 they took 0.0767-0.0775 against
//            copy_'s 0.0735. Refilling a slot one store later (the issuer
//            waiting on the store before last, one load fewer in flight) was
//            slower at every plan (16 KB, 4 slots, 3 blocks an SM: 0.0234 and
//            0.0774), and is gone. The form the redesign replaced loaded
//            `streams` 32 KB chunks a block, one block an SM, stored them,
//            then waited for every store to read before the next load:
//            0.0252-0.0257 ms against copy_'s 0.0230-0.0232.
//
// TMA bulk copies take whole 16-byte units at 16-byte aligned addresses, and
// the plans cut only whole units; the bytes past the last whole 16 are copied
// one by one by block 0.
//
// Every bulk store follows fence.proxy.async. After the threads' own writes
// to the slot it is required; after a bulk load alone, the write (async
// proxy) reaches the store (async proxy) only through the issuing thread's
// mbarrier wait (generic proxy), an ordering the PTX ISA does not spell out,
// so the fence is kept there too: one instruction a piece, by one thread.

#include "int8_mma.cuh"
#include "sm90.cuh"

namespace {

using qt90::bulk_load;
using qt90::fence_proxy_async;
using qt90::mbar_expect_tx;
using qt90::mbar_init;
using qt90::mbar_wait;
using qt90::smem_u32;

enum RingCompute { RING_NONE = 0, RING_ADD = 1, RING_SEP = 2 };

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

// 16-byte shared-memory accesses the compiler keeps in program order
__device__ __forceinline__ uint4 lds16(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ void sts16(uint32_t a, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(a), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// ---- TMA bulk copies (non-tensor): whole 16-byte units, 16-byte aligned

__device__ __forceinline__ void bulk_store(void* gmem, uint32_t smem, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(gmem), "r"(smem), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }

// every bulk store of this thread complete (written), or at most `pending`
// of its newest groups still reading shared memory
__device__ __forceinline__ void bulk_wait_all() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

__device__ __forceinline__ void bulk_wait_read(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.bulk.wait_group.read 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.bulk.wait_group.read 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.bulk.wait_group.read 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.bulk.wait_group.read 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.bulk.wait_group.read 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.bulk.wait_group.read 7;\n" ::: "memory"); break;  // waits longer: still safe
  }
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// bytes [units * 16, total) one by one: the part no 16-byte unit covers
template <bool ADD>
__device__ __forceinline__ void copy_tail(const int8_t* __restrict__ x, int8_t* __restrict__ out, long long units,
                                          long long total) {
  for (long long b = units * 16 + threadIdx.x; b < total; b += blockDim.x) out[b] = ADD ? add1(x[b]) : x[b];
}

// ---- grid_copy: pieces of steps over the whole card

struct GridShape {
  long long total, units;  // bytes; whole 16-byte units
  long long step, piece;   // units a step (bi images), a piece (the last of a step may be shorter)
  long long per_step;      // pieces a step: block b takes piece b % per_step of step b / per_step
};

__device__ __forceinline__ long long grid_piece(const GridShape& s, long long& begin) {
  const long long j = blockIdx.x / s.per_step;
  begin = j * s.step + (blockIdx.x % s.per_step) * s.piece;
  return lo(lo(begin + s.piece, (j + 1) * s.step), s.units) - begin;
}

// block b's piece by one TMA bulk load into shared memory and one bulk store
template <bool ADD>
__global__ void __launch_bounds__(qt::THREADS)
    grid_copy_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ out, GridShape s) {
  extern __shared__ __align__(128) uint4 piece_buf[];  // s.piece units
  __shared__ __align__(8) uint64_t bar;
  long long begin = 0;
  const long long n = grid_piece(s, begin);
  const uint32_t buf = smem_u32(piece_buf), b = smem_u32(&bar);
  if (n > 0) {
    if (threadIdx.x == 0) {
      mbar_init(b);
      mbar_init_fence();
      mbar_expect_tx(b, static_cast<uint32_t>(n * 16));
      bulk_load(buf, x + begin * 16, static_cast<uint32_t>(n * 16), b);
    }
    if (ADD) {
      __syncthreads();  // the barrier is initialised
      mbar_wait(b, 0);
      for (long long u = threadIdx.x; u < n; u += blockDim.x) sts16(buf + 16 * u, add1(lds16(buf + 16 * u)));
      fence_proxy_async();
      __syncthreads();
    } else if (threadIdx.x == 0) {
      mbar_wait(b, 0);
      fence_proxy_async();
    }
    if (threadIdx.x == 0) {
      bulk_store(out + begin * 16, buf, static_cast<uint32_t>(n * 16));
      bulk_commit();
      bulk_wait_all();
    }
  }
  if (blockIdx.x == 0) copy_tail<ADD>(x, out, s.units, s.total);
}

// ---- ring_copy: the S-slot, D-deep TMA ring

struct RingShape {
  long long total, units;  // bytes; whole 16-byte units
  long long step, piece;   // units a step (bi images), a block's piece of a step
  long long nsteps;
  int slots, depth;
};

// this block's piece of step j: units [begin, begin + count); for every block
// the non-empty pieces are those of a prefix of the steps
__device__ __forceinline__ long long ring_piece(const RingShape& s, long long j, long long& begin) {
  begin = j * s.step + static_cast<long long>(blockIdx.x) * s.piece;
  return hi(0LL, lo(lo(begin + s.piece, (j + 1) * s.step), s.units) - begin);
}

template <int COMPUTE>
__global__ void __launch_bounds__(qt::THREADS)
    ring_copy_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ out, RingShape s) {
  // slots x piece units of the in ring (and as many of the out buffer for
  // RING_SEP), then one mbarrier a slot
  extern __shared__ __align__(128) uint4 ring[];
  const long long ring_units = static_cast<long long>(s.slots) * s.piece;
  const uint32_t in0 = smem_u32(ring);
  const uint32_t out0 = COMPUTE == RING_SEP ? in0 + static_cast<uint32_t>(16 * ring_units) : in0;
  const uint32_t bar0 = in0 + static_cast<uint32_t>(16 * ring_units * (COMPUTE == RING_SEP ? 2 : 1));
  long long begin = 0;
  const long long nst = s.nsteps == 0 || ring_piece(s, 0, begin) == 0 ? 0
                        : ring_piece(s, s.nsteps - 1, begin) == 0 ? s.nsteps - 1
                                                                   : s.nsteps;
  const bool issuer = threadIdx.x == 0;

  auto load = [&](long long j) {  // step j's piece into its slot, by the issuing thread
    long long b = 0;
    const uint32_t bytes = static_cast<uint32_t>(16 * ring_piece(s, j, b));
    const uint32_t slot = static_cast<uint32_t>(j % s.slots);
    mbar_expect_tx(bar0 + 8 * slot, bytes);
    bulk_load(in0 + static_cast<uint32_t>(16 * s.piece) * slot, x + 16 * b, bytes, bar0 + 8 * slot);
  };

  if (issuer) {
    for (int i = 0; i < s.slots; ++i) mbar_init(bar0 + 8 * i);
    mbar_init_fence();
    for (long long j = 0; j < lo(static_cast<long long>(s.depth), nst); ++j) load(j);
  }
  if (COMPUTE != RING_NONE) __syncthreads();  // the barriers are initialised

  if (COMPUTE != RING_NONE || issuer) {
    for (long long i = 0; i < nst; ++i) {
      const uint32_t slot = static_cast<uint32_t>(i % s.slots);
      const uint32_t off = static_cast<uint32_t>(16 * s.piece) * slot;
      const long long n = ring_piece(s, i, begin);
      mbar_wait(bar0 + 8 * slot, static_cast<uint32_t>((i / s.slots) & 1));  // step i has landed
      if (COMPUTE != RING_NONE) {  // +1 in place, or the in -> out buffer copy
        for (long long u = threadIdx.x; u < n; u += blockDim.x) {
          const uint4 v = lds16(in0 + off + 16 * u);
          sts16(out0 + off + 16 * u, COMPUTE == RING_ADD ? add1(v) : v);
        }
        fence_proxy_async();  // the generic-proxy writes before the bulk store reads them
        __syncthreads();
      } else {
        fence_proxy_async();
      }
      if (issuer) {
        bulk_store(out + 16 * begin, out0 + off, static_cast<uint32_t>(16 * n));
        bulk_commit();
        if (i + s.depth < nst) {
          bulk_wait_read(s.slots - s.depth);  // the store of step i + D - S has read the slot
          load(i + s.depth);
        }
      }
    }
    if (issuer) bulk_wait_all();
  }
  if (blockIdx.x == 0) copy_tail<COMPUTE == RING_ADD>(x, out, s.units, s.total);
}

// ---- bulk_copy: every block streams its share of a slice through a ring

struct BulkShape {
  long long total, units;  // bytes; whole 16-byte units
  long long slice, share;  // units a stream's slice, a block's share of it (the last of a slice may be shorter)
  long long per_slice;     // blocks a slice: block b takes share b % per_slice of slice b / per_slice
  int chunk;               // units a slot
  int slots;
};

__global__ void __launch_bounds__(qt::THREADS)
    bulk_copy_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ out, BulkShape s) {
  extern __shared__ __align__(128) uint4 ring[];  // slots x chunk units, then one mbarrier a slot
  const uint32_t in0 = smem_u32(ring);
  const uint32_t bar0 = in0 + static_cast<uint32_t>(16 * s.chunk * s.slots);
  const long long j = blockIdx.x / s.per_slice;
  const long long begin = j * s.slice + (blockIdx.x % s.per_slice) * s.share;
  const long long end = lo(lo(begin + s.share, (j + 1) * s.slice), s.units);
  const long long n = end > begin ? (end - begin + s.chunk - 1) / s.chunk : 0;  // chunks of this block
  if (threadIdx.x == 0 && n > 0) {
    auto io = [&](long long c, uint32_t& slot_addr) {  // chunk c's bytes; its slot's address
      slot_addr = in0 + static_cast<uint32_t>(16 * s.chunk) * static_cast<uint32_t>(c % s.slots);
      return static_cast<uint32_t>(16 * lo(static_cast<long long>(s.chunk), end - begin - c * s.chunk));
    };
    auto load = [&](long long c) {
      uint32_t slot = 0;
      const uint32_t bytes = io(c, slot);
      const uint32_t bar = bar0 + 8 * static_cast<uint32_t>(c % s.slots);
      mbar_expect_tx(bar, bytes);
      bulk_load(slot, x + 16 * (begin + c * s.chunk), bytes, bar);
    };
    for (int i = 0; i < s.slots; ++i) mbar_init(bar0 + 8 * i);
    mbar_init_fence();
    for (long long c = 0; c < lo(static_cast<long long>(s.slots), n); ++c) load(c);
    for (long long i = 0; i < n; ++i) {
      uint32_t slot = 0;
      const uint32_t bytes = io(i, slot);
      mbar_wait(bar0 + 8 * static_cast<uint32_t>(i % s.slots), static_cast<uint32_t>((i / s.slots) & 1));
      fence_proxy_async();
      bulk_store(out + 16 * (begin + i * s.chunk), slot, bytes);
      bulk_commit();
      if (i + s.slots < n) {
        bulk_wait_read(0);  // the store just issued has read the slot: refill it
        load(i + s.slots);
      }
    }
    bulk_wait_all();
  }
  if (blockIdx.x == 0) copy_tail<false>(x, out, s.units, s.total);
}

}  // namespace

// out = x (+1 per byte if add): step_units (bi images) a step, each cut into
// per_step pieces of piece_units, one block a piece (ops/copy_probe.py
// copy_plan).
extern "C" int qt_grid_copy(const void* x, void* out, long long total, long long step_units, long long piece_units,
                            long long per_step, int add, void* stream) {
  if (total < 1 || step_units < 1 || piece_units < 1 || per_step < 1 || piece_units * per_step < step_units ||
      16 * piece_units > qt::SMEM_LIMIT || !qt::aligned16(x) || !qt::aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  GridShape s{};
  s.total = total;
  s.units = total / 16;
  s.step = step_units;
  s.piece = piece_units;
  s.per_step = per_step;
  const long long blocks = hi(1LL, (s.units + s.step - 1) / s.step * per_step);
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  const auto* xi = static_cast<const int8_t*>(x);
  auto* oi = static_cast<int8_t*>(out);
  const size_t smem = static_cast<size_t>(16 * piece_units);
  return add ? qt::launch(grid_copy_kernel<true>, grid, smem, stream, xi, oi, s)
             : qt::launch(grid_copy_kernel<false>, grid, smem, stream, xi, oi, s);
}

// out = x through a ring of `slots` pieces a block, `depth` steps of
// step_units (bi images) ahead, on `blocks` persistent blocks, each the
// piece_units-unit piece of every step; compute 0 none, 1 +1 per byte, 2 a
// separate out buffer (ops/copy_probe.py ring_plan).
extern "C" int qt_ring_copy(const void* x, void* out, long long total, long long step_units, long long piece_units,
                            int slots, int depth, int compute, int blocks, void* stream) {
  if (total < 1 || step_units < 1 || piece_units < 1 || blocks < 1 || depth < 1 || depth > slots ||
      piece_units * blocks < step_units || compute < RING_NONE || compute > RING_SEP || !qt::aligned16(x) ||
      !qt::aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  RingShape s{};
  s.total = total;
  s.units = total / 16;
  s.step = step_units;
  s.piece = piece_units;
  s.nsteps = (s.units + s.step - 1) / s.step;
  s.slots = slots;
  s.depth = depth;
  const size_t smem = static_cast<size_t>(slots) * (16 * piece_units * (compute == RING_SEP ? 2 : 1) + 8);
  const dim3 grid(blocks);
  const auto* xi = static_cast<const int8_t*>(x);
  auto* oi = static_cast<int8_t*>(out);
  if (compute == RING_ADD) return qt::launch(ring_copy_kernel<RING_ADD>, grid, smem, stream, xi, oi, s);
  if (compute == RING_SEP) return qt::launch(ring_copy_kernel<RING_SEP>, grid, smem, stream, xi, oi, s);
  return qt::launch(ring_copy_kernel<RING_NONE>, grid, smem, stream, xi, oi, s);
}

// out = x: `streams` slices of slice_units, each cut into per_slice shares
// of share_units, one block a share, streamed through `slots` slots of
// chunk_units, a slot refilled once its store has read it (ops/copy_probe.py
// bulk_plan).
extern "C" int qt_bulk_copy(const void* x, void* out, long long total, long long slice_units, long long share_units,
                            long long per_slice, int chunk_units, int slots, void* stream) {
  if (total < 1 || slice_units < 1 || share_units < 1 || per_slice < 1 || share_units * per_slice < slice_units ||
      chunk_units < 1 || slots < 1 || !qt::aligned16(x) || !qt::aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  BulkShape s{};
  s.total = total;
  s.units = total / 16;
  s.slice = slice_units;
  s.share = share_units;
  s.per_slice = per_slice;
  s.chunk = chunk_units;
  s.slots = slots;
  const long long blocks = hi(1LL, (s.units + s.slice - 1) / s.slice * per_slice);
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(slots) * (16 * static_cast<size_t>(chunk_units) + 8);
  return qt::launch(bulk_copy_kernel, dim3(static_cast<unsigned>(blocks)), smem, stream,
                    static_cast<const int8_t*>(x), static_cast<int8_t*>(out), s);
}
