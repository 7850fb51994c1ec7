// The Hopper GEMM of K1 (int8_gemm.cu) and B6 (int4_gemm.cu): swap-AB tiles
// on wgmma, a TMA ring on mbarriers, and a K split across a thread-block
// cluster.
//
//   acc[m, n] = sum_k A[m, k] * W[n, k]    A (M, K) s8 activations, W (N, K) s8
//
// Swap AB. The block computes the transposed tile D^T = W . A^T: 64 weight
// rows fill wgmma's 64-row M side and BT batch rows (a tile width of 8, 16,
// 32, 64 or 128) its N side, so at a serving batch of 1 to 32 the tensor
// cores multiply no padding rows of A. Both operands are K-major int8, the
// only layout wgmma takes for s8. The per-column epilogue constants alpha[n]
// and beta[n] become per-accumulator-row constants; the store transposes
// back to out[m * N + n] (f32: every warp store covers whole 32-byte
// sectors; s8: staged through shared memory, then 16-byte row stores).
//
// The TMA ring. A stage is 128 K bytes: one 128-byte swizzle row of a 64 x
// 128 weight tile and of a BT x 128 activation tile (two for B6: the columns
// j0.. and Kh + j0.. that meet the low and the high nibbles), loaded by TMA
// (cp.async.bulk.tensor, 128-byte swizzle, the layout wgmma's descriptors
// read) onto one mbarrier per slot. Up to 8 stages are in flight. A stage's
// wgmmas retire while the next stage is waited for (wait_group 1); thread 0
// then refills its slot with the stage `stages` ahead. TMA zero-fills
// outside the tensor, so ragged M, N and K need no masking: a zero weight
// byte adds nothing, whatever A holds there.
//
// The K split. gemm_plan (ops/int8_matmul.py) cuts the K stages into
// `split` contiguous runs of `steps` stages, none empty, one block each, so
// that the ceil(N/64) * ceil(M/BT) * split blocks reach half of the 132 SMs
// at serving batches, in one wave. The `split` blocks of one output tile form a cluster (at most 8,
// the portable size): each leaves its int32 partial sums in its shared
// memory, and the leader adds them through distributed shared memory and
// runs the epilogue. Integer addition is exact in any order, so the output
// is bit-identical to an unsplit product.
//
// B6 reads W as wgmma's register-sourced A operand: each packed 32-bit word
// at an A-fragment position gives the fragment of K columns j..j+3 (low
// nibbles) and of Kh+j..Kh+j+3 (high nibbles), so each packed byte leaves
// shared memory once and is unpacked in registers only.
//
// TMA needs 16-byte-aligned bases and row pitches: the C entries take this
// path where K (B6: Kh and Ka = 2*Kh) is a multiple of 16 and both bases
// are 16-byte aligned, and the mma.sync tile (int8_mma.cuh) everywhere else.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <mutex>
#include <type_traits>

#include "int8_mma.cuh"

namespace qt90 {

constexpr int BK = 128;        // K bytes per ring stage: one 128-byte swizzle row
constexpr int WROWS = 64;      // weight rows per block: wgmma's M
constexpr int THREADS = 128;   // one warpgroup
constexpr int MAX_SPLIT = 8;   // portable cluster size
constexpr int MAX_STAGES = 8;
constexpr int OUT_PITCH = 80;  // bytes per row of the staged s8 output tile

__host__ __device__ constexpr int stage_bytes(int tile, bool packed) {
  return WROWS * BK + tile * BK * (packed ? 2 : 1);
}

// Dynamic shared memory of one block: 1024 bytes to align the ring, the ring
// (reused for the split's partial sums and the staged s8 tile), the mbarriers.
__host__ __device__ constexpr int region_bytes(int tile, bool packed, int split, int stages) {
  const int ring = stages * stage_bytes(tile, packed);
  const int red = split > 1 ? THREADS * (tile / 2) * 4 : 0;
  const int out = tile * OUT_PITCH;
  const int m = ring > red ? ring : red;
  return m > out ? m : out;
}
__host__ __device__ constexpr int smem_bytes(int tile, bool packed, int split, int stages) {
  return 1024 + region_bytes(tile, packed, split, stages) + 8 * stages;
}

// ---- wgmma m64nNk32 s32 += s8 x s8; A from a descriptor (ss) or registers (rs)

template <int N> struct Wgmma;

template <> struct Wgmma<8> {
  static __device__ __forceinline__ void ss(int (&d)[4], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
        "{%0, %1, %2, %3}, %4, %5, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "l"(a), "l"(b), "r"(1));
  }
  static __device__ __forceinline__ void rs(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
  }
};

template <> struct Wgmma<16> {
  static __device__ __forceinline__ void ss(int (&d)[8], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "l"(a), "l"(b), "r"(1));
  }
  static __device__ __forceinline__ void rs(int (&d)[8], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
  }
};

template <> struct Wgmma<32> {
  static __device__ __forceinline__ void ss(int (&d)[16], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
  static __device__ __forceinline__ void rs(int (&d)[16], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
  }
};

template <> struct Wgmma<64> {
  static __device__ __forceinline__ void ss(int (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
  static __device__ __forceinline__ void rs(int (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
  }
};

template <> struct Wgmma<128> {
  static __device__ __forceinline__ void ss(int (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
  static __device__ __forceinline__ void rs(int (&d)[64], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// K-major tile of 128-byte rows, 128-byte swizzle, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across a wgmma fence or wait
template <int R> __device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// keep register A operands in their registers until here (a wgmma in flight reads them)
__device__ __forceinline__ void fence_frag(uint32_t (&f)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(f[i][r])::"memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// box {128 bytes, rows} at (column c0, row c1) of a 2-D tensor map
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the int32 at shared address `saddr` of the cluster's block `rank`
__device__ __forceinline__ int ld_cluster(uint32_t saddr, int rank) {
  uint32_t remote;
  int v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(saddr), "r"(rank));
  asm volatile("ld.shared::cluster.u32 %0, [%1];\n" : "=r"(v) : "r"(remote) : "memory");
  return v;
}

// Sign-extended low / high nibbles of four packed bytes, four int8 results:
// ((p & 0xF) ^ 8) - 8 and (((p >> 4) & 0xF) ^ 8) - 8 per byte (__vsub4
// subtracts per byte, wrapping, with no borrow between bytes).
__device__ __forceinline__ uint32_t lo_nibbles(uint32_t w) {
  return __vsub4((w & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}
__device__ __forceinline__ uint32_t hi_nibbles(uint32_t w) {
  return __vsub4(((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

struct Epilogue {
  const float* alpha;
  const float* beta;
  void* out;
  int relu, requant;
  float inv, zps, lo;
};

// Grid (split, ceil(N/64), ceil(M/BT)), clusters of (split, 1, 1); block
// (s, y, z) multiplies weight rows 64y.. by batch rows BT*z.. over K stages
// [s*steps, min((s+1)*steps, nk)). PACKED: W is (N, kspan) split-half packed
// int4 and A is (M, 2*kspan); else W is (N, kspan) s8 and A (M, kspan).
template <int BT, bool PACKED>
__global__ void __launch_bounds__(THREADS) gemm_sm90_kernel(const __grid_constant__ CUtensorMap tw,
                                                            const __grid_constant__ CUtensorMap ta, Epilogue ep,
                                                            int M, int N, int kspan, int steps, int stages) {
  constexpr int R = BT / 2;  // accumulator registers per thread
  constexpr int STAGE = stage_bytes(BT, PACKED);
  constexpr int ATILE = BT * BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* base = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const uint32_t sbase = smem_u32(base);
  const int split = gridDim.x;
  const uint32_t bars = sbase + ((region_bytes(BT, PACKED, split, stages) + 7) & ~7);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int rank = blockIdx.x, n0 = blockIdx.y * WROWS, m0 = blockIdx.z * BT;
  const int nk = (kspan + BK - 1) / BK;
  const int kb0 = rank * steps;
  const int nloc = min(steps, nk - kb0);

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(bars + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto issue = [&](int i) {  // stage i of this block into slot i % stages (thread 0)
    const int slot = i % stages;
    const uint32_t w = sbase + slot * STAGE, bar = bars + 8 * slot;
    const int k = (kb0 + i) * BK;
    mbar_expect_tx(bar, STAGE);
    tma_load(w, &tw, bar, k, n0);
    tma_load(w + WROWS * BK, &ta, bar, k, m0);
    if (PACKED) tma_load(w + WROWS * BK + ATILE, &ta, bar, kspan + k, m0);
  };
  if (tid == 0)
    for (int i = 0; i < min(stages, nloc); ++i) issue(i);

  // the epilogue's constants, loaded while the ring fills; accumulator
  // v = 4j + e holds (row 16*warp + g + 8*(e >> 1), column 8j + 2t + (e & 1))
  const int nr[2] = {n0 + 16 * warp + g, n0 + 16 * warp + g + 8};
  float al[2], be[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = min(nr[h], N - 1);
    if (ep.requant) {
      al[h] = __fmul_rn(ep.alpha[n], ep.inv);
      be[h] = __fadd_rn(__fmul_rn(ep.beta[n], ep.inv), ep.zps);
    } else {
      al[h] = ep.alpha[n];
      be[h] = ep.beta[n];
    }
  }

  int acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0;

  // A stage's wgmmas retire one stage later (wait_group 1), so the tensor
  // cores run while the next stage is waited for and unpacked; its slot is
  // refilled then. B6 keeps two stages of A fragments, alternating, since a
  // wgmma reads its register operands until it retires.
  uint32_t frag[2][8][4] = {};  // PACKED: [stage parity][2 * kk + high half][fragment register]
  auto consume = [&](int i, auto parity) {
    constexpr int P = decltype(parity)::value;
    const int slot = i % stages;
    mbar_wait(bars + 8 * slot, (i / stages) & 1);
    const uint32_t w = sbase + slot * STAGE, a = w + WROWS * BK;
    if constexpr (PACKED) {
      // fragment rows 16*warp + g and + 8, K bytes 4t.. and 16 + 4t.. of each
      // 32-byte step; the 128-byte swizzle moves 16-byte chunk c of row r to c ^ (r & 7)
      const uint8_t* wt = base + slot * STAGE + (16 * warp + g) * BK + 4 * t;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int c0 = ((2 * kk) ^ g) << 4, c1 = ((2 * kk + 1) ^ g) << 4;
        const uint32_t p[4] = {*reinterpret_cast<const uint32_t*>(wt + c0),
                               *reinterpret_cast<const uint32_t*>(wt + 8 * BK + c0),
                               *reinterpret_cast<const uint32_t*>(wt + c1),
                               *reinterpret_cast<const uint32_t*>(wt + 8 * BK + c1)};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          frag[P][2 * kk][r] = lo_nibbles(p[r]);
          frag[P][2 * kk + 1][r] = hi_nibbles(p[r]);
        }
      }
      wgmma_fence();
      fence_acc(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t(&lo)[4] = frag[P][2 * kk];
        uint32_t(&hi)[4] = frag[P][2 * kk + 1];
        Wgmma<BT>::rs(acc, lo[0], lo[1], lo[2], lo[3], sw128_desc(a) + 2 * kk);
        Wgmma<BT>::rs(acc, hi[0], hi[1], hi[2], hi[3], sw128_desc(a + ATILE) + 2 * kk);
      }
    } else {
      wgmma_fence();
      fence_acc(acc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) Wgmma<BT>::ss(acc, sw128_desc(w) + 2 * kk, sw128_desc(a) + 2 * kk);
    }
    wgmma_commit();
    wgmma_wait<1>();  // stage i - 1 has retired: its fragments and its slot are free
    fence_acc(acc);
    if constexpr (PACKED) fence_frag(frag[1 - P]);  // kept in their registers until now
    __syncthreads();  // every warp is done with slot i - 1 before TMA refills it
    if (tid == 0 && i >= 1 && i - 1 + stages < nloc) issue(i - 1 + stages);
  };
  int i = 0;
  for (; i + 1 < nloc; i += 2) {
    consume(i, std::integral_constant<int, 0>{});
    consume(i + 1, std::integral_constant<int, 1>{});
  }
  if (i < nloc) consume(i, std::integral_constant<int, 0>{});
  wgmma_wait<0>();
  fence_acc(acc);
  if constexpr (PACKED) {
    fence_frag(frag[0]);
    fence_frag(frag[1]);
  }

  if (split > 1) {  // the leader adds the other blocks' partial sums
    int* red = reinterpret_cast<int*>(base);
#pragma unroll
    for (int v = 0; v < R; ++v) red[v * THREADS + tid] = acc[v];
    cluster_sync();
    if (rank == 0) {
      for (int r = 1; r < split; ++r) {
#pragma unroll
        for (int v = 0; v < R; ++v) acc[v] += ld_cluster(sbase + 4 * (v * THREADS + tid), r);
      }
    }
    cluster_sync();  // no block leaves while the leader reads its shared memory
    if (rank != 0) return;
  }

  if (!ep.requant) {
    float* out = static_cast<float*>(ep.out);
#pragma unroll
    for (int v = 0; v < R; ++v) {
      const int h = (v >> 1) & 1, m = m0 + 8 * (v >> 2) + 2 * t + (v & 1), n = nr[h];
      if (m < M && n < N) {
        float y = __fadd_rn(__fmul_rn(static_cast<float>(acc[v]), al[h]), be[h]);
        if (ep.relu) y = fmaxf(y, 0.0f);
        out[(size_t)m * N + n] = y;
      }
    }
    return;
  }
  // s8: through a BT x 64 tile in shared memory, then whole rows of the output
  int8_t* tile = reinterpret_cast<int8_t*>(base);
#pragma unroll
  for (int v = 0; v < R; ++v) {
    const int h = (v >> 1) & 1;
    tile[(8 * (v >> 2) + 2 * t + (v & 1)) * OUT_PITCH + 16 * warp + g + 8 * h] =
        qt::requant(acc[v], al[h], be[h], ep.lo);
  }
  __syncthreads();
  int8_t* out = static_cast<int8_t*>(ep.out);
  const int rows = min(BT, M - m0), cols = min(WROWS, N - n0);
  if (N % 16 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    for (int i = tid; i < rows * (WROWS / 16); i += THREADS) {
      const int r = i / (WROWS / 16), c = (i % (WROWS / 16)) * 16;
      if (c < cols)
        *reinterpret_cast<uint4*>(out + (size_t)(m0 + r) * N + n0 + c) =
            *reinterpret_cast<const uint4*>(tile + r * OUT_PITCH + c);
    }
  } else {
    for (int i = tid; i < rows * WROWS; i += THREADS) {
      const int r = i / WROWS, c = i % WROWS;
      if (c < cols) out[(size_t)(m0 + r) * N + n0 + c] = tile[r * OUT_PITCH + c];
    }
  }
}

// ---- host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (a libcuda function), fetched through the runtime's
// entry-point query, so the build links no -lcuda
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// The tensor map of an int8 (rows, cols) row-major matrix in boxes of
// (box_rows, 128 bytes), 128-byte swizzle, zero fill outside. Encoding takes
// host time, so maps are kept, keyed by everything they encode (a weight's
// pointer and shape are fixed per layer; activations come back to the same
// few pointers from PyTorch's caching allocator).
inline bool tensor_map(CUtensorMap* map, const void* p, int rows, int cols, int box_rows) {
  struct Key {
    const void* p;
    int rows, cols, box_rows;
  };
  constexpr int SLOTS = 256;
  static std::mutex mu;
  static Key keys[SLOTS];
  static CUtensorMap maps[SLOTS];
  static int used = 0, next = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    const Key& k = keys[i];
    if (k.p == p && k.rows == rows && k.cols == cols && k.box_rows == box_rows) {
      *map = maps[i];
      return true;
    }
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(BK), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(p), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  keys[next] = Key{p, rows, cols, box_rows};
  maps[next] = *map;
  next = (next + 1) % SLOTS;
  used = used < SLOTS ? used + 1 : SLOTS;
  return true;
}

// Whether the TMA path takes this call: 16-byte row pitches and bases.
inline bool tma_ok(const void* a, const void* w, int kspan, int ka, bool packed) {
  return kspan % 16 == 0 && ka % 16 == 0 && (!packed || ka == 2 * kspan) && qt::aligned16(a) &&
         qt::aligned16(w);
}

template <int BT, bool PACKED>
int launch_tile(const CUtensorMap& tw, const CUtensorMap& ta, const Epilogue& ep, int M, int N, int kspan,
                int split, int steps, int stages, int smem, cudaStream_t stream) {
  auto kernel = gemm_sm90_kernel<BT, PACKED>;
  static std::atomic<bool> opted_in{false};  // the full shared memory, asked for once per instance
  cudaError_t err;
  if (!opted_in.load()) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, qt::SMEM_LIMIT);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in.store(true);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, (N + WROWS - 1) / WROWS, (M + BT - 1) / BT);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, tw, ta, ep, M, N, kspan, steps, stages);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// One launch of the plan (tile, split, steps, stages, smem) from gemm_plan;
// 0 or the CUDA error. The caller has checked tma_ok.
template <bool PACKED>
int launch_gemm(const void* a, const void* w, const Epilogue& ep, int M, int N, int kspan, int ka, int tile,
                int split, int steps, int stages, int smem, void* stream) {
  const int nk = (kspan + BK - 1) / BK;
  const bool plan_ok = split >= 1 && split <= MAX_SPLIT && steps >= 1 && (split - 1) * steps < nk &&
                       split * steps >= nk && stages >= (steps > 1 ? 2 : 1) && stages <= MAX_STAGES && stages <= steps &&
                       smem == smem_bytes(tile, PACKED, split, stages) && smem <= qt::SMEM_LIMIT;
  if (!plan_ok || M < 1 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tw, ta;
  if (!tensor_map(&tw, w, N, kspan, WROWS) || !tensor_map(&ta, a, M, ka, tile))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 8: return launch_tile<8, PACKED>(tw, ta, ep, M, N, kspan, split, steps, stages, smem, s);
    case 16: return launch_tile<16, PACKED>(tw, ta, ep, M, N, kspan, split, steps, stages, smem, s);
    case 32: return launch_tile<32, PACKED>(tw, ta, ep, M, N, kspan, split, steps, stages, smem, s);
    case 64: return launch_tile<64, PACKED>(tw, ta, ep, M, N, kspan, split, steps, stages, smem, s);
    case 128: return launch_tile<128, PACKED>(tw, ta, ep, M, N, kspan, split, steps, stages, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace qt90
