// Shared block-tile machinery of the int8 kernels (int8_gemm.cu, int8_conv.cu,
// int8_conv_flat.cu, fused_block.cu, fused_dw_pw.cu).
//
// A block computes a 64x64 tile of C = A (M,K) x W (N,K)^T with int32
// accumulation. Both operands are K-major int8, which is exactly the operand
// form of mma.sync.m16n8k32.row.col.s32.s8.s8.s32: every fragment register is
// one aligned 32-bit word of four consecutive K bytes. K is staged through
// shared memory 64 bytes at a time; the 80-byte row pitch keeps 16-byte
// stores aligned and makes the fragment reads of a warp hit 32 distinct banks.
// Four warps each own a 32x32 sub-tile (2 x 4 mma tiles, 32 int32 registers).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace qt {

constexpr int BM = 64;       // output rows per block
constexpr int BN = 64;       // output columns per block
constexpr int BK = 64;       // K bytes staged per step
constexpr int LDS = BK + 16; // shared-memory row pitch in bytes
constexpr int THREADS = 128;

struct Acc {
  int v[2][4][4];
};

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Multiply the staged A tile (BM x BK) by the staged W tile (BN x BK) into acc.
__device__ __forceinline__ void mma_tile(const int8_t* As, const int8_t* Ws, Acc& acc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 32) {
    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int8_t* p = As + (wm + mi * 16 + g) * LDS + kk + t * 4;
      a[mi][0] = *reinterpret_cast<const uint32_t*>(p);
      a[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
      a[mi][2] = *reinterpret_cast<const uint32_t*>(p + 16);
      a[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 16);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int8_t* p = Ws + (wn + ni * 8 + g) * LDS + kk + t * 4;
      b[ni][0] = *reinterpret_cast<const uint32_t*>(p);
      b[ni][1] = *reinterpret_cast<const uint32_t*>(p + 16);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        mma_s8(acc.v[mi][ni], a[mi][0], a[mi][1], a[mi][2], a[mi][3], b[ni][0], b[ni][1]);
  }
}

// Stage rows [r0, r0+64) x bytes [k0, k0+BK) of a K-major int8 matrix of R
// rows at a pitch of ld bytes; zero at and past byte klim of a row and past
// row R (zero weight bytes add nothing to the accumulator).
// vec: ld and klim are multiples of 16 and the base is 16-byte aligned, so
// 16-byte loads apply.
__device__ __forceinline__ void stage_cols(int8_t* S, const int8_t* X, int R, size_t ld, int r0,
                                           int k0, int klim, bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < 64 * (BK / 16); i += THREADS) {
      const int r = i / (BK / 16), c = (i % (BK / 16)) * 16;
      const int row = r0 + r, k = k0 + c;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row < R && k < klim) v = *reinterpret_cast<const uint4*>(X + (size_t)row * ld + k);
      *reinterpret_cast<uint4*>(S + r * LDS + c) = v;
    }
  } else {
    for (int i = threadIdx.x; i < 64 * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      const int row = r0 + r, k = k0 + c;
      S[r * LDS + c] = (row < R && k < klim) ? X[(size_t)row * ld + k] : int8_t(0);
    }
  }
}

// Stage rows [r0, r0+64) x bytes [k0, k0+BK) of a K-major (R, K) int8 matrix;
// zero outside it. vec: K % 16 == 0 and the base is 16-byte aligned.
__device__ __forceinline__ void stage_rows(int8_t* S, const int8_t* X, int R, int K, int r0,
                                           int k0, bool vec) {
  stage_cols(S, X, R, static_cast<size_t>(K), r0, k0, K, vec);
}

// A gathered chunk of CH bytes (16, 4 or 1) as one load, and a chunk of a
// repeated byte pattern
template <int CH> struct Chunk;
template <> struct Chunk<16> {
  using T = uint4;
  static __device__ __forceinline__ T fill(uint32_t p) { return make_uint4(p, p, p, p); }
};
template <> struct Chunk<4> {
  using T = uint32_t;
  static __device__ __forceinline__ T fill(uint32_t p) { return p; }
};
template <> struct Chunk<1> {
  using T = uint8_t;
  static __device__ __forceinline__ T fill(uint32_t p) { return static_cast<uint8_t>(p); }
};

// the four bytes of a stored zero point, for Chunk<CH>::fill
__device__ __forceinline__ uint32_t zp_bytes(int stored) { return 0x01010101u * static_cast<uint8_t>(stored); }

// Visit every accumulator element of this thread with its tile-local
// (row, col), together with the element at the same place in a second
// accumulator of the same tile.
template <typename F>
__device__ __forceinline__ void for_each_acc_pair(const Acc& a, const Acc& b, F&& f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        f(wm + mi * 16 + g + (r >> 1) * 8, wn + ni * 8 + t * 2 + (r & 1), a.v[mi][ni][r],
          b.v[mi][ni][r]);
}

// Visit every accumulator element of this thread with its tile-local (row, col).
template <typename F>
__device__ __forceinline__ void for_each_acc(const Acc& acc, F&& f) {
  for_each_acc_pair(acc, acc, [&](int row, int col, int v, int) { f(row, col, v); });
}

// ---- helpers of the fused kernels (fused_block.cu, fused_dw_pw.cu)

constexpr int SMEM_LIMIT = 232448;  // opt-in shared memory of one block on the H100

__device__ __forceinline__ uint4 ld16(const int8_t* p) { return *reinterpret_cast<const uint4*>(p); }

__device__ __forceinline__ uint4 zero16() { return make_uint4(0u, 0u, 0u, 0u); }

// 16 bytes of a stored zero point
__device__ __forceinline__ uint4 fill16(int stored) { return Chunk<16>::fill(zp_bytes(stored)); }

// The epilogues' activation code (the ``relu`` argument of K1 and K2):
// 0 none, 1 ReLU, 2 SiLU y / (1 + e^-y), 3 the sigmoid 1 / (1 + e^-y).
// expf is the accurate one (no fast math) and each operation rounds once,
// as the plain versions (ops.int8_matmul.activate) compute them. The Hopper
// routes run SiLU and the sigmoid on instances of their own (EXP), so the
// others keep their ReLU epilogue, its registers and its code as they were.
constexpr int ACT_RELU = 1, ACT_SILU = 2, ACT_SIGMOID = 3;

// SiLU or the sigmoid: act >= ACT_SILU
__device__ __forceinline__ float activate_exp(float y, int act) {
  return __fdiv_rn(act == ACT_SIGMOID ? 1.0f : y, __fadd_rn(1.0f, expf(-y)));
}

__device__ __forceinline__ float activate(float y, int act) {
  if (act == ACT_RELU) return fmaxf(y, 0.0f);
  return act >= ACT_SILU ? activate_exp(y, act) : y;
}

// clip(rint(acc*a + b), lo, 127) -> s8, one float32 rounding per operation
// hi: 127, or a clamped conv's per-channel bound (integer-valued, as lo)
__device__ __forceinline__ int8_t requant(int acc, float a, float b, float lo, float hi = 127.0f) {
  float q = rintf(__fadd_rn(__fmul_rn(static_cast<float>(acc), a), b));
  q = fminf(fmaxf(q, lo), hi);
  return static_cast<int8_t>(static_cast<int>(q));
}

inline bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1u)) == 0;
}

inline bool aligned16(const void* p) { return aligned(p, 16); }

// The widest chunk (16, 4 or 1 bytes) that divides a row of c bytes and
// keeps the loads from base aligned
inline int chunk_bytes(int c, const void* base) {
  if (c % 16 == 0 && aligned(base, 16)) return 16;
  if (c % 4 == 0 && aligned(base, 4)) return 4;
  return 1;
}

// Launch with `smem` bytes of dynamic shared memory; 0 or the CUDA error.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, size_t smem, void* stream, Args... args) {
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace qt

extern "C" const char* qt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
