// B6: int8 activations times split-half packed int4 weights, with the fused
// per-column epilogue.
//
// Replaces the Pallas kernel _int4_matmul_kernel behind int4_matmul
// (quantized_tpu/ops/int4.py:180 and :221).
//
//   W packed K-major: (N, Kh) bytes; byte j of row n holds w[j, n] in its low
//   nibble and w[j + Kh, n] in its high nibble (two's complement, [-8, 7]).
//   acc[m, n] = sum_j A[m, j] * lo(W[n, j]) + A[m, Kh + j] * hi(W[n, j])
//   f32 form:     y = acc * alpha[n] + beta[n], then ReLU if asked
//   requant form: q = clip(rint(acc * (alpha[n] * inv) + (beta[n] * inv + zps)),
//                          lo, 127) -> s8, _int4_matmul_kernel's order
//   A is (M, Ka), Ka = 2*Kh, or 2*Kh - 1 when K was odd: the missing column
//   multiplies the packing pad (a zero weight) and is read as 0.
//
// What bounds it on the H100: at serving batches (AlexNet's fc head, M = 1 to
// 128) the packed weights are nearly all of the bytes (fc1: 18.9 MB), so the
// bound is those bytes over 3.35 TB/s, half of the int8 GEMM's. The first
// version was K1's mma.sync tile with an unpack step: 16-64 blocks on 132 SMs,
// no load/compute overlap, and both unpacked tiles written back to shared
// memory; it lost 3-6.6x to torch._int_mm on twice the bytes. It now runs
// K1's Hopper GEMM (gemm_sm90.cuh) with PACKED set: the packed weight tile
// arrives by TMA, each 32-bit word at a wgmma A-fragment position is read
// from shared memory once and unpacked in registers into the fragments of
// K columns j.. (low nibbles) and Kh + j.. (high nibbles), which multiply
// the activation tiles at j0 and Kh + j0 as wgmma's register-sourced A
// operand; the K split and the ring are K1's. Shapes TMA cannot take (Kh %
// 16 != 0, odd K, an unaligned base) keep the first version's tile below.
//
// The epilogue uses __fmul_rn/__fadd_rn (and the build passes -fmad=false),
// so it rounds exactly as the plain PyTorch version does; rintf rounds half
// to even, as torch.round does.

#include "gemm_sm90.cuh"

namespace {

using qt90::hi_nibbles;
using qt90::lo_nibbles;

// The general path (the first version's tile, in single bytes). Stage
// A[r0 + r, col0 + j] for j in [j0, j0 + BK), zero where r0 + r >= M or
// j >= limit (limit: the half's width, clipped to A's row length).
__device__ __forceinline__ void stage_a(int8_t* S, const int8_t* A, int M, int lda, int col0,
                                        int limit, int r0, int j0) {
  for (int i = threadIdx.x; i < qt::BM * qt::BK; i += qt::THREADS) {
    const int r = i / qt::BK, c = i % qt::BK;
    const int row = r0 + r, j = j0 + c;
    S[r * qt::LDS + c] = (row < M && j < limit) ? A[(size_t)row * lda + col0 + j] : int8_t(0);
  }
}

// Stage packed W[n0 + r, j0 .. j0 + BK) and unpack it into the low-nibble
// tile Wlo and the high-nibble tile Whi; zero (both nibbles 0) outside W.
__device__ __forceinline__ void stage_w(int8_t* Wlo, int8_t* Whi, const int8_t* W, int N, int Kh,
                                        int n0, int j0) {
  for (int i = threadIdx.x; i < qt::BN * qt::BK; i += qt::THREADS) {
    const int r = i / qt::BK, c = i % qt::BK;
    const int row = n0 + r, j = j0 + c;
    const uint32_t p = (row < N && j < Kh) ? static_cast<uint8_t>(W[(size_t)row * Kh + j]) : 0u;
    Wlo[r * qt::LDS + c] = static_cast<int8_t>(lo_nibbles(p) & 0xFFu);
    Whi[r * qt::LDS + c] = static_cast<int8_t>(hi_nibbles(p) & 0xFFu);
  }
}

__global__ void __launch_bounds__(qt::THREADS)
    int4_matmul_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ W,
                       const float* __restrict__ alpha, const float* __restrict__ beta,
                       void* __restrict__ out, int M, int N, int Kh, int Ka, int relu, int requant,
                       float inv, float zps, float lo) {
  __shared__ __align__(16) int8_t Alo[qt::BM * qt::LDS];
  __shared__ __align__(16) int8_t Ahi[qt::BM * qt::LDS];
  __shared__ __align__(16) int8_t Wlo[qt::BN * qt::LDS];
  __shared__ __align__(16) int8_t Whi[qt::BN * qt::LDS];
  const int m0 = blockIdx.x * qt::BM, n0 = blockIdx.y * qt::BN;
  const int hi_limit = min(Kh, Ka - Kh);  // the high half is one column short when K is odd

  qt::Acc acc = {};
  for (int j0 = 0; j0 < Kh; j0 += qt::BK) {
    stage_a(Alo, A, M, Ka, 0, Kh, m0, j0);
    stage_a(Ahi, A, M, Ka, Kh, hi_limit, m0, j0);
    stage_w(Wlo, Whi, W, N, Kh, n0, j0);
    __syncthreads();
    qt::mma_tile(Alo, Wlo, acc);
    qt::mma_tile(Ahi, Whi, acc);
    __syncthreads();
  }

  qt::for_each_acc(acc, [&](int r, int c, int a) {
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) return;
    const float af = static_cast<float>(a);
    if (requant) {
      const float alpha2 = __fmul_rn(alpha[n], inv);
      const float beta2 = __fadd_rn(__fmul_rn(beta[n], inv), zps);
      float q = rintf(__fadd_rn(__fmul_rn(af, alpha2), beta2));
      q = fminf(fmaxf(q, lo), 127.0f);
      static_cast<int8_t*>(out)[(size_t)m * N + n] = static_cast<int8_t>(static_cast<int>(q));
    } else {
      float y = __fadd_rn(__fmul_rn(af, alpha[n]), beta[n]);
      if (relu) y = fmaxf(y, 0.0f);
      static_cast<float*>(out)[(size_t)m * N + n] = y;
    }
  });
}

}  // namespace

// A (M, Ka) s8, W (N, Kh) split-half packed int4, Ka = 2*Kh or 2*Kh - 1.
// requant = 0: out (M, N) f32, relu?(acc * alpha + beta).
// requant = 1: out (M, N) s8 on the (1/inv, zps + 128) grid; lo = zps when
// ReLU is folded, else -128 (relu is then unused).
// sm90: the route (ops.gemm_route; 1: the Hopper GEMM, 0: the first tile),
// refused where it is not the one the shape and bases take;
// (tile, split, steps, stages, smem): the plan of gemm_plan(..., packed=True).
extern "C" int qt_int4_matmul(const void* a, const void* w, const void* alpha, const void* beta,
                              void* out, int M, int N, int Kh, int Ka, int relu, int requant,
                              float inv, float zps, float lo, int sm90, int tile, int split, int steps,
                              int stages, int smem, void* stream) {
  if (Ka != 2 * Kh && Ka != 2 * Kh - 1) return static_cast<int>(cudaErrorInvalidValue);
  const int tma = qt90::tma_ok(a, w, Kh, Ka, true);
  if (sm90 != tma) return static_cast<int>(cudaErrorInvalidValue);
  if (tma) {
    const qt90::Epilogue ep{static_cast<const float*>(alpha), static_cast<const float*>(beta), out, relu,
                            requant, inv, zps, lo};
    return qt90::launch_gemm<true>(a, w, ep, M, N, Kh, Ka, tile, split, steps, stages, smem, stream);
  }
  const dim3 grid((M + qt::BM - 1) / qt::BM, (N + qt::BN - 1) / qt::BN);
  int4_matmul_kernel<<<grid, qt::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(w),
      static_cast<const float*>(alpha), static_cast<const float*>(beta), out, M, N, Kh, Ka, relu,
      requant, inv, zps, lo);
  return static_cast<int>(cudaGetLastError());
}
