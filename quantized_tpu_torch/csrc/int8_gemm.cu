// K1: int8 GEMM with the fused per-column epilogue.
//
// Replaces the Pallas kernels _matmul_kernel and _requant_kernel
// (quantized_tpu/ops/int8_matmul.py:56 and :76, behind int8_matmul :132 and
// int8_matmul_requant :189).
//
//   acc[m, n] = sum_k A[m, k] * W[n, k]                      (s8 x s8 -> s32)
//   f32 form:     y = acc * alpha[n] + beta[n], then the activation (relu: the
//                 code of int8_mma.cuh, qt::activate)
//   requant form: q = clip(rint(acc * (alpha[n] * inv) + (beta[n] * inv + zps)),
//                          lo, 127) -> s8, exactly the order of _requant_kernel,
//                 ReLU folded into lo; under SiLU or the sigmoid (act) K2's
//                 order: q = clip(rint(act(acc * alpha + beta) * inv + zps), lo, 127)
//
// What bounds it on the H100: the fc head (M = batch, K = 2048 to 9216, N =
// 1000 to 4096) moves its weights (2 to 38 MB) for 2*M*K*N operations, so at
// serving batches it is bound by those bytes over 3.35 TB/s; the im2col GEMMs
// of the "gemm" backend (M in the hundreds of thousands, N = 64 to 2048) by
// the activation bytes, their int8 operations close behind. The first tile
// (one 64x64 tile per block walking all of K, mma.sync, no load/compute
// overlap) ran 16-64 blocks on 132 SMs at the fc, with 8 KB in flight per
// block, and lost 3.5-9x to torch._int_mm there. The design now
// (gemm_sm90.cuh): swap-AB tiles on wgmma, so the batch fills the N side
// from 8 to 128 rows; a TMA ring of up to 8 stages of 128 K bytes per block;
// and a K split across a cluster of up to 8 blocks, chosen by gemm_plan
// (ops/int8_matmul.py) so the blocks cover the SMs. Shapes TMA cannot take
// (K % 16 != 0, e.g. the stems' K = 27, 147 and 363, or an unaligned base)
// keep the first tile below, which refuses nothing.
//
// A clamped conv (the RangeBN flavor's observer clamp, on the "gemm"
// backend) passes per-column bounds clip_lo / clip_hi: the f32 form clamps y
// to them before ReLU, the requant form clamps the rounded value to them
// (integer-valued, formed by the wrapper as int8_conv_xla forms them) in
// place of [lo, 127]. They run on CLIP instances of both routes, so the
// unclamped instances carry none of it.
//
// The epilogue uses __fmul_rn/__fadd_rn (and the build passes -fmad=false)
// so no multiply-add is contracted into an FMA: the kernel rounds exactly as
// its plain PyTorch version does, and int8 outputs agree bit for bit.
// rintf rounds half to even, as jnp.round and torch.round do.

#include "gemm_sm90.cuh"

namespace {

template <bool REQUANT, bool CLIP>
__global__ void __launch_bounds__(qt::THREADS)
    int8_matmul_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ W,
                       const float* __restrict__ alpha, const float* __restrict__ beta,
                       const float* __restrict__ clip_lo, const float* __restrict__ clip_hi,
                       void* __restrict__ out, int M, int N, int K, int relu, float inv, float zps,
                       float lo) {
  __shared__ __align__(16) int8_t As[qt::BM * qt::LDS];
  __shared__ __align__(16) int8_t Ws[qt::BN * qt::LDS];
  const int m0 = blockIdx.x * qt::BM, n0 = blockIdx.y * qt::BN;

  qt::Acc acc = {};
  for (int k0 = 0; k0 < K; k0 += qt::BK) {
    qt::stage_rows(As, A, M, K, m0, k0, false);  // single bytes: TMA takes every
    qt::stage_rows(Ws, W, N, K, n0, k0, false);  // shape that 16-byte loads could
    __syncthreads();
    qt::mma_tile(As, Ws, acc);
    __syncthreads();
  }

  qt::for_each_acc(acc, [&](int r, int c, int a) {
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) return;
    const float af = static_cast<float>(a);
    if (REQUANT && relu >= qt::ACT_SILU) {  // y, its activation, then the requant of K2's epilogue
      const float y = qt::activate(__fadd_rn(__fmul_rn(af, alpha[n]), beta[n]), relu);
      const float q = fminf(fmaxf(rintf(__fadd_rn(__fmul_rn(y, inv), zps)), lo), 127.0f);
      static_cast<int8_t*>(out)[(size_t)m * N + n] = static_cast<int8_t>(static_cast<int>(q));
    } else if (REQUANT) {
      const float alpha2 = __fmul_rn(alpha[n], inv);
      const float beta2 = __fadd_rn(__fmul_rn(beta[n], inv), zps);
      float q = rintf(__fadd_rn(__fmul_rn(af, alpha2), beta2));
      if constexpr (CLIP)
        q = fminf(fmaxf(q, clip_lo[n]), clip_hi[n]);
      else
        q = fminf(fmaxf(q, lo), 127.0f);
      static_cast<int8_t*>(out)[(size_t)m * N + n] = static_cast<int8_t>(static_cast<int>(q));
    } else {
      float y = __fadd_rn(__fmul_rn(af, alpha[n]), beta[n]);
      if constexpr (CLIP) y = fminf(fmaxf(y, clip_lo[n]), clip_hi[n]);
      y = qt::activate(y, relu);
      static_cast<float*>(out)[(size_t)m * N + n] = y;
    }
  });
}

// sm90: the route the caller counts this launch by (1: the Hopper GEMM, 0:
// the first tile); a route the shape and bases do not take is refused.
// CLIP: the clamped epilogue, clip_lo / clip_hi not null.
template <bool REQUANT, bool CLIP>
int launch(const void* a, const void* w, const void* alpha, const void* beta, const void* clip_lo,
           const void* clip_hi, void* out, int M, int N, int K, int relu, float inv, float zps, float lo, int sm90,
           int tile, int split, int steps, int stages, int smem, void* stream) {
  const int tma = qt90::tma_ok(a, w, K, K, false);
  if (sm90 != tma) return static_cast<int>(cudaErrorInvalidValue);
  if (tma) {
    const qt90::Epilogue ep{static_cast<const float*>(alpha), static_cast<const float*>(beta), out, relu,
                            REQUANT, inv, zps, lo, static_cast<const float*>(clip_lo),
                            static_cast<const float*>(clip_hi)};
    if (relu >= qt::ACT_SILU)  // SiLU or the sigmoid: instances of their own (never clamped)
      return CLIP ? static_cast<int>(cudaErrorInvalidValue)
                  : qt90::launch_gemm<false, false, true>(a, w, ep, M, N, K, K, tile, split, steps, stages, smem,
                                                          stream);
    return qt90::launch_gemm<false, CLIP>(a, w, ep, M, N, K, K, tile, split, steps, stages, smem, stream);
  }
  const dim3 grid((M + qt::BM - 1) / qt::BM, (N + qt::BN - 1) / qt::BN);
  int8_matmul_kernel<REQUANT, CLIP><<<grid, qt::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(w),
      static_cast<const float*>(alpha), static_cast<const float*>(beta), static_cast<const float*>(clip_lo),
      static_cast<const float*>(clip_hi), out, M, N, K, relu, inv, zps, lo);
  return static_cast<int>(cudaGetLastError());
}

template <bool REQUANT>
int launch_any(const void* a, const void* w, const void* alpha, const void* beta, const void* clip_lo,
               const void* clip_hi, void* out, int M, int N, int K, int relu, float inv, float zps, float lo,
               int sm90, int tile, int split, int steps, int stages, int smem, void* stream) {
  if ((clip_lo == nullptr) != (clip_hi == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if (clip_lo != nullptr)
    return launch<REQUANT, true>(a, w, alpha, beta, clip_lo, clip_hi, out, M, N, K, relu, inv, zps, lo, sm90, tile,
                                 split, steps, stages, smem, stream);
  return launch<REQUANT, false>(a, w, alpha, beta, nullptr, nullptr, out, M, N, K, relu, inv, zps, lo, sm90, tile,
                                split, steps, stages, smem, stream);
}

}  // namespace

// f32 out: act(clip?(acc * alpha + beta)), relu the activation code
// (qt::activate; ReLU alone with a clamp). A (M,K) s8, W (N,K) s8, out
// (M,N) f32. sm90: the route (ops.gemm_route), refused where it is not the
// one taken; (tile, split, steps, stages, smem): the plan of gemm_plan;
// clip_lo, clip_hi: (N,) f32 bounds of y, or both null.
extern "C" int qt_int8_matmul(const void* a, const void* w, const void* alpha, const void* beta,
                              void* out, int M, int N, int K, int relu, int sm90, int tile, int split,
                              int steps, int stages, int smem, const void* clip_lo, const void* clip_hi,
                              void* stream) {
  return launch_any<false>(a, w, alpha, beta, clip_lo, clip_hi, out, M, N, K, relu, 0.0f, 0.0f, 0.0f, sm90, tile,
                           split, steps, stages, smem, stream);
}

// s8 out on the (1/inv, zps + 128) grid; lo = zps when ReLU is folded, else
// -128; act: 0 (ReLU rides lo), or SiLU or the sigmoid before the requant
// (lo -128); clip_lo, clip_hi: (N,) integer-valued f32 bounds in place of
// [lo, 127], or both null (always null under act).
extern "C" int qt_int8_matmul_requant(const void* a, const void* w, const void* alpha,
                                      const void* beta, void* out, int M, int N, int K,
                                      float inv, float zps, float lo, int act, int sm90, int tile, int split,
                                      int steps, int stages, int smem, const void* clip_lo,
                                      const void* clip_hi, void* stream) {
  if (act >= qt::ACT_SILU && clip_lo != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_any<true>(a, w, alpha, beta, clip_lo, clip_hi, out, M, N, K, act, inv, zps, lo, sm90, tile, split,
                          steps, stages, smem, stream);
}
