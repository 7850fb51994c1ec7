// K2: direct int8 convolution as an implicit GEMM, with the fused epilogue.
//
// Replaces the Pallas kernels _conv_kernel (per-tap dots) and
// _conv_gatherk_kernel (small Cin, one dot over all taps) behind
// int8_conv_direct (quantized_tpu/ops/int8_conv_pallas.py:57, :106, :383).
//
//   x: NHWC s8 (stored u - 128), not padded;  w: (Cout, Kh*Kw*Cin) s8, K in
//   (kh, kw, c) order;  GEMM rows m = (n, ho, wo), columns = Cout.
//   y = acc * alpha + beta; ReLU if asked; then either f32 out, or
//   q = clip(rint(y * inv + zps), -128, 127) -> s8 (int8_conv_direct's order).
//
// Padding: a tap that falls outside the image reads the stored zero point
// (zp - 128), never 0, so it contributes exactly 0 after the (128 - zp)
// column-sum correction carried in beta.
//
// What bounds it on the H100: ResNet-50's 3x3 convs at batch 128 do
// 2*M*K*N operations against a few bytes per output, so they are bound by the
// int8 tensor-core rate; the 1x1 convs and the late stages have low K*N per
// output byte and are closer to the 3.35 TB/s memory bound. The Pallas kernel
// kept a whole padded image group (about 2 MB) resident in VMEM; a Hopper
// block has at most 227 KB, so this kernel tiles instead: a block owns 64
// output pixels x 64 output channels and gathers its A tile straight from the
// unpadded input by index arithmetic, 64 K bytes at a time. A 16-byte chunk
// of the per-tap form never straddles a tap (Cin % 16 == 0). The gather-K
// form (small Cin, e.g. the space-to-depth stem with Cin = 12 and K = 192)
// lets a K step straddle taps and gathers 4-byte chunks where Cin % 4 == 0,
// else single bytes (the CIFAR stem, Cin = 3 and K = 27). The
// product is mma.sync m16n8k32 on the int8 tensor cores
// (int8_mma.cuh). No load/compute overlap, no wgmma/TMA yet: later work.
//
// The epilogue uses __fmul_rn/__fadd_rn (and the build passes -fmad=false),
// so it rounds exactly as the plain PyTorch version does.

#include "int8_mma.cuh"

namespace {

struct ConvShape {
  int N, H, W, Cin, Cout, KH, KW, SH, SW, PH, PW, Ho, Wo;
};

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

// CH: bytes per gathered A chunk; Cin % CH == 0, so a chunk stays inside a tap.
template <int CH>
__global__ void __launch_bounds__(qt::THREADS)
    int8_conv_kernel(const int8_t* __restrict__ X, const int8_t* __restrict__ W,
                     const float* __restrict__ alpha, const float* __restrict__ beta,
                     void* __restrict__ out, ConvShape s, int stored_zp, int relu, int out_int8,
                     float inv, float zps, bool wvec) {
  using T = typename Chunk<CH>::T;
  __shared__ __align__(16) int8_t As[qt::BM * qt::LDS];
  __shared__ __align__(16) int8_t Ws[qt::BN * qt::LDS];
  __shared__ long long row_base[qt::BM];  // offset of the row's image in X; -1 past M
  __shared__ int row_h[qt::BM], row_w[qt::BM];  // top-left input pixel of the window

  const int hw = s.Ho * s.Wo;
  const int M = s.N * hw, K = s.KH * s.KW * s.Cin;
  const int m0 = blockIdx.x * qt::BM, n0 = blockIdx.y * qt::BN;

  for (int r = threadIdx.x; r < qt::BM; r += qt::THREADS) {
    const int m = m0 + r;
    if (m < M) {
      const int img = m / hw, rem = m - img * hw;
      const int ho = rem / s.Wo, wo = rem - ho * s.Wo;
      row_base[r] = static_cast<long long>(img) * s.H * s.W * s.Cin;
      row_h[r] = ho * s.SH - s.PH;
      row_w[r] = wo * s.SW - s.PW;
    } else {
      row_base[r] = -1;
      row_h[r] = 0;
      row_w[r] = 0;
    }
  }
  __syncthreads();

  const T pad = Chunk<CH>::fill(0x01010101u * static_cast<uint8_t>(stored_zp));
  const T zero = Chunk<CH>::fill(0u);
  constexpr int CPR = qt::BK / CH;  // chunks per staged row

  qt::Acc acc = {};
  for (int k0 = 0; k0 < K; k0 += qt::BK) {
    for (int i = threadIdx.x; i < qt::BM * CPR; i += qt::THREADS) {
      const int r = i / CPR, c = (i % CPR) * CH, k = k0 + c;
      T v = zero;
      const long long base = row_base[r];
      if (k < K && base >= 0) {
        const int tap = k / s.Cin, ch = k - tap * s.Cin;
        const int kh = tap / s.KW, kw = tap - kh * s.KW;
        const int hi = row_h[r] + kh, wi = row_w[r] + kw;
        if (hi >= 0 && hi < s.H && wi >= 0 && wi < s.W)
          v = *reinterpret_cast<const T*>(X + base + (static_cast<long long>(hi) * s.W + wi) * s.Cin + ch);
        else
          v = pad;
      }
      *reinterpret_cast<T*>(As + r * qt::LDS + c) = v;
    }
    qt::stage_rows(Ws, W, s.Cout, K, n0, k0, wvec);
    __syncthreads();
    qt::mma_tile(As, Ws, acc);
    __syncthreads();
  }

  qt::for_each_acc(acc, [&](int r, int c, int a) {
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= s.Cout) return;
    float y = __fadd_rn(__fmul_rn(static_cast<float>(a), alpha[n]), beta[n]);
    if (relu) y = fmaxf(y, 0.0f);
    if (out_int8) {
      float q = rintf(__fadd_rn(__fmul_rn(y, inv), zps));
      q = fminf(fmaxf(q, -128.0f), 127.0f);
      static_cast<int8_t*>(out)[(size_t)m * s.Cout + n] = static_cast<int8_t>(static_cast<int>(q));
    } else {
      static_cast<float*>(out)[(size_t)m * s.Cout + n] = y;
    }
  });
}

bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1u)) == 0;
}

template <int CH>
int launch(const void* x, const void* w, const void* alpha, const void* beta, void* out,
           const ConvShape& s, int stored_zp, int relu, int out_int8, float inv, float zps,
           void* stream) {
  const int M = s.N * s.Ho * s.Wo, K = s.KH * s.KW * s.Cin;
  const bool wvec = (K % 16 == 0) && aligned(w, 16);
  const dim3 grid((M + qt::BM - 1) / qt::BM, (s.Cout + qt::BN - 1) / qt::BN);
  int8_conv_kernel<CH><<<grid, qt::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(alpha), static_cast<const float*>(beta), out, s, stored_zp, relu,
      out_int8, inv, zps, wvec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define QT_CONV_ARGS                                                                             \
  const void *x, const void *w, const void *alpha, const void *beta, void *out, int N, int H,   \
      int W, int Cin, int Cout, int KH, int KW, int SH, int SW, int PH, int PW, int Ho, int Wo, \
      int stored_zp, int relu, int out_int8, float inv, float zps, void *stream

// Per-tap form: Cin % 16 == 0 and x 16-byte aligned.
extern "C" int qt_int8_conv_tap(QT_CONV_ARGS) {
  const ConvShape s{N, H, W, Cin, Cout, KH, KW, SH, SW, PH, PW, Ho, Wo};
  if (Cin % 16 != 0 || !aligned(x, 16)) return static_cast<int>(cudaErrorInvalidValue);
  return launch<16>(x, w, alpha, beta, out, s, stored_zp, relu, out_int8, inv, zps, stream);
}

// Gather-K form, any Cin: 4-byte chunks where Cin % 4 == 0 and x is 4-byte
// aligned, else 1-byte chunks.
extern "C" int qt_int8_conv_gatherk(QT_CONV_ARGS) {
  const ConvShape s{N, H, W, Cin, Cout, KH, KW, SH, SW, PH, PW, Ho, Wo};
  if (Cin % 4 == 0 && aligned(x, 4))
    return launch<4>(x, w, alpha, beta, out, s, stored_zp, relu, out_int8, inv, zps, stream);
  return launch<1>(x, w, alpha, beta, out, s, stored_zp, relu, out_int8, inv, zps, stream);
}
