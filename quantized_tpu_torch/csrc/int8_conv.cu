// K2: direct int8 convolution as an implicit GEMM, with the fused epilogue;
// and B8, the same conv with a fused int8 residual in its epilogue.
//
// Replaces the Pallas kernels _conv_kernel (per-tap dots),
// _conv_gatherk_kernel (small Cin, one dot over all taps) and
// _conv_residual_kernel (per-tap dots + residual) behind int8_conv_direct
// (quantized_tpu/ops/int8_conv_pallas.py:57, :106, :147, :383).
//
//   x: NHWC s8 (stored u - 128), not padded;  w: (Cout, Kh*Kw*Cin) s8, K in
//   (kh, kw, c) order;  GEMM rows m = (n, ho, wo), columns = Cout.
//   y = acc * alpha + beta; with a residual r (s8, same shape as the output,
//   on the grid (r_scale, r_zp)): y = y + (r + (128 - r_zp)) * r_scale;
//   ReLU if asked; then either f32 out, or
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
// unpadded input by index arithmetic, 64 K bytes at a time. A K step may
// straddle taps; a gathered chunk never does: it is 16 bytes where Cin % 16
// == 0, 4 where Cin % 4 == 0 (the space-to-depth stem, Cin = 12, K = 192;
// MobileNet-v1 at width 0.75, Cin = 24), else 1 (the CIFAR stem, Cin = 3).
// The per-tap and gather-K forms differ only in which Pallas body they stand
// for and which launch count they add to; the residual form is the RES
// instance of this tile (and of the mainloop), so the residual's loads and
// registers stay out of the others. The product is mma.sync m16n8k32 on the
// int8 tensor cores (int8_mma.cuh), with no load/compute overlap: at
// ResNet-50's 1x1 64->256 it took 3.4x torch._int_mm's time on the same
// product.
//
// Three routes behind one entry, qt_int8_conv, chosen by ops.conv_plan and
// passed in as `sm90`:
// - 1: the per-tap and residual (B8) forms over Cin % 16 == 0 with
//   16-byte-aligned bases (every per-tap conv of ResNet-50/18, MobileNet-v1
//   and AlexNet) run the Hopper conv mainloop of conv_sm90.cuh: wgmma tiles
//   of 128 pixels x up to 128 channels, A and W by TMA through a ring,
//   persistent blocks, the zero-filled padding corrected by the weights' tap
//   sums (conv_sm90.cuh's header says how); B8 on its RES instances. A 1x1
//   stride-1 unpadded conv over Cin % 16 != 0 with Cin % 4 == 0
//   (MobileNet-v1's first pointwise conv at widths 0.75 and 0.25: Cin 24
//   and 8) arrives here as the same function on groups of four pixels: the
//   wrapper passes 4 pixels as one row of 4 * Cin bytes, diag(W, W, W, W)
//   and alpha, beta tiled four times, so the output's (M / 4, 4 * Cout)
//   rows are its (M, Cout); a stage of up to 128 bytes takes the whole row
//   (the bytes past it arrive as zeros);
// - 2: the gather-K form (Cout <= 64, a 16-byte-aligned input: every stem
//   and CIFAR's 16- and 32-channel convs) runs its own Hopper route,
//   gatherk_sm90.cuh: the input window and the weights in shared memory, A
//   built from the window, wgmma, a bulk-copied epilogue;
// - 0: the tile below, which refuses nothing, takes the rest: unaligned
//   inputs, strides past 8, and Cin % 16 != 0 but for those 1x1s (Cin 9,
//   a 3x3 over Cin 40 or 24, a count of pixels not a multiple of 4; no zoo
//   model's served forward launches it).
//
// A clamped conv (the RangeBN flavor: the input observer of the folded
// RangeBN clips the conv's output, engine.convert._rangebn_y_clip) passes
// per-channel bounds clip_lo / clip_hi, on every route: the f32 form clamps
// y to them before ReLU, the s8 form clamps the rounded value to them in
// place of ReLU and [-128, 127] (integer-valued bounds in [-128, 127], whose
// lo holds the ReLU floor, formed as int8_conv_xla(y_clip=) forms them:
// ops.int8_matmul.requant_clip_bounds). Each route runs them on CLIP
// instances of its own, so the unclamped instances carry none of it; the
// residual form takes no clamp.
//
// The epilogue uses __fmul_rn/__fadd_rn (and the build passes -fmad=false),
// so it rounds exactly as the plain PyTorch version does.

#include "conv_sm90.cuh"
#include "gatherk_sm90.cuh"
#include "int8_mma.cuh"

namespace {

struct ConvShape {
  int N, H, W, Cin, Cout, KH, KW, SH, SW, PH, PW, Ho, Wo;
};

// the epilogue's scalars; its vectors and the residual are __restrict__
// kernel parameters, so their loads need not wait for the output's stores
struct ConvEpilogue {
  float r_off, r_scale;  // f32(128 - r_zp), f32(r_scale) of the residual
  int relu, out_int8;
  float inv, zps;
};

// CH: bytes per gathered A chunk; Cin % CH == 0, so a chunk stays inside a tap.
// RES: add the residual in the epilogue (B8). CLIP: the clamp.
template <int CH, bool RES, bool CLIP>
__global__ void __launch_bounds__(qt::THREADS)
    int8_conv_kernel(const int8_t* __restrict__ X, const int8_t* __restrict__ W,
                     const float* __restrict__ alpha, const float* __restrict__ beta,
                     const int8_t* __restrict__ residual, const float* __restrict__ clip_lo,
                     const float* __restrict__ clip_hi, void* __restrict__ out, ConvShape s, int stored_zp,
                     ConvEpilogue e, bool wvec) {
  using T = typename qt::Chunk<CH>::T;
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

  const T pad = qt::Chunk<CH>::fill(qt::zp_bytes(stored_zp));
  const T zero = qt::Chunk<CH>::fill(0u);
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
    const size_t o = static_cast<size_t>(m) * s.Cout + n;
    float y = __fadd_rn(__fmul_rn(static_cast<float>(a), alpha[n]), beta[n]);
    if constexpr (RES)
      y = __fadd_rn(y, __fmul_rn(__fadd_rn(static_cast<float>(residual[o]), e.r_off), e.r_scale));
    if constexpr (CLIP) {
      if (!e.out_int8) y = fminf(fmaxf(y, clip_lo[n]), clip_hi[n]);
    }
    if (!(CLIP && e.out_int8)) y = qt::activate(y, e.relu);  // s8 CLIP: the ReLU floor is in clip_lo
    if (e.out_int8) {
      float q = rintf(__fadd_rn(__fmul_rn(y, e.inv), e.zps));
      if constexpr (CLIP)
        q = fminf(fmaxf(q, clip_lo[n]), clip_hi[n]);
      else
        q = fminf(fmaxf(q, -128.0f), 127.0f);
      static_cast<int8_t*>(out)[o] = static_cast<int8_t>(static_cast<int>(q));
    } else {
      static_cast<float*>(out)[o] = y;
    }
  });
}

struct ConvArgs {
  const void *x, *w, *alpha, *beta, *residual, *clip_lo, *clip_hi;
  void* out;
};

template <int CH, bool RES, bool CLIP>
int launch(const ConvArgs& a, const ConvShape& s, int stored_zp, const ConvEpilogue& e, void* stream) {
  const int M = s.N * s.Ho * s.Wo, K = s.KH * s.KW * s.Cin;
  const bool wvec = (K % 16 == 0) && qt::aligned16(a.w);
  const dim3 grid((M + qt::BM - 1) / qt::BM, (s.Cout + qt::BN - 1) / qt::BN);
  int8_conv_kernel<CH, RES, CLIP><<<grid, qt::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a.x), static_cast<const int8_t*>(a.w), static_cast<const float*>(a.alpha),
      static_cast<const float*>(a.beta), static_cast<const int8_t*>(a.residual),
      static_cast<const float*>(a.clip_lo), static_cast<const float*>(a.clip_hi), a.out, s, stored_zp, e, wvec);
  return static_cast<int>(cudaGetLastError());
}

// the widest chunk that divides Cin and keeps x's loads aligned
template <bool RES, bool CLIP>
int launch_any_cin(const ConvArgs& a, const ConvShape& s, int stored_zp, const ConvEpilogue& e, void* stream) {
  switch (qt::chunk_bytes(s.Cin, a.x)) {
    case 16: return launch<16, RES, CLIP>(a, s, stored_zp, e, stream);
    case 4: return launch<4, RES, CLIP>(a, s, stored_zp, e, stream);
    default: return launch<1, RES, CLIP>(a, s, stored_zp, e, stream);
  }
}

}  // namespace

// K2 in all its forms (per-tap, gather-K, and B8 where residual is not
// null: (N, Ho, Wo, Cout) s8, r_off = f32(128 - r_zp), r_scale =
// f32(r_scale)), any Cin. sm90 == 1: the per-tap or residual form on the
// Hopper mainloop under the plan (kc, bn, two, tho, nb, stages, blocks,
// smem) of ops.conv_plan, with border_sums ((KH + 1) * (KW + 1), Cout) int32, the
// summed-area table of the tap sums (ops.conv_border_sums), where a padded
// tap reads a nonzero stored zero point; sm90 == 2: the gather-K form on its
// Hopper route under the plan (kc: the swizzle row, bn, two, tho, nb,
// blocks, smem; stages unused). Either is refused (an error, never another
// route) where it cannot take the call. clip_lo, clip_hi: the clamp's
// (Cout,) f32 bounds (of y with f32 out, integer-valued bounds of the
// rounded value with s8 out), or both null; not with a residual.
extern "C" int qt_int8_conv(const void* x, const void* w, const void* alpha, const void* beta,
                            const void* residual, const void* border_sums, void* out, int N, int H, int W, int Cin,
                            int Cout, int KH, int KW, int SH, int SW, int PH, int PW, int Ho, int Wo, int stored_zp,
                            int relu, int out_int8, float inv, float zps, float r_off, float r_scale, int sm90,
                            int kc, int bn, int two, int tho, int nb, int stages, int blocks, int smem,
                            const void* clip_lo, const void* clip_hi, void* stream) {
  const bool clip = clip_lo != nullptr;
  if (clip != (clip_hi != nullptr) || (clip && residual != nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  if (sm90 == 2) {
    if (residual != nullptr) return static_cast<int>(cudaErrorInvalidValue);
    qtgk::GkGeom g{};
    g.N = N, g.H = H, g.W = W, g.Cin = Cin, g.Cout = Cout, g.KH = KH, g.KW = KW;
    g.SH = SH, g.SW = SW, g.PH = PH, g.PW = PW, g.Ho = Ho, g.Wo = Wo;
    const qtgk::GkEpi ep{static_cast<const float*>(alpha), static_cast<const float*>(beta), out, stored_zp, relu,
                         out_int8, inv, zps, static_cast<const float*>(clip_lo), static_cast<const float*>(clip_hi)};
    return qtgk::launch_gatherk(x, w, g, ep, qtgk::GkPlan{kc, bn, two, tho, nb, blocks, smem}, stream);
  }
  if (sm90) {
    // a 1x1 stride-1 conv without padding is a product of its input's rows: flat rows, whole 128-row tiles
    const int flat = KH == 1 && KW == 1 && SH == 1 && SW == 1 && PH == 0 && PW == 0;
    const qtconv::ConvGeom g{N, H, W, Cin, Cout, KH, KW, SH, SW, PH, PW, Ho, Wo, flat};
    const qtconv::ConvEpi ep{static_cast<const float*>(alpha), static_cast<const float*>(beta),
                             static_cast<const int*>(border_sums), out, stored_zp, relu, out_int8, inv, zps,
                             static_cast<const int8_t*>(residual), r_off, r_scale,
                             static_cast<const float*>(clip_lo), static_cast<const float*>(clip_hi)};
    const qtconv::ConvPlan p{kc, bn, two, tho, nb, stages, blocks, smem};
    if (residual != nullptr) return qtconv::launch_conv<true, false>(x, w, g, ep, p, stream);
    if (relu >= qt::ACT_SILU) return qtconv::launch_conv<false, false, true>(x, w, g, ep, p, stream);
    return clip ? qtconv::launch_conv<false, true>(x, w, g, ep, p, stream)
                : qtconv::launch_conv<false, false>(x, w, g, ep, p, stream);
  }
  const ConvArgs a{x, w, alpha, beta, residual, clip_lo, clip_hi, out};
  const ConvShape s{N, H, W, Cin, Cout, KH, KW, SH, SW, PH, PW, Ho, Wo};
  const ConvEpilogue e{r_off, r_scale, relu, out_int8, inv, zps};
  if (residual != nullptr) return launch_any_cin<true, false>(a, s, stored_zp, e, stream);
  return clip ? launch_any_cin<false, true>(a, s, stored_zp, e, stream)
              : launch_any_cin<false, false>(a, s, stored_zp, e, stream);
}
