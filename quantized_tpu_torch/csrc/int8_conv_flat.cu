// B7: the flat-row direct int8 convolution (stride 1), with K2's epilogue.
//
// Replaces the Pallas kernel _flat_kernel behind int8_conv_flat
// (quantized_tpu/ops/int8_conv_pallas.py:189, :257).
//
//   x: the zero-point-padded NHWC s8 image with its rows flattened, (N, L, Cin)
//   with L = Hp*Wp;  w: (Cout, Kh*Kw*Cin) s8, K in (kh, kw, c) order.
//   GEMM rows m = (n, r) for every flat output row r < Ho*Wp, the junk
//   columns (r % Wp >= Wo) included; tap (dh, dw) of row r reads flat input
//   row r + dh*Wp + dw. Only the rows with r % Wp < Wo are stored, straight
//   into (N, Ho, Wo, Cout), so no slice copy follows.
//   y = acc * alpha + beta; ReLU if asked; then f32 out, or
//   q = clip(rint(y * inv + zps), -128, 127) -> s8.
//
// What bounds it on the H100: the same work as K2 (int8_conv.cu) plus the
// junk columns, (Wp - Wo)/Wo more rows (3.6% at 56x56, 29% at 7x7); the
// ResNet-50 3x3 shapes are bound by the int8 tensor-core rate, the 1x1 shapes
// by the bytes. Design: K2's 64x64 block tile and mma.sync product
// (int8_mma.cuh). What the flat rows buy on the card: a tap's A chunk is one
// read at a constant offset from the row's base, with one test (r + off <
// L, false only for junk rows of the last output row, which read the stored
// zero point) in place of K2's per-pixel index arithmetic and bounds tests;
// the wrapper pays for a padded copy of the input instead. Chunks are 16
// bytes where Cin % 16 == 0, else 4 or 1 (the chunk never straddles a tap).
// The Pallas kernel's two forms map onto the K loop: gather-K walks K =
// Kh*Kw*Cin in 64-byte steps that straddle taps; per-tap walks each tap's
// Cin bytes in steps of its own, the last one padded with zero weights.
// That tile, with no load/compute overlap, took 3.1x torch._int_mm's time at
// ResNet-50's 1x1 64->256.
//
// Where Cin % 16 == 0 and both bases are 16-byte aligned (every ResNet-50
// stride-1 shape), both K walks run the Hopper conv mainloop of
// conv_sm90.cuh instead, chosen by ops.conv_plan and passed in as `sm90`:
// wgmma tiles of 128 flat rows x up to 128 channels, each tap's A tile one
// TMA box of the flat rows at m0 + dh * Wp + dw (the input is already
// zero-point padded, so nothing needs correcting), W by TMA, a ring,
// persistent blocks. The mainloop walks K tap by tap, so the two walks give
// one launch. Cin % 16 != 0 and unaligned inputs keep the tile below.
//
// The epilogue uses __fmul_rn/__fadd_rn (and the build passes -fmad=false),
// so it rounds exactly as the plain PyTorch version does.

#include "conv_sm90.cuh"
#include "int8_mma.cuh"

namespace {

struct FlatShape {
  int N, L, Wp, Cin, Cout, KW, Ho, Wo;
  int segs, seg_len;  // K segments: 1 of Kh*Kw*Cin (gather-K), or Kh*Kw of Cin (per-tap)
};

// the epilogue's scalars; alpha and beta are __restrict__ kernel parameters,
// so their loads need not wait for the output's stores
struct FlatEpilogue {
  int relu, out_int8;
  float inv, zps;
};

template <int CH>
__global__ void __launch_bounds__(qt::THREADS)
    int8_conv_flat_kernel(const int8_t* __restrict__ X, const int8_t* __restrict__ W,
                          const float* __restrict__ alpha, const float* __restrict__ beta,
                          void* __restrict__ out, FlatShape s, int stored_zp, FlatEpilogue e, bool wvec) {
  using T = typename qt::Chunk<CH>::T;
  __shared__ __align__(16) int8_t As[qt::BM * qt::LDS];
  __shared__ __align__(16) int8_t Ws[qt::BN * qt::LDS];
  __shared__ long long row_base[qt::BM];  // offset of the row's flat pixel in X; -1 past M
  __shared__ int row_room[qt::BM];        // flat rows from it to the image's end
  __shared__ int row_out[qt::BM];         // output pixel (n, ho, wo); -1 for a junk column

  const int rows = s.Ho * s.Wp;
  const int M = s.N * rows, K = s.segs * s.seg_len;
  const int m0 = blockIdx.x * qt::BM, n0 = blockIdx.y * qt::BN;

  for (int r = threadIdx.x; r < qt::BM; r += qt::THREADS) {
    const int m = m0 + r;
    row_base[r] = -1;
    row_room[r] = 0;
    row_out[r] = -1;
    if (m < M) {
      const int img = m / rows, rr = m - img * rows;
      const int h = rr / s.Wp, w = rr - h * s.Wp;
      row_base[r] = (static_cast<long long>(img) * s.L + rr) * s.Cin;
      row_room[r] = s.L - rr;
      if (w < s.Wo) row_out[r] = (img * s.Ho + h) * s.Wo + w;
    }
  }
  __syncthreads();

  const T pad = qt::Chunk<CH>::fill(qt::zp_bytes(stored_zp));
  const T zero = qt::Chunk<CH>::fill(0u);
  constexpr int CPR = qt::BK / CH;  // chunks per staged row

  qt::Acc acc = {};
  for (int seg = 0; seg < s.segs; ++seg) {
    for (int k0 = 0; k0 < s.seg_len; k0 += qt::BK) {
      for (int i = threadIdx.x; i < qt::BM * CPR; i += qt::THREADS) {
        const int r = i / CPR, c = (i % CPR) * CH, p = k0 + c;
        T v = zero;
        const long long base = row_base[r];
        if (p < s.seg_len && base >= 0) {
          const int k = seg * s.seg_len + p;
          const int tap = k / s.Cin, ch = k - tap * s.Cin;
          const int dh = tap / s.KW, off = dh * s.Wp + (tap - dh * s.KW);
          v = off < row_room[r]
                  ? *reinterpret_cast<const T*>(X + base + static_cast<long long>(off) * s.Cin + ch)
                  : pad;
        }
        *reinterpret_cast<T*>(As + r * qt::LDS + c) = v;
      }
      qt::stage_cols(Ws, W + static_cast<size_t>(seg) * s.seg_len, s.Cout, static_cast<size_t>(K), n0, k0,
                     s.seg_len, wvec);
      __syncthreads();
      qt::mma_tile(As, Ws, acc);
      __syncthreads();
    }
  }

  qt::for_each_acc(acc, [&](int r, int c, int a) {
    const int n = n0 + c, px = row_out[r];
    if (px < 0 || n >= s.Cout) return;
    const size_t o = static_cast<size_t>(px) * s.Cout + n;
    float y = __fadd_rn(__fmul_rn(static_cast<float>(a), alpha[n]), beta[n]);
    if (e.relu) y = fmaxf(y, 0.0f);
    if (e.out_int8) {
      float q = rintf(__fadd_rn(__fmul_rn(y, e.inv), e.zps));
      q = fminf(fmaxf(q, -128.0f), 127.0f);
      static_cast<int8_t*>(out)[o] = static_cast<int8_t>(static_cast<int>(q));
    } else {
      static_cast<float*>(out)[o] = y;
    }
  });
}

template <int CH>
int launch(const void* x, const void* w, const void* alpha, const void* beta, void* out, const FlatShape& s,
           int stored_zp, const FlatEpilogue& e, void* stream) {
  const int M = s.N * s.Ho * s.Wp, K = s.segs * s.seg_len;
  const bool wvec = K % 16 == 0 && s.seg_len % 16 == 0 && qt::aligned16(w);
  const dim3 grid((M + qt::BM - 1) / qt::BM, (s.Cout + qt::BN - 1) / qt::BN);
  int8_conv_flat_kernel<CH><<<grid, qt::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), static_cast<const float*>(alpha),
      static_cast<const float*>(beta), out, s, stored_zp, e, wvec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (N, Hp*Wp, Cin) the padded image's flat rows; out (N, Ho, Wo, Cout) f32
// or s8; gather_k: one K segment over all taps, else one per tap. sm90 != 0:
// the Hopper mainloop under the plan (kc, bn, two = 128, tho = 1, nb = 1,
// stages, blocks, smem) of ops.conv_plan, or an error where it cannot take
// the call.
extern "C" int qt_int8_conv_flat(const void* x, const void* w, const void* alpha, const void* beta,
                                 void* out, int N, int Hp, int Wp, int Cin, int Cout, int KH, int KW,
                                 int stored_zp, int relu, int out_int8, int gather_k, float inv, float zps,
                                 int sm90, int kc, int bn, int two, int tho, int nb, int stages, int blocks,
                                 int smem, void* stream) {
  const int Ho = Hp - KH + 1, Wo = Wp - KW + 1;
  if (N < 1 || Cin < 1 || Cout < 1 || Ho < 1 || Wo < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (sm90) {
    const qtconv::ConvGeom g{N, Hp, Wp, Cin, Cout, KH, KW, 1, 1, 0, 0, Ho, Wo, 1};
    const qtconv::ConvEpi ep{static_cast<const float*>(alpha), static_cast<const float*>(beta), nullptr, out,
                             stored_zp, relu, out_int8, inv, zps};
    return qtconv::launch_conv(x, w, g, ep, qtconv::ConvPlan{kc, bn, two, tho, nb, stages, blocks, smem}, stream);
  }
  const int taps = KH * KW;
  const FlatShape s{N, Hp * Wp, Wp, Cin, Cout, KW, Ho, Wo,
                    gather_k ? 1 : taps, gather_k ? taps * Cin : Cin};
  const FlatEpilogue e{relu, out_int8, inv, zps};
  switch (qt::chunk_bytes(Cin, x)) {
    case 16: return launch<16>(x, w, alpha, beta, out, s, stored_zp, e, stream);
    case 4: return launch<4>(x, w, alpha, beta, out, s, stored_zp, e, stream);
    default: return launch<1>(x, w, alpha, beta, out, s, stored_zp, e, stream);
  }
}
