// B5: a MobileNet-v1 depthwise-separable pair (3x3 depthwise / stride S ->
// 1x1 pointwise) in one kernel.
//
// Replaces the Pallas kernel _fused_dw_pw_kernel
// (quantized_tpu/ops/fused_block.py:701, behind fused_dw_pw :749).
//
//   x: NHWC s8 (stored u - 128), not padded; wdw (C, 9) s8 in (kh, kw)
//   order; wpw (Cout, C) s8, K-major.
//   h1  = clip(rint(acc1*a1 + b1), lo1, 127)   depthwise 3x3/S over x; taps
//                                               outside the image read zp1
//   out = clip(rint(acc2*a2 + b2), lo2, 127)   pointwise 1x1 over h1 -> s8
//
// What bounds it on the H100: its bytes. The pair moves x, the output and
// its weights once and does 2*(9*C + C*Cout) operations per output pixel:
// MobileNet's first pair (112x112, 32 -> 64) at batch 32 moves 38.5 MB
// (0.0115 ms at 3.35 TB/s) against 1.9 G operations (0.001 ms at 1979
// TOP/s); pair 6 (14x14, 512 -> 512) 6.4 MB (0.0019 ms) against 3.3 G
// (0.0017 ms). The unfused path writes the depthwise output to device memory
// and reads it back, and runs the depthwise conv as nine elementwise passes.
//
// Design: the Pallas kernel keeps up to 1.7 MB of images in VMEM; a Hopper
// block has at most 227 KB of shared memory. So a block of 128 threads owns
// one image and a band of R output rows, and walks all Cout itself:
//  1. it stages the band's input rows and their halo, (R-1)*S + 3 rows of
//     W + 2 pixels, into shared memory, 16 bytes at a time where C % 16 == 0,
//     else 4 where C % 4 == 0 (width 0.75: C = 24), else 1 (C = 9); a pixel
//     outside the image holds zp1 (the depthwise conv's stored zero point,
//     never 0);
//  2. the depthwise 3x3 runs on the CUDA cores in int32, a thread taking 4
//     channels of one output pixel (one 32-bit word per tap) where C % 4 ==
//     0, else one; output (i, j), tap (dy, dx) reads staged pixel
//     (i*S + dy, j*S + dx), so stride 2 needs no parity reshapes; epilogue 1
//     writes h1 to shared memory as ceil(C/64) K chunks of 64-row tiles at
//     the 80-byte pitch of int8_mma.cuh;
//  3. the pointwise GEMM h1 x wpw^T runs 64x64 output tiles on the tensor
//     cores (mma.sync m16n8k32), each K chunk of h1 read in place as the A
//     tile, the weights staged from device memory (L2 keeps them; 16-byte
//     loads where C % 16 == 0); epilogue 2 stores s8. The bytes of a K chunk
//     past C (any C that is not a multiple of 64) meet weight bytes staged
//     as 0, which zero their products exactly whatever they hold, and h1
//     rows past the band's pixels are never stored, so neither needs
//     clearing.
// A depthwise output row belongs to one band: shorter bands re-read 2 input
// halo rows from L2 and recompute nothing, so the wrapper shortens them
// where the batch leaves SMs idle (ops/fused_block.py dw_pw_band_rows).
//
// Two routes behind one entry, chosen by ops.dw_pw_plan and passed in as
// `sm90`: the Hopper route of dw_pw_sm90.cuh (clusters splitting C and Cout,
// TMA windows, wgmma, a staged epilogue) wherever it takes the shape (C and
// Cout multiples of 8, computed at multiples of 16: every pair of
// MobileNet-v1 at widths 1.0, 0.75 and 0.25), and this tile kernel
// elsewhere (C = 9, rows wider than 128 output pixels, unaligned bases),
// which refuses nothing.
//
// Epilogues use __fmul_rn/__fadd_rn and rintf (the build passes
// -fmad=false): the kernel rounds exactly as its plain PyTorch version.

#include "dw_pw_sm90.cuh"
#include "int8_mma.cuh"

namespace {

struct DwPwShape {
  int N, H, W, C, Cout, Ho, Wo, R;
  int HR, MP, KC;  // staged input rows; h1 rows (a multiple of 64); h1's 64-byte K chunks
};

struct DwPwEpilogue {
  const float *a1, *b1, *a2, *b2;
  float lo1, lo2;
  int zp1;
};

__host__ __device__ inline size_t dw_pw_smem_bytes(const DwPwShape& s) {
  return static_cast<size_t>(qt::BN) * qt::LDS + static_cast<size_t>(s.KC) * s.MP * qt::LDS +
         static_cast<size_t>(s.HR) * (s.W + 2) * s.C + 9 * static_cast<size_t>(s.C);
}

// byte q of a 32-bit word, sign-extended
__device__ __forceinline__ int sbyte(uint32_t v, int q) { return static_cast<int8_t>(v >> (8 * q)); }

// CH: bytes per staged input chunk (16, 4 or 1; C % CH == 0); the depthwise
// pass takes 4 channels per thread step where CH >= 4, else one.
template <int S, int CH>
__global__ void __launch_bounds__(qt::THREADS)
    fused_dw_pw_kernel(const int8_t* __restrict__ X, const int8_t* __restrict__ WDW,
                       const int8_t* __restrict__ WPW, int8_t* __restrict__ out, DwPwShape s,
                       DwPwEpilogue e, bool wvec) {
  using T = typename qt::Chunk<CH>::T;
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* Ws = smem;                                                // 64 x LDS
  int8_t* h1 = Ws + qt::BN * qt::LDS;                               // KC x MP x LDS
  int8_t* xs = h1 + static_cast<size_t>(s.KC) * s.MP * qt::LDS;     // HR x (W+2) x C
  int8_t* wd = xs + static_cast<size_t>(s.HR) * (s.W + 2) * s.C;    // 9 x C, tap-major

  const int img = blockIdx.y;
  const int r0 = blockIdx.x * s.R;     // first output row of the band
  const int rb = min(s.R, s.Ho - r0);  // its output rows
  const int hb = r0 * S - 1;           // image row of xs's local row 0
  const int pitch = s.W + 2;           // staged pixels per row
  const int8_t* x = X + static_cast<size_t>(img) * s.H * s.W * s.C;

  // 1. the input band and its halo (zp1 outside the image), chunk i at byte
  // i*CH of xs; the depthwise weights transposed to tap-major,
  // wd[t*C + c] = WDW[c*9 + t]
  {
    const T pad = qt::Chunk<CH>::fill(qt::zp_bytes(e.zp1));
    const int cpp = s.C / CH;  // chunks per pixel
    const int nch = s.HR * pitch * cpp;
    for (int i = threadIdx.x; i < nch; i += qt::THREADS) {
      const int px = i / cpp, ch = (i - px * cpp) * CH;
      const int lr = px / pitch, wi = px - lr * pitch - 1, hi = hb + lr;
      T v = pad;
      if (hi >= 0 && hi < s.H && wi >= 0 && wi < s.W)
        v = *reinterpret_cast<const T*>(x + (static_cast<size_t>(hi) * s.W + wi) * s.C + ch);
      reinterpret_cast<T*>(xs)[i] = v;
    }
    for (int i = threadIdx.x; i < 9 * s.C; i += qt::THREADS) {
      const int t = i / s.C, c = i - t * s.C;
      wd[i] = WDW[c * 9 + t];
    }
  }
  __syncthreads();

  // 2. depthwise 3x3/S and epilogue 1 into h1: chunk c/64, row m, byte c%64
  const int M = rb * s.Wo;
  if constexpr (CH >= 4) {
    const int cw = s.C / 4;
    for (int idx = threadIdx.x; idx < M * cw; idx += qt::THREADS) {
      const int m = idx / cw, c = (idx - m * cw) * 4;
      const int i = m / s.Wo, j = m - i * s.Wo;
      int acc[4] = {0, 0, 0, 0};
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const int8_t* px = xs + (static_cast<size_t>(i * S + t / 3) * pitch + j * S + t % 3) * s.C;
        const uint32_t xv = *reinterpret_cast<const uint32_t*>(px + c);
        const uint32_t wv = *reinterpret_cast<const uint32_t*>(wd + t * s.C + c);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[q] += sbyte(xv, q) * sbyte(wv, q);
      }
      uint32_t packed = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int8_t v = qt::requant(acc[q], e.a1[c + q], e.b1[c + q], e.lo1);
        packed |= static_cast<uint32_t>(static_cast<uint8_t>(v)) << (8 * q);
      }
      *reinterpret_cast<uint32_t*>(h1 + (static_cast<size_t>(c >> 6) * s.MP + m) * qt::LDS + (c & 63)) = packed;
    }
  } else {
    for (int idx = threadIdx.x; idx < M * s.C; idx += qt::THREADS) {
      const int m = idx / s.C, c = idx - m * s.C;
      const int i = m / s.Wo, j = m - i * s.Wo;
      int acc = 0;
#pragma unroll
      for (int t = 0; t < 9; ++t)
        acc += static_cast<int>(xs[(static_cast<size_t>(i * S + t / 3) * pitch + j * S + t % 3) * s.C + c]) *
               static_cast<int>(wd[t * s.C + c]);
      h1[(static_cast<size_t>(c >> 6) * s.MP + m) * qt::LDS + (c & 63)] = qt::requant(acc, e.a1[c], e.b1[c], e.lo1);
    }
  }
  __syncthreads();

  // 3. pointwise 1x1: out[band pixel m, n] over 64x64 tiles, K = C in chunks
  int8_t* o = out + (static_cast<size_t>(img) * s.Ho + r0) * s.Wo * s.Cout;
  for (int m0 = 0; m0 < M; m0 += qt::BM) {
    for (int n0 = 0; n0 < s.Cout; n0 += qt::BN) {
      qt::Acc acc = {};
      for (int kc = 0; kc < s.KC; ++kc) {
        qt::stage_rows(Ws, WPW, s.Cout, s.C, n0, kc * qt::BK, wvec);
        __syncthreads();
        qt::mma_tile(h1 + (static_cast<size_t>(kc) * s.MP + m0) * qt::LDS, Ws, acc);
        __syncthreads();
      }
      qt::for_each_acc(acc, [&](int r, int c, int a) {
        const int m = m0 + r, n = n0 + c;
        if (m >= M || n >= s.Cout) return;
        o[static_cast<size_t>(m) * s.Cout + n] = qt::requant(a, e.a2[n], e.b2[n], e.lo2);
      });
    }
  }
}

template <int S, int CH>
int launch_dw_pw_ch(const void* x, const void* wdw, const void* wpw, void* out, const DwPwShape& s,
                    const DwPwEpilogue& e, void* stream) {
  const bool wvec = s.C % 16 == 0 && qt::aligned16(wpw);
  return qt::launch(fused_dw_pw_kernel<S, CH>, dim3((s.Ho + s.R - 1) / s.R, s.N), dw_pw_smem_bytes(s),
                    stream, static_cast<const int8_t*>(x), static_cast<const int8_t*>(wdw),
                    static_cast<const int8_t*>(wpw), static_cast<int8_t*>(out), s, e, wvec);
}

template <int S>
int launch_dw_pw(const void* x, const void* wdw, const void* wpw, void* out, DwPwShape s,
                 const DwPwEpilogue& e, void* stream) {
  if (s.N < 1 || s.R < 1 || s.C < 1 || s.Cout < 1 || s.H % S || s.W % S)
    return static_cast<int>(cudaErrorInvalidValue);
  s.Ho = s.H / S;
  s.Wo = s.W / S;
  s.HR = (s.R - 1) * S + 3;
  s.MP = (s.R * s.Wo + qt::BM - 1) / qt::BM * qt::BM;
  s.KC = (s.C + qt::BK - 1) / qt::BK;
  switch (qt::chunk_bytes(s.C, x)) {
    case 16: return launch_dw_pw_ch<S, 16>(x, wdw, wpw, out, s, e, stream);
    case 4: return launch_dw_pw_ch<S, 4>(x, wdw, wpw, out, s, e, stream);
    default: return launch_dw_pw_ch<S, 1>(x, wdw, wpw, out, s, e, stream);
  }
}

}  // namespace

// Stride 1 or 2 over an image it divides. sm90 != 0: the Hopper route under
// the plan (q, tho, nb, clusters, smem) of ops.dw_pw_plan, at C and Cout
// rounded up to multiples of 16, refused (an error, never another route)
// where it cannot take the call; else the tile kernel, any C, R output rows
// per block.
extern "C" int qt_fused_dw_pw(const void* x, const void* wdw, const void* wpw, const void* a1,
                              const void* b1, const void* a2, const void* b2, void* out, int N, int H,
                              int W, int C, int Cout, int stride, int R, int zp1, float lo1, float lo2,
                              int sm90, int q, int tho, int nb, int clusters, int smem, void* stream) {
  if (sm90) {
    qtdw::DwGeom g{};
    g.N = N, g.H = H, g.W = W, g.C = C, g.Cout = Cout, g.S = stride;
    const qtdw::DwEpi e{static_cast<const float*>(a1), static_cast<const float*>(b1), static_cast<const float*>(a2),
                        static_cast<const float*>(b2), lo1, lo2, zp1};
    return qtdw::launch_dw_pw(x, wdw, wpw, out, g, e, qtdw::DwPlan{q, tho, nb, clusters, smem}, stream);
  }
  const DwPwShape s{N, H, W, C, Cout, 0, 0, R, 0, 0, 0};
  const DwPwEpilogue e{static_cast<const float*>(a1), static_cast<const float*>(b1),
                       static_cast<const float*>(a2), static_cast<const float*>(b2), lo1, lo2, zp1};
  if (stride == 1) return launch_dw_pw<1>(x, wdw, wpw, out, s, e, stream);
  if (stride == 2) return launch_dw_pw<2>(x, wdw, wpw, out, s, e, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
