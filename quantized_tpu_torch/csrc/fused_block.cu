// B3 and B4: a whole int8 ResNet block in one kernel.
//
// ---- B3, the bottleneck (1x1 -> 3x3/S -> 1x1) ----
//
// Replaces the Pallas kernels _fused_bottleneck_kernel and
// _fused_bottleneck_ds_kernel (quantized_tpu/ops/fused_block.py:54 and :368,
// behind fused_bottleneck_s1 :116 and fused_bottleneck_ds :445). One template
// serves both: the identity block is the downsample block with stride 1 and
// the prescaled input in place of the shortcut conv.
//
//   x: NHWC s8 (stored u - 128), not padded; w1 (Cm, C), w2 (Cm, 9*Cm) in
//   (kh, kw, c) order, w3 (Cout, Cm), wd (Cout, C): all K-major s8.
//   h1  = clip(rint(acc1*a1 + b1), lo1, 127)       conv1 1x1
//   h2  = clip(rint(acc2*a2 + b2), lo2, 127)       conv2 3x3/S, h1's border = zp2
//   y   = acc3*a3 + b3                             conv3 1x1
//   idq = x*id_k + id_c   (identity)   or   accd*ad + bd  (1x1/S shortcut conv,
//         then clip(rint(idq*fine), +-32767) * (1/fine) when fine != 0)
//   out = clip(rint(y + idq), shift, 127) -> s8
//
// What bounds it on the H100: the function moves the block's input and
// output once and its weights (70 KB in layer1, 6 MB in layer4.0), and
// does 2*(C*Cm + 9*Cm*Cm/S^2 + Cm*Cout/S^2 [+ C*Cout/S^2]) int8 operations
// per input pixel: layer1's identity block at batch 32 is bound by its
// 51 MB of bytes (0.015 ms), layer4's by its operations. The unfused path
// writes h1, h2 and the f32 conv3 and shortcut outputs to device memory
// and reads them back, ten times the bytes.
//
// Design: the Pallas kernel keeps whole images in VMEM (up to 1.7 MB); a
// Hopper block has at most 227 KB of shared memory. So a block owns one
// image and a band of R output rows. It fills h1 (the band's rows plus the
// 1-row halo, (R-1)*S + 3 rows of W + 2 pixels) with zp2, runs conv1 over
// those of its rows that lie inside the image (recomputing the rows that
// the neighbouring band also computes), then conv2 into h2 (R rows of W/S
// pixels), both in shared memory, then conv3 and the shortcut conv over 64
// output channels at a time with the final epilogue straight to the output.
// Every GEMM is the 64x64 block tile of int8_mma.cuh (A gathered 16 bytes at
// a time into the staging tile, weights streamed from device memory where
// L2 keeps them after the first block, mma.sync m16n8k32). h1 and h2 keep a
// pixel pitch of Cm + 16 bytes. No load/compute overlap and no wgmma/TMA:
// later work. Small late stages give few blocks (layer4 at batch 32: 64 and
// 32 blocks on 132 SMs).
//
// ---- B4, the BasicBlock (3x3/S -> 3x3), ResNet-18/34 and the CIFAR nets ----
//
// Replaces the Pallas kernels _fused_basicblock_kernel and
// _fused_basicblock_ds_kernel (quantized_tpu/ops/fused_block.py:198 and
// :537, behind fused_basicblock_s1 :274 and fused_basicblock_ds :623).
//
//   x: NHWC s8, not padded; w1 (Cm, 9*C), w2 (Cm, 9*Cm), wd (Cm, C), K-major s8.
//   h1  = clip(rint(acc1*a1 + b1), lo1, 127)   conv1 3x3/S over x; taps outside
//                                               the image read zp1
//   y   = acc2*a2 + b2                          conv2 3x3/1 over h1; h1's border = zp2
//   idq, out: as in B3 (identity needs C == Cm)
//
// What bounds it on the H100: 2*(9*C*Cm + 9*Cm*Cm [+ C*Cm]) int8 operations
// per output pixel against the block's input and output bytes: ResNet-18's
// identity block in layer1 at batch 32 does 14.8 G operations (0.0075 ms at
// 1979 TOP/s) and moves 12.9 MB (0.0039 ms): ResNet-18's shapes are bound by
// their operations, the narrow CIFAR shapes (C of 16 to 64) by their bytes.
//
// Design: a block owns one image and a band of R output rows. Only h1 lives
// in shared memory: R + 2 rows of Wo + 2 pixels at a pitch of Cm + 16, filled
// with zp2, then overwritten by conv1 on the rows r0-1 ... r0+R that lie
// inside the image (the two halo rows are also computed by the neighbouring
// bands: a recompute share of (R + 2) / R, so B4's bands are taller than
// B3's). conv1 gathers its A tile straight from x in device memory, 16 bytes
// at a time, tap by tap (C % 16 == 0). conv2 reads h1 with K = 9*Cm; its
// accumulators go straight into the final epilogue with the shortcut's (the
// 1x1/S conv on x[S*i, S*j], or the identity), with no h2 buffer. Every GEMM
// is the 64x64 tile of int8_mma.cuh; a width below 64 (the CIFAR nets' 16 and
// 32) fills part of the tile, and the epilogues guard n < Cm. No load/compute
// overlap and no wgmma/TMA: later work. ResNet-18's layer3 and layer4 give one
// band per image (32 blocks at batch 32 on 132 SMs).
//
// Epilogues use __fmul_rn/__fadd_rn and rintf (the build passes
// -fmad=false): the kernels round exactly as their plain PyTorch versions.

#include "int8_mma.cuh"

namespace {

using qt::fill16;
using qt::launch;
using qt::ld16;
using qt::requant;
using qt::zero16;

constexpr int CPR = qt::BK / 16;  // 16-byte chunks per staged row

struct BlockShape {
  int N, H, W, C, Cm, Cout, Ho, Wo, R, HR, P;  // HR: h1 rows; P: h1/h2 pixel pitch
};

struct Epilogue {
  const float *a1, *b1, *a2, *b2, *a3, *b3, *ad, *bd;
  float lo1, lo2, shift, id_k, id_c, fine, inv_fine;
  int zp2;
};

// The shortcut conv's prescaled output, through the int16 leg when fine != 0.
__device__ __forceinline__ float shortcut_leg(int acc, float a, float b, float fine, float inv_fine) {
  float idq = __fadd_rn(__fmul_rn(static_cast<float>(acc), a), b);
  if (fine != 0.0f) {
    const float f = fminf(fmaxf(rintf(__fmul_rn(idq, fine)), -32767.0f), 32767.0f);
    idq = __fmul_rn(f, inv_fine);
  }
  return idq;
}

// The residual sum requantized onto the out grid (ReLU in the clip floor).
__device__ __forceinline__ int8_t residual_out(float y, float idq, float shift) {
  float q = rintf(__fadd_rn(y, idq));
  q = fminf(fmaxf(q, shift), 127.0f);
  return static_cast<int8_t>(static_cast<int>(q));
}

// acc += A x W[n0 : n0+64, 0:K]^T, the A tile's (row, k) chunk from gather;
// K % 16 == 0 and W 16-byte aligned.
template <typename Gather>
__device__ __forceinline__ void gemm_tile(int8_t* As, int8_t* Ws, const int8_t* W, int rows, int K,
                                          int n0, Gather&& gather, qt::Acc& acc) {
  for (int k0 = 0; k0 < K; k0 += qt::BK) {
    for (int i = threadIdx.x; i < qt::BM * CPR; i += qt::THREADS) {
      const int r = i / CPR, c = (i % CPR) * 16;
      *reinterpret_cast<uint4*>(As + r * qt::LDS + c) = (k0 + c < K) ? gather(r, k0 + c) : zero16();
    }
    qt::stage_rows(Ws, W, rows, K, n0, k0, true);
    __syncthreads();
    qt::mma_tile(As, Ws, acc);
    __syncthreads();
  }
}

__host__ __device__ inline size_t smem_bytes(const BlockShape& s) {
  return static_cast<size_t>(qt::BM + qt::BN) * qt::LDS +
         static_cast<size_t>(s.HR) * (s.W + 2) * s.P + static_cast<size_t>(s.R) * s.Wo * s.P;
}

template <int S, bool DS>
__global__ void __launch_bounds__(qt::THREADS)
    fused_bottleneck_kernel(const int8_t* __restrict__ X, const int8_t* __restrict__ W1,
                            const int8_t* __restrict__ W2, const int8_t* __restrict__ W3,
                            const int8_t* __restrict__ WD, int8_t* __restrict__ out, BlockShape s,
                            Epilogue e) {
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* As = smem;
  int8_t* Ws = As + qt::BM * qt::LDS;
  int8_t* h1 = Ws + qt::BN * qt::LDS;                          // HR x (W+2) pixels
  int8_t* h2 = h1 + static_cast<size_t>(s.HR) * (s.W + 2) * s.P;  // R*Wo pixels

  const int img = blockIdx.y;
  const int r0 = blockIdx.x * s.R;          // first output row of the band
  const int rb = min(s.R, s.Ho - r0);       // its output rows
  const int hb = r0 * S - 1;                // image row of h1's local row 0
  const int8_t* x = X + static_cast<size_t>(img) * s.H * s.W * s.C;

  // h1's border and out-of-image rows hold conv2's stored zero point
  {
    const uint4 fill = fill16(e.zp2);
    const int n16 = s.HR * (s.W + 2) * s.P / 16;
    for (int i = threadIdx.x; i < n16; i += qt::THREADS) reinterpret_cast<uint4*>(h1)[i] = fill;
  }
  __syncthreads();

  // conv1 (1x1) on the band's h1 rows that lie inside the image
  const int lr_lo = max(0, -hb), lr_hi = min((rb - 1) * S + 3, s.H - hb);
  const int m1 = (lr_hi - lr_lo) * s.W;
  for (int m0 = 0; m0 < m1; m0 += qt::BM) {
    for (int n0 = 0; n0 < s.Cm; n0 += qt::BN) {
      qt::Acc acc = {};
      gemm_tile(As, Ws, W1, s.Cm, s.C, n0, [&](int r, int k) {
        const int m = m0 + r;
        if (m >= m1) return zero16();
        const int lr = lr_lo + m / s.W, col = m % s.W;
        return ld16(x + (static_cast<size_t>(hb + lr) * s.W + col) * s.C + k);
      }, acc);
      qt::for_each_acc(acc, [&](int r, int c, int a) {
        const int m = m0 + r, n = n0 + c;
        if (m >= m1 || n >= s.Cm) return;
        const int lr = lr_lo + m / s.W, col = m % s.W;
        h1[(static_cast<size_t>(lr) * (s.W + 2) + col + 1) * s.P + n] = requant(a, e.a1[n], e.b1[n], e.lo1);
      });
    }
  }
  __syncthreads();

  // conv2 (3x3, stride S): output (i, j), tap (dy, dx) reads h1 local pixel
  // (i*S + dy, j*S + dx), the border column included
  const int m2 = rb * s.Wo;
  for (int m0 = 0; m0 < m2; m0 += qt::BM) {
    for (int n0 = 0; n0 < s.Cm; n0 += qt::BN) {
      qt::Acc acc = {};
      gemm_tile(As, Ws, W2, s.Cm, 9 * s.Cm, n0, [&](int r, int k) {
        const int m = m0 + r;
        if (m >= m2) return zero16();
        const int i = m / s.Wo, j = m % s.Wo;
        const int tap = k / s.Cm, ch = k % s.Cm;
        const int dy = tap / 3, dx = tap % 3;
        return ld16(h1 + (static_cast<size_t>(i * S + dy) * (s.W + 2) + j * S + dx) * s.P + ch);
      }, acc);
      qt::for_each_acc(acc, [&](int r, int c, int a) {
        const int m = m0 + r, n = n0 + c;
        if (m >= m2 || n >= s.Cm) return;
        h2[static_cast<size_t>(m) * s.P + n] = requant(a, e.a2[n], e.b2[n], e.lo2);
      });
    }
  }
  __syncthreads();

  // conv3 (1x1) and the shortcut, then the final epilogue to the output
  for (int m0 = 0; m0 < m2; m0 += qt::BM) {
    for (int n0 = 0; n0 < s.Cout; n0 += qt::BN) {
      qt::Acc acc = {}, accd = {};
      gemm_tile(As, Ws, W3, s.Cout, s.Cm, n0, [&](int r, int k) {
        const int m = m0 + r;
        return m < m2 ? ld16(h2 + static_cast<size_t>(m) * s.P + k) : zero16();
      }, acc);
      if constexpr (DS) {
        gemm_tile(As, Ws, WD, s.Cout, s.C, n0, [&](int r, int k) {
          const int m = m0 + r;
          if (m >= m2) return zero16();
          const int i = m / s.Wo, j = m % s.Wo;
          return ld16(x + (static_cast<size_t>((r0 + i) * S) * s.W + j * S) * s.C + k);
        }, accd);
      }
      qt::for_each_acc_pair(acc, accd, [&](int r, int c, int a3, int ad) {
        const int m = m0 + r, n = n0 + c;
        if (m >= m2 || n >= s.Cout) return;
        const int i = m / s.Wo, j = m % s.Wo;
        const float y = __fadd_rn(__fmul_rn(static_cast<float>(a3), e.a3[n]), e.b3[n]);
        float idq;
        if constexpr (DS) {
          idq = shortcut_leg(ad, e.ad[n], e.bd[n], e.fine, e.inv_fine);
        } else {
          const float xv = static_cast<float>(x[(static_cast<size_t>(r0 + i) * s.W + j) * s.C + n]);
          idq = __fadd_rn(__fmul_rn(xv, e.id_k), e.id_c);
        }
        out[((static_cast<size_t>(img) * s.Ho + r0 + i) * s.Wo + j) * s.Cout + n] =
            residual_out(y, idq, e.shift);
      });
    }
  }
}

struct BasicShape {
  int N, H, W, C, Cm, Ho, Wo, R, P;  // P: h1 pixel pitch
};

struct BasicEpilogue {
  const float *a1, *b1, *a2, *b2, *ad, *bd;
  float lo1, shift, id_k, id_c, fine, inv_fine;
  int zp1, zp2;
};

__host__ __device__ inline size_t basic_smem_bytes(const BasicShape& s) {
  return static_cast<size_t>(qt::BM + qt::BN) * qt::LDS + static_cast<size_t>(s.R + 2) * (s.Wo + 2) * s.P;
}

template <int S, bool DS>
__global__ void __launch_bounds__(qt::THREADS)
    fused_basicblock_kernel(const int8_t* __restrict__ X, const int8_t* __restrict__ W1,
                            const int8_t* __restrict__ W2, const int8_t* __restrict__ WD,
                            int8_t* __restrict__ out, BasicShape s, BasicEpilogue e) {
  extern __shared__ __align__(16) int8_t smem[];
  int8_t* As = smem;
  int8_t* Ws = As + qt::BM * qt::LDS;
  int8_t* h1 = Ws + qt::BN * qt::LDS;  // R+2 rows x (Wo+2) pixels

  const int img = blockIdx.y;
  const int r0 = blockIdx.x * s.R;     // first output row of the band
  const int rb = min(s.R, s.Ho - r0);  // its output rows
  const int pw = s.Wo + 2;             // h1 pixels per row
  const int8_t* x = X + static_cast<size_t>(img) * s.H * s.W * s.C;

  // h1's border and out-of-image rows hold conv2's stored zero point
  {
    const uint4 fill = fill16(e.zp2);
    const int n16 = (s.R + 2) * pw * s.P / 16;
    for (int i = threadIdx.x; i < n16; i += qt::THREADS) reinterpret_cast<uint4*>(h1)[i] = fill;
  }
  __syncthreads();

  // conv1 (3x3, stride S) on output-grid rows r0-1 ... r0+rb that lie inside
  // the image; h1 local row = grid row - r0 + 1, local column = column + 1
  const uint4 pad1 = fill16(e.zp1);
  const int i_lo = max(0, r0 - 1), i_hi = min(s.Ho, r0 + rb + 1);
  const int m1 = (i_hi - i_lo) * s.Wo;
  for (int m0 = 0; m0 < m1; m0 += qt::BM) {
    for (int n0 = 0; n0 < s.Cm; n0 += qt::BN) {
      qt::Acc acc = {};
      gemm_tile(As, Ws, W1, s.Cm, 9 * s.C, n0, [&](int r, int k) {
        const int m = m0 + r;
        if (m >= m1) return zero16();
        const int i = i_lo + m / s.Wo, j = m % s.Wo;
        const int tap = k / s.C, ch = k - tap * s.C;
        const int hi = i * S - 1 + tap / 3, wi = j * S - 1 + tap % 3;
        if (hi < 0 || hi >= s.H || wi < 0 || wi >= s.W) return pad1;
        return ld16(x + (static_cast<size_t>(hi) * s.W + wi) * s.C + ch);
      }, acc);
      qt::for_each_acc(acc, [&](int r, int c, int a) {
        const int m = m0 + r, n = n0 + c;
        if (m >= m1 || n >= s.Cm) return;
        const int i = i_lo + m / s.Wo, j = m % s.Wo;
        h1[(static_cast<size_t>(i - r0 + 1) * pw + j + 1) * s.P + n] = requant(a, e.a1[n], e.b1[n], e.lo1);
      });
    }
  }
  __syncthreads();

  // conv2 (3x3, stride 1): local output (i, j), tap (dy, dx) reads h1 local
  // pixel (i + dy, j + dx); then the shortcut and the final epilogue
  const int m2 = rb * s.Wo;
  for (int m0 = 0; m0 < m2; m0 += qt::BM) {
    for (int n0 = 0; n0 < s.Cm; n0 += qt::BN) {
      qt::Acc acc = {}, accd = {};
      gemm_tile(As, Ws, W2, s.Cm, 9 * s.Cm, n0, [&](int r, int k) {
        const int m = m0 + r;
        if (m >= m2) return zero16();
        const int i = m / s.Wo, j = m % s.Wo;
        const int tap = k / s.Cm, ch = k - tap * s.Cm;
        return ld16(h1 + (static_cast<size_t>(i + tap / 3) * pw + j + tap % 3) * s.P + ch);
      }, acc);
      if constexpr (DS) {
        gemm_tile(As, Ws, WD, s.Cm, s.C, n0, [&](int r, int k) {
          const int m = m0 + r;
          if (m >= m2) return zero16();
          const int i = m / s.Wo, j = m % s.Wo;
          return ld16(x + (static_cast<size_t>((r0 + i) * S) * s.W + j * S) * s.C + k);
        }, accd);
      }
      qt::for_each_acc_pair(acc, accd, [&](int r, int c, int a2, int ad) {
        const int m = m0 + r, n = n0 + c;
        if (m >= m2 || n >= s.Cm) return;
        const int i = m / s.Wo, j = m % s.Wo;
        const float y = __fadd_rn(__fmul_rn(static_cast<float>(a2), e.a2[n]), e.b2[n]);
        float idq;
        if constexpr (DS) {
          idq = shortcut_leg(ad, e.ad[n], e.bd[n], e.fine, e.inv_fine);
        } else {
          const float xv = static_cast<float>(x[(static_cast<size_t>(r0 + i) * s.W + j) * s.C + n]);
          idq = __fadd_rn(__fmul_rn(xv, e.id_k), e.id_c);
        }
        out[((static_cast<size_t>(img) * s.Ho + r0 + i) * s.Wo + j) * s.Cm + n] = residual_out(y, idq, e.shift);
      });
    }
  }
}

template <int S, bool DS>
int launch_bottleneck(const void* x, const void* w1, const void* w2, const void* w3, const void* wd,
                      void* out, BlockShape s, const Epilogue& e, void* stream) {
  if (s.N < 1 || s.R < 1 || s.C % 16 || s.Cm % 16 || s.H % S || s.W % S || !qt::aligned16(x) ||
      !qt::aligned16(w1) || !qt::aligned16(w2) || !qt::aligned16(w3) || (DS && !qt::aligned16(wd)))
    return static_cast<int>(cudaErrorInvalidValue);
  s.Ho = s.H / S;
  s.Wo = s.W / S;
  s.HR = (s.R - 1) * S + 3;
  s.P = s.Cm + 16;
  return launch(fused_bottleneck_kernel<S, DS>, dim3((s.Ho + s.R - 1) / s.R, s.N), smem_bytes(s), stream,
                static_cast<const int8_t*>(x), static_cast<const int8_t*>(w1),
                static_cast<const int8_t*>(w2), static_cast<const int8_t*>(w3),
                static_cast<const int8_t*>(wd), static_cast<int8_t*>(out), s, e);
}

template <int S, bool DS>
int launch_basic(const void* x, const void* w1, const void* w2, const void* wd, void* out, BasicShape s,
                 const BasicEpilogue& e, void* stream) {
  if (s.N < 1 || s.R < 1 || s.C % 16 || s.Cm % 16 || s.H % S || s.W % S || (!DS && s.C != s.Cm) ||
      !qt::aligned16(x) || !qt::aligned16(w1) || !qt::aligned16(w2) || (DS && !qt::aligned16(wd)))
    return static_cast<int>(cudaErrorInvalidValue);
  s.Ho = s.H / S;
  s.Wo = s.W / S;
  s.P = s.Cm + 16;
  return launch(fused_basicblock_kernel<S, DS>, dim3((s.Ho + s.R - 1) / s.R, s.N), basic_smem_bytes(s),
                stream, static_cast<const int8_t*>(x), static_cast<const int8_t*>(w1),
                static_cast<const int8_t*>(w2), static_cast<const int8_t*>(wd), static_cast<int8_t*>(out),
                s, e);
}

}  // namespace

// Identity block: Cout = C, stride 1, idq = x*id_k + id_c.
extern "C" int qt_fused_bottleneck_s1(const void* x, const void* w1, const void* w2, const void* w3,
                                      const void* a1, const void* b1, const void* a2, const void* b2,
                                      const void* a3, const void* b3, void* out, int N, int H, int W,
                                      int C, int Cm, int R, int zp2, float lo1, float lo2, float shift,
                                      float id_k, float id_c, void* stream) {
  const BlockShape s{N, H, W, C, Cm, C, 0, 0, R, 0, 0};
  const Epilogue e{static_cast<const float*>(a1), static_cast<const float*>(b1),
                   static_cast<const float*>(a2), static_cast<const float*>(b2),
                   static_cast<const float*>(a3), static_cast<const float*>(b3),
                   nullptr, nullptr, lo1, lo2, shift, id_k, id_c, 0.0f, 0.0f, zp2};
  return launch_bottleneck<1, false>(x, w1, w2, w3, nullptr, out, s, e, stream);
}

// Downsample block: stride 1 or 2, the 1x1/stride shortcut conv on x[::S, ::S].
extern "C" int qt_fused_bottleneck_ds(const void* x, const void* w1, const void* w2, const void* w3,
                                      const void* wd, const void* a1, const void* b1, const void* a2,
                                      const void* b2, const void* a3, const void* b3, const void* ad,
                                      const void* bd, void* out, int N, int H, int W, int C, int Cm,
                                      int Cout, int stride, int R, int zp2, float lo1, float lo2,
                                      float shift, float fine, float inv_fine, void* stream) {
  const BlockShape s{N, H, W, C, Cm, Cout, 0, 0, R, 0, 0};
  const Epilogue e{static_cast<const float*>(a1), static_cast<const float*>(b1),
                   static_cast<const float*>(a2), static_cast<const float*>(b2),
                   static_cast<const float*>(a3), static_cast<const float*>(b3),
                   static_cast<const float*>(ad), static_cast<const float*>(bd),
                   lo1, lo2, shift, 0.0f, 0.0f, fine, inv_fine, zp2};
  if (stride == 1) return launch_bottleneck<1, true>(x, w1, w2, w3, wd, out, s, e, stream);
  if (stride == 2) return launch_bottleneck<2, true>(x, w1, w2, w3, wd, out, s, e, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Identity BasicBlock: C == Cm, stride 1, idq = x*id_k + id_c.
extern "C" int qt_fused_basicblock_s1(const void* x, const void* w1, const void* w2, const void* a1,
                                      const void* b1, const void* a2, const void* b2, void* out, int N,
                                      int H, int W, int C, int Cm, int R, int zp1, int zp2, float lo1,
                                      float shift, float id_k, float id_c, void* stream) {
  const BasicShape s{N, H, W, C, Cm, 0, 0, R, 0};
  const BasicEpilogue e{static_cast<const float*>(a1), static_cast<const float*>(b1),
                        static_cast<const float*>(a2), static_cast<const float*>(b2),
                        nullptr, nullptr, lo1, shift, id_k, id_c, 0.0f, 0.0f, zp1, zp2};
  return launch_basic<1, false>(x, w1, w2, nullptr, out, s, e, stream);
}

// Downsample BasicBlock: stride 1 or 2, the 1x1/stride shortcut conv on x[::S, ::S].
extern "C" int qt_fused_basicblock_ds(const void* x, const void* w1, const void* w2, const void* wd,
                                      const void* a1, const void* b1, const void* a2, const void* b2,
                                      const void* ad, const void* bd, void* out, int N, int H, int W,
                                      int C, int Cm, int stride, int R, int zp1, int zp2, float lo1,
                                      float shift, float fine, float inv_fine, void* stream) {
  const BasicShape s{N, H, W, C, Cm, 0, 0, R, 0};
  const BasicEpilogue e{static_cast<const float*>(a1), static_cast<const float*>(b1),
                        static_cast<const float*>(a2), static_cast<const float*>(b2),
                        static_cast<const float*>(ad), static_cast<const float*>(bd),
                        lo1, shift, 0.0f, 0.0f, fine, inv_fine, zp1, zp2};
  if (stride == 1) return launch_basic<1, true>(x, w1, w2, wd, out, s, e, stream);
  if (stride == 2) return launch_basic<2, true>(x, w1, w2, wd, out, s, e, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
