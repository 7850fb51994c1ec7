// The Hopper route of K2's gather-K form (int8_conv.cu): the small-Cin convs
// (Cin <= 32, more than one tap: the stems, CIFAR's 16- and 32-channel 3x3
// convs) as one wgmma product over all taps at once.
//
//   acc[p, n] = sum_k A[p, k] * W[n, k],   k = (kh * KW + kw) * Cin + c
//
// What bounds these convs on the H100: their output bytes (the s2d stem at
// batch 32 writes 25.7 MB, 0.0077 ms at 3.35 TB/s, against 3.8 G int8
// operations, 0.0019 ms). The general tile they ran on gathered A from
// device memory for every 64-byte K step, one byte at a time for Cin 3
// (121 reads of each input byte for AlexNet's 11x11), re-staged the weights
// every step and stored scattered bytes from the MMA fragments.
//
// Design:
// - Persistent blocks (up to three an SM, as the plan's shared memory allows)
//   walk tiles of whole output rows, at most 128 pixels: `two` columns x
//   `tho` rows x `nb` images (ops.conv_plan, as for K2's per-tap form, with
//   smaller tiles where there would be fewer tiles than SMs). Only the
//   tile's rows are built and stored.
// - The tile's input window, nb x WR = (tho - 1) * SH + KH rows of WC =
//   (two - 1) * SW + KW pixels x Cin, sits in shared memory; pixels outside
//   the image hold the stored zero point, so padding is exact by
//   construction and needs no border sums. The next tile's window is loaded
//   by cp.async (16-byte copies where both addresses allow, else 4-byte;
//   the window's left margin LP puts its first in-image byte on a 16-byte
//   boundary) while this tile is built, multiplied and stored.
// - The weights stay resident for the block's life: (BN, Kp) with Kp = K
//   rounded up to wgmma's 32-byte step, zero past K and past Cout, in
//   wgmma's K-major layout under the swizzle of KB = 32, 64 or 128 bytes a
//   row (the narrowest that holds Kp, else 128 in Kp / 128 blocks).
// - A is built from the window in the same swizzled layout: one output
//   pixel's K row is KH contiguous runs of KW * Cin bytes (input pixels wo *
//   SW - PW .. + KW - 1 of row ho * SH - PH + kh), so a thread copies a
//   fixed K unit of every 256 / units-a-row-th row: 16 bytes where Cin % 16
//   == 0, 4 where Cin % 4 == 0 (the s2d stem, Cin 12), and for Cin 3 a
//   4-byte word assembled from two aligned words by a funnel shift (two
//   where it crosses into the next run). Bytes past K meet zero weights.
// - Two consumer warpgroups multiply their 64 rows by the weights (wgmma,
//   both operands from shared memory), Kp / 32 steps.
// - The epilogue is K2's, in K2's order: y = acc * alpha[n] + beta[n], ReLU
//   if asked, then f32 out or q = clip(rint(y * inv + zps), -128, 127), one
//   rounding per operation (__fmul_rn, __fadd_rn, -fmad=false; rint and
//   the clip by adding 1.5 * 2^23 to the clipped value, sm90.cuh
//   clip_round_byte), so every output equals int8_conv_direct_plain to the
//   bit. The CLIP instances (a clamped conv: the RangeBN observer clamp)
//   clamp y to per-channel bounds before ReLU (f32 out), or the value to be
//   rounded to integer-valued bounds in place of ReLU and [-128, 127] (s8
//   out: their lo holds the ReLU floor; the clip first commutes with the
//   rounding, as in clip_round_byte). It goes
//   through a
//   shared staging tile, one row a pixel (16 bytes apart beyond its Cout
//   outputs, so the fragments' stores of eight rows fall in distinct banks),
//   from which every thread copies 16-byte pieces (8 or 4 where a pixel's
//   outputs are not a multiple of 16 bytes) out to the output: a tile of
//   whole rows is one contiguous range of NHWC, so the stores coalesce.
#pragma once

#include "conv_sm90.cuh"

namespace qtgk {
// Internal linkage, as in conv_sm90.cuh.
namespace {

constexpr int TILE_M = 128;  // output pixels per tile: two warpgroups of 64 rows
constexpr int THREADS = 256;
constexpr int MAX_BN = 64;

struct GkGeom {
  int N, H, W, Cin, Cout, KH, KW, SH, SW, PH, PW, Ho, Wo;
  int two, tho, nb;    // a tile: output columns x rows x images
  int K, Kp, KB;       // K; K rounded up to 32; swizzle row bytes
  int WR, WC, RP;      // the window: rows an image, pixels a row, row pitch in bytes
  int w_tiles, h_tiles, tiles;
};

struct GkEpi {
  const float* alpha;
  const float* beta;
  void* out;
  int stored_zp, relu, out_int8;
  float inv, zps;
  const float* clip_lo;  // CLIP: (Cout,) bounds of y (f32 out) or of the rounded value (s8 out), else null
  const float* clip_hi;
};

// Offsets in the dynamic shared memory (after aligning its base to 1024):
// A, the weights, the staging tile (128 rows of stage_pitch bytes), two
// windows, the epilogue constants and the row tables (each row's window
// corner, and its output pixel for either tile parity); `total` includes the
// 1024 bytes of alignment slack.
struct GkLayout {
  int a, w, stage, win, consts, corner, total;
};

__host__ __device__ constexpr int align16(int v) { return (v + 15) / 16 * 16; }

// a staging row: a pixel's outputs, rounded up to 16 bytes, and 16 more
__host__ __device__ constexpr int stage_pitch(int cout, int out_bytes) { return align16(cout * out_bytes) + 16; }

__host__ __device__ inline GkLayout gk_layout(const GkGeom& g, int bn, int out_bytes) {
  const int nkb = (g.Kp + g.KB - 1) / g.KB;
  GkLayout l{};
  l.a = 0;
  l.w = TILE_M * g.KB * nkb;
  l.stage = l.w + bn * g.KB * nkb;
  l.win = l.stage + TILE_M * stage_pitch(g.Cout, out_bytes);
  l.consts = l.win + 2 * g.nb * g.WR * g.RP;
  l.corner = l.consts + 2 * MAX_BN * 4;
  l.total = l.corner + 3 * TILE_M * 4 + 1024;
  return l;
}

__device__ __forceinline__ void tile_box(const GkGeom& g, int t, int& n0, int& ho0, int& wo0) {
  const int wi = t % g.w_tiles, rest = t / g.w_tiles;
  n0 = (rest / g.h_tiles) * g.nb;
  ho0 = (rest % g.h_tiles) * g.tho;
  wo0 = wi * g.two;
}

// The window's left margin: puts the first in-image byte of every row on a
// 16-byte boundary (c_lo pixels of left padding precede it)
__device__ __forceinline__ int left_margin(const GkGeom& g, int wo0) {
  const int c_lo = min(max(0, g.PW - wo0 * g.SW), g.WC);
  return (16 - (c_lo * g.Cin) % 16) % 16;
}

// Tile t's window into `win` (generic pointer) at shared address `swin`:
// warp w takes rows w, w + 8, ...; out-of-image bytes are the stored zero
// point's, the rest arrive by cp.async (byte copies where neither 16- nor
// 4-byte copies are aligned)
__device__ __forceinline__ void issue_window(const GkGeom& g, const int8_t* __restrict__ x, int8_t* win,
                                             uint32_t swin, int t, int8_t zp) {
  int n0, ho0, wo0;
  tile_box(g, t, n0, ho0, wo0);
  const int wi0 = wo0 * g.SW - g.PW, hi0 = ho0 * g.SH - g.PH;
  const int c_lo = min(max(0, -wi0), g.WC), c_hi = min(max(c_lo, g.W - wi0), g.WC);
  const int lp = left_margin(g, wo0), rowb = g.WC * g.Cin;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int rr = warp; rr < g.nb * g.WR; rr += THREADS / 32) {
    const int img = rr / g.WR, n = n0 + img, hi = hi0 + rr - img * g.WR;
    const int off = rr * g.RP + lp;
    int8_t* row = win + off;
    const bool in = n < g.N && hi >= 0 && hi < g.H && c_hi > c_lo;
    const int b0 = in ? c_lo * g.Cin : rowb, b1 = in ? c_hi * g.Cin : rowb;
    for (int i = lane; i < b0; i += 32) row[i] = zp;
    for (int i = b1 + lane; i < rowb; i += 32) row[i] = zp;
    if (!in) continue;
    const int8_t* src = x + ((static_cast<long long>(n) * g.H + hi) * g.W + wi0 + c_lo) * g.Cin;
    const uint32_t dst = swin + off + b0;
    const int len = b1 - b0;
    const uint32_t mis = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(src)) | dst;
    int done = 0;
    if ((mis & 15u) == 0) {
      for (int i = lane; i < len / 16; i += 32) qt90::cp_async16(dst + 16 * i, src + 16 * i);
      done = len / 16 * 16;
    }
    if (done > 0 || (mis & 3u) == 0) {
      const int n4 = (len - done) / 4;
      for (int i = lane; i < n4; i += 32) qt90::cp_async4(dst + done + 4 * i, src + done + 4 * i);
      done += n4 * 4;
    }
    for (int i = done + lane; i < len; i += 32) row[b0 + i] = src[i];
  }
}

// 4 bytes at byte offset a of a shared buffer (any alignment): two aligned
// words, funnel-shifted
__device__ __forceinline__ uint32_t lds_any4(const uint8_t* buf, uint32_t a) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(buf + (a & ~3u));
  return __funnelshift_r(w[0], w[1], (a & 3u) * 8u);
}

// A of the tile's first `rows` rows (the rest are computed, never stored),
// built from the window `win` into the swizzled A `sa` (shared buffers);
// corner[m]: the byte offset of row m's window corner
template <int CH>
__device__ __forceinline__ void build_a(const GkGeom& g, const uint8_t* win, uint8_t* sa, const int* corner,
                                        int rows) {
  constexpr int U = CH == 16 ? 16 : 4;  // bytes a thread copies at a time
  const int upr = g.Kp / U, groups = THREADS / upr;
  const int u = threadIdx.x % upr, grp = threadIdx.x / upr;
  if (grp >= groups) return;
  const int k = u * U, L = g.KW * g.Cin;
  const bool valid = k < g.K;
  const int kh = k / L, j = k - kh * L;
  const uint32_t koff = kh * g.RP + j;
  // Cin 3: the bytes left in this run; a unit that crosses into run kh + 1
  // takes its last 4 - p bytes from there (past the last run: bytes of any
  // value, meeting zero weights)
  const int p = L - j;
  const bool cross = CH == 1 && p < 4 && kh + 1 < g.KH;
  const uint32_t koff2 = (kh + 1) * g.RP - p;
  const uint32_t keep = cross ? (1u << (8 * p)) - 1u : ~0u;
  const int blk = k / g.KB, c = k - blk * g.KB;
  uint8_t* dst0 = sa + blk * TILE_M * g.KB;
  for (int m = grp; m < rows; m += groups) {
    uint8_t* dst = dst0 + qt90::sw_offset(m, c, g.KB);
    const uint32_t src = corner[m] + koff;
    if constexpr (CH == 16) {
      *reinterpret_cast<uint4*>(dst) = valid ? *reinterpret_cast<const uint4*>(win + src) : make_uint4(0u, 0u, 0u, 0u);
    } else {
      uint32_t v = 0u;
      if (valid) {
        if constexpr (CH == 4) {
          v = *reinterpret_cast<const uint32_t*>(win + src);
        } else {
          v = lds_any4(win, src);
          if (cross) v = (v & keep) | (lds_any4(win, corner[m] + koff2) & ~keep);
        }
      }
      *reinterpret_cast<uint32_t*>(dst) = v;
    }
  }
}

template <int CH, int BN, bool CLIP, bool EXP>
__global__ void __launch_bounds__(THREADS, 3)
    gatherk_sm90_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w, GkGeom g, GkEpi ep) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = qt90::smem_u32(smem_raw);
  uint8_t* base = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const uint32_t sbase = qt90::smem_u32(base);
  const int esize = ep.out_int8 ? 1 : 4;
  const GkLayout l = gk_layout(g, BN, esize);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* alpha = reinterpret_cast<float*>(base + l.consts);
  float* beta = alpha + MAX_BN;
  int* corner = reinterpret_cast<int*>(base + l.corner);
  const int8_t zp = static_cast<int8_t>(ep.stored_zp);

  // the first tile's window; the weights, zero past K and Cout, swizzled; the constants
  if (static_cast<int>(blockIdx.x) < g.tiles)
    issue_window(g, x, reinterpret_cast<int8_t*>(base + l.win), sbase + l.win, blockIdx.x, zp);
  qt90::cp_async_commit();
  if (g.K % 16 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0) {  // 16 bytes at a time (the swizzle moves whole 16-byte pieces)
    const int ppr = g.Kp / 16;
    for (int i = tid; i < BN * ppr; i += THREADS) {
      const int n = i / ppr, k = 16 * (i - n * ppr), blk = k / g.KB;
      const uint4 v = n < g.Cout && k < g.K ? __ldg(reinterpret_cast<const uint4*>(w + static_cast<long long>(n) * g.K + k))
                                            : make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(base + l.w + blk * BN * g.KB + qt90::sw_offset(n, k - blk * g.KB, g.KB)) = v;
    }
  } else {
    for (int i = tid; i < BN * g.Kp; i += THREADS) {
      const int n = i / g.Kp, k = i - n * g.Kp, blk = k / g.KB;
      base[l.w + blk * BN * g.KB + qt90::sw_offset(n, k - blk * g.KB, g.KB)] =
          n < g.Cout && k < g.K ? static_cast<uint8_t>(w[static_cast<long long>(n) * g.K + k]) : 0;
    }
  }
  if (tid < MAX_BN) {
    alpha[tid] = tid < g.Cout ? ep.alpha[tid] : 0.0f;
    beta[tid] = tid < g.Cout ? ep.beta[tid] : 0.0f;
  }

  const int wg = warp >> 2, gq = lane >> 2, tq = lane & 3;
  const int row0 = 64 * wg + 16 * (warp & 3) + gq;  // the thread's accumulator rows: row0, row0 + 8
  const int rb = g.Cout * esize, sp = stage_pitch(g.Cout, esize);  // bytes an output pixel; a staging row
  // the widest piece that divides a pixel's outputs and keeps the output's stores aligned
  const uintptr_t oa = reinterpret_cast<uintptr_t>(ep.out);
  const int piece = rb % 16 == 0 && oa % 16 == 0 ? 16 : rb % 8 == 0 && oa % 8 == 0 ? 8 : rb % 4 == 0 && oa % 4 == 0 ? 4 : 1;
  const int ppr = rb / piece, out_pc = tid % ppr, out_grp = tid / ppr;  // pieces a pixel; the thread's piece, first row
  const int out_step = THREADS / ppr;                       // rows a pass (a pixel's outputs are at most 256 bytes)
  const int rows = g.two * g.tho * g.nb;                    // a tile's rows
  const int wbytes = g.nb * g.WR * g.RP;  // one window
  int i = 0;
  for (int t = blockIdx.x; t < g.tiles; t += gridDim.x, ++i) {
    const int buf = i & 1;
    if (t + static_cast<int>(gridDim.x) < g.tiles)
      issue_window(g, x, reinterpret_cast<int8_t*>(base + l.win + (buf ^ 1) * wbytes),
                   sbase + l.win + (buf ^ 1) * wbytes, t + gridDim.x, zp);
    qt90::cp_async_commit();
    qt90::cp_async_wait<1>();  // this thread's copies of tile t's window have landed
    int n0, ho0, wo0;
    tile_box(g, t, n0, ho0, wo0);
    // the row tables: the window corner of each tile row, and its output
    // pixel or -1 (one per tile parity: the previous tile's copy-out may
    // still read its own)
    int* outpix = corner + TILE_M * (1 + buf);
    if (tid < rows) {
      const int m = tid, img = m / (g.two * g.tho), rem = m - img * g.two * g.tho, ho = rem / g.two,
                wo = rem - ho * g.two;
      corner[m] = (img * g.WR + ho * g.SH) * g.RP + left_margin(g, wo0) + wo * g.SW * g.Cin;
      outpix[m] = n0 + img < g.N && ho0 + ho < g.Ho && wo0 + wo < g.Wo
                      ? ((n0 + img) * g.Ho + ho0 + ho) * g.Wo + wo0 + wo : -1;
    }
    __syncthreads();  // every thread's window copies and the row tables
    build_a<CH>(g, base + l.win + buf * wbytes, base + l.a, corner, rows);
    qt90::fence_proxy_async();  // A (and, the first time, the weights) before wgmma reads them
    __syncthreads();

    int acc[BN / 2];
#pragma unroll
    for (int r = 0; r < BN / 2; ++r) acc[r] = 0;
    qt90::wgmma_fence();
    qt90::fence_acc(acc);
    for (int s = 0; s < g.Kp / 32; ++s) {
      const int blk = s * 32 / g.KB, kk = s - blk * (g.KB / 32);
      const uint64_t da = qt90::sw_desc(sbase + l.a + blk * TILE_M * g.KB + wg * 64 * g.KB, g.KB) + 2 * kk;
      const uint64_t db = qt90::sw_desc(sbase + l.w + blk * BN * g.KB, g.KB) + 2 * kk;
      qt90::Wgmma<BN>::ss(acc, da, db);
    }
    qt90::wgmma_commit();
    qt90::wgmma_wait<0>();
    qt90::fence_acc(acc);

    // the epilogue into the staging tile (the previous tile's copy-out read
    // it before the barriers since), a row a pixel
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = 8 * j + 2 * tq + e;
        if (n >= g.Cout) continue;
        const float al = alpha[n], be = beta[n];
        float cl = 0.0f, ch = 0.0f;
        if constexpr (CLIP) {
          cl = __ldg(ep.clip_lo + n);
          ch = __ldg(ep.clip_hi + n);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = row0 + 8 * h;
          if (m >= rows) continue;
          float y = __fadd_rn(__fmul_rn(static_cast<float>(acc[4 * j + 2 * h + e]), al), be);
          if constexpr (CLIP) {
            if (!ep.out_int8) y = fminf(fmaxf(y, cl), ch);
          }
          if constexpr (EXP)
            y = qt::activate_exp(y, ep.relu);  // SiLU or the sigmoid, on instances of their own
          else if (ep.relu && !(CLIP && ep.out_int8))
            y = fmaxf(y, 0.0f);  // s8 CLIP: the floor is in clip_lo
          if (ep.out_int8) {  // clip(rint(y * inv + zps), -128, 127), the clip first (sm90.cuh)
            const float v = __fadd_rn(__fmul_rn(y, ep.inv), ep.zps);
            uint32_t q;
            if constexpr (CLIP)
              q = __float_as_uint(__fadd_rn(fminf(fmaxf(v, cl), ch), qt90::ROUND_MAGIC));
            else
              q = qt90::clip_round_byte(v, -128.0f);
            base[l.stage + m * sp + n] = static_cast<uint8_t>(q);
          } else {
            *reinterpret_cast<float*>(base + l.stage + m * sp + 4 * n) = y;
          }
        }
      }
    __syncthreads();

    // out: every stored row's pixel, in pieces of `piece` bytes (consecutive
    // threads on consecutive pieces: a tile of whole rows is one contiguous
    // range of NHWC); thread tid copies piece tid % ppr of rows tid / ppr, +
    // THREADS / ppr, ...
    if (out_grp < out_step)
      for (int m = out_grp; m < rows; m += out_step) {
        const int pix = outpix[m];
        if (pix < 0) continue;
        int8_t* dst = static_cast<int8_t*>(ep.out) + static_cast<long long>(pix) * rb + out_pc * piece;
        const uint8_t* src = base + l.stage + m * sp + out_pc * piece;
        if (piece == 16)
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        else if (piece == 8)
          *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
        else if (piece == 4)
          *reinterpret_cast<uint32_t*>(dst) = *reinterpret_cast<const uint32_t*>(src);
        else
          *dst = static_cast<int8_t>(*src);
      }
  }
}

// ---- host side

// The launch plan of ops.conv_plan (form "gatherk"): the tile box, the
// swizzle row, the wgmma width, persistent blocks, dynamic shared memory
// (for s8 out; f32 out launches with its own, larger staging tile)
struct GkPlan {
  int kb, bn, two, tho, nb, blocks, smem;
};

template <int CH, int BN, bool CLIP, bool EXP>
int launch_instance(const void* x, const void* w, const GkGeom& g, const GkEpi& ep, int blocks, int smem,
                    cudaStream_t stream) {
  auto kernel = gatherk_sm90_kernel<CH, BN, CLIP, EXP>;
  static std::atomic<bool> opted_in{false};  // the full shared memory, asked for once per instance
  if (!opted_in.load()) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, qt::SMEM_LIMIT);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in.store(true);
  }
  kernel<<<blocks, THREADS, smem, stream>>>(static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), g, ep);
  return static_cast<int>(cudaGetLastError());
}

template <int CH, bool CLIP, bool EXP>
int launch_bn(const void* x, const void* w, const GkGeom& g, const GkEpi& ep, int bn, int blocks, int smem,
              cudaStream_t s) {
  switch (bn) {
    case 16: return launch_instance<CH, 16, CLIP, EXP>(x, w, g, ep, blocks, smem, s);
    case 32: return launch_instance<CH, 32, CLIP, EXP>(x, w, g, ep, blocks, smem, s);
    default: return launch_instance<CH, 64, CLIP, EXP>(x, w, g, ep, blocks, smem, s);
  }
}

// the clamp (CLIP) and SiLU or the sigmoid (EXP) each on instances of their own, never together
template <int CH>
int launch_clip(const void* x, const void* w, const GkGeom& g, const GkEpi& ep, int bn, int blocks, int smem,
                cudaStream_t s) {
  if (ep.relu >= qt::ACT_SILU)
    return ep.clip_lo != nullptr ? static_cast<int>(cudaErrorInvalidValue)
                                 : launch_bn<CH, false, true>(x, w, g, ep, bn, blocks, smem, s);
  return ep.clip_lo != nullptr ? launch_bn<CH, true, false>(x, w, g, ep, bn, blocks, smem, s)
                               : launch_bn<CH, false, false>(x, w, g, ep, bn, blocks, smem, s);
}

// The gather-K form on its Hopper route under plan p; 0 or the CUDA error.
// Refuses a plan that does not fit the shape (x 16-byte aligned; Cout <= 64).
inline int launch_gatherk(const void* x, const void* w, GkGeom g, const GkEpi& ep, const GkPlan& p, void* stream) {
  g.K = g.KH * g.KW * g.Cin;
  g.Kp = (g.K + 31) / 32 * 32;
  g.KB = p.kb;
  g.two = p.two;
  g.tho = p.tho;
  g.nb = p.nb;
  g.WR = (p.tho - 1) * g.SH + g.KH;
  g.WC = (p.two - 1) * g.SW + g.KW;
  g.RP = align16(15 + g.WC * g.Cin + 8);  // the left margin, the pixels, the funnel shifts' over-read
  g.w_tiles = (g.Wo + p.two - 1) / p.two;
  g.h_tiles = (g.Ho + p.tho - 1) / p.tho;
  g.tiles = g.w_tiles * g.h_tiles * ((g.N + p.nb - 1) / p.nb);
  const int ch = g.Cin % 16 == 0 ? 16 : g.Cin % 4 == 0 ? 4 : 1;
  const int units = g.Kp / (ch == 16 ? 16 : 4);
  const int kb_want = g.Kp <= 32 ? 32 : g.Kp <= 64 ? 64 : 128;
  const int bn_want = g.Cout <= 16 ? 16 : g.Cout <= 32 ? 32 : 64;
  const bool ok = g.N >= 1 && g.Ho >= 1 && g.Wo >= 1 && g.Cout >= 1 && g.Cout <= MAX_BN && p.kb == kb_want &&
                  p.bn == bn_want && p.two >= 1 && p.tho >= 1 && p.nb >= 1 && p.two * p.tho * p.nb <= TILE_M &&
                  (p.nb == 1 || (p.two == g.Wo && p.tho == g.Ho)) && units <= THREADS &&
                  (ch != 1 || g.KW * g.Cin >= 4) && p.blocks >= 1 && qt::aligned16(x) &&
                  p.smem == gk_layout(g, p.bn, 1).total && (ep.clip_lo == nullptr) == (ep.clip_hi == nullptr);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = gk_layout(g, p.bn, ep.out_int8 ? 1 : 4).total;
  if (smem > qt::SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ch) {
    case 16: return launch_clip<16>(x, w, g, ep, p.bn, p.blocks, smem, s);
    case 4: return launch_clip<4>(x, w, g, ep, p.bn, p.blocks, smem, s);
    default: return launch_clip<1>(x, w, g, ep, p.bn, p.blocks, smem, s);
  }
}

}  // namespace
}  // namespace qtgk
