// The Hopper conv mainloop of K2's per-tap form (int8_conv.cu) and of B7
// (int8_conv_flat.cu): an implicit GEMM on wgmma, fed by a TMA ring.
//
//   acc[p, n] = sum_{tap, c} A_tap[p, c] * W[n, tap * Cin + c]
//
// p runs over a tile of TILE_M = 128 output pixels (the GEMM rows, wgmma's
// M: two consumer warpgroups of 64 rows each) and n over BN = 32, 64 or 128
// output channels (wgmma's N). Both operands are K-major s8, the only layout
// wgmma takes for s8. One ring stage holds KC = 128, 64 or 32 bytes of K of
// both tiles (the widest that divides Cin; Cin 16 and 48 take 32 with the
// chunk past Cin zero-filled, and a 1x1 may take a stage wider than its Cin,
// as K2's pixel groups take Cin 96 in one stage of 128), loaded by TMA with
// the swizzle of that width, which wgmma's shared-memory descriptors read
// (sw_desc). A tile walks K tap by tap, ceil(Cin / KC) stages a tap.
//
// How A is addressed is all that differs between the two kernels, a
// runtime choice (ConvGeom::flat) in one set of kernel instances:
// - K2 (4-D boxes): a 4-D tiled tensor map over the unpadded NHWC input. A
//   tile is a box of `two` output columns x `tho` output rows x `nb` images
//   (two * tho * nb <= 128; several whole images where they are small, so a
//   7x7 layer fills 98 of 128 rows), loaded at the tap's input corner
//   (wo0 * SW - PW + kw, ho0 * SH - PH + kh) with the conv's stride as the
//   map's traversal stride. Taps that fall outside the image, negative
//   coordinates included, arrive as zeros, while K2 pads with the stored
//   zero point; the epilogue adds the difference back in int32:
//   stored_zp * sum over the pixel's outside taps of tapsum[tap][n], with
//   tapsum[tap][n] = sum_c W[n, tap * Cin + c]. The outside taps are the
//   window less a rectangle of inside taps, so the sum is five reads of the
//   summed-area table of tapsum (`border_sums`, computed once per weight),
//   whatever the kernel size; only the rows of border pixels read it.
//   |stored_zp * 25 taps * Cin * 127| < 2^31 at every shape of the repo, so
//   the sum is exact and the result equals the zero-point-padded conv.
// - B7 (flat rows): a 2-D map over the zero-point-padded flat rows (N * Hp
//   * Wp, Cin); tile row m of tap (dh, dw) reads flat row m + dh * Wp + dw,
//   a sum of shifted GEMMs. Rows past the image's output rows or columns
//   (the junk columns, and the (Kh - 1) * Wp rows between images) are
//   computed and not stored; only junk rows read past the buffer, where TMA
//   fills 0. K2's 1x1 stride-1 convs without padding read their input this
//   way too (Hp, Wp = H, W: no junk), in whole 128-row tiles.
//
// The ring: `stages` slots, each with a "full" mbarrier (TMA's bytes) and an
// "empty" one (one arrival per consumer warp once its wgmmas on the slot
// have retired). One producer warp (warp 8) keeps the ring full; blocks are
// persistent over the SMs and walk the tiles with a stride of the grid, n
// fastest, so the producer loads the next tile while the consumers run the
// epilogue of this one, and the Cout / BN tiles that share an A tile run
// side by side and find it in L2. A stage's wgmmas retire while the next
// stage is waited for (wait_group 1).
//
// The epilogue is K2's, in K2's order: y = acc * alpha[n] + beta[n], with
// B8's residual (the RES instances) y = y + (r + r_off) * r_scale, ReLU if
// asked, then f32 out, or q = clip(rint(y * inv + zps), -128, 127) -> s8,
// every operation rounded alone (__fmul_rn, __fadd_rn, -fmad=false), so it
// equals int8_conv_direct_plain to the bit. The residual is read at the
// output's own offset, four channels a load; a thread's four rows of a
// 32-channel pass are loaded together once the pass's accumulators are
// staged, so their latencies overlap (loading each at its row's turn cost
// 9% at ResNet-18's layer1 on an H100, PERF.md). RES is a template flag, not
// a runtime branch, so the other instances carry none of its loads or
// registers. So is CLIP, the RangeBN observer clamp of a clamped conv: its
// instances read per-channel bounds clip_lo / clip_hi and clamp y to them
// before ReLU (f32 out: the bounds read for each row, 16 bytes a load), or
// the rounded value to them in place of [-128, 127] (s8 out:
// integer-valued bounds in [-128, 127] that the wrapper forms as
// int8_conv_xla forms them, so a channel whose hi < lo takes hi, and whose
// lo holds the ReLU floor, so ReLU is skipped; a channel's two bounds in one
// register, once a pass). The clamp costs the epilogue of a small-K tile
// 10-23% (PERF.md, on an H100): four floats a bound spilled the
// 128-channel instances (1.36-1.39x the unclamped instance at ResNet-50's
// 1x1 64->256), and byte-packed bounds clamped by __vmaxs4 / __vmins4
// (1.30-1.43x) or s16x2 values clamped by max/min.s16x2 (1.26x) cost more
// than this form (1.15-1.23x there, 1.10x at the 3x3 s1 64).
// Each consumer warp runs the epilogue of its own 16 accumulator rows, with
// no barrier beyond the warp: the int32 accumulators go through the warp's
// shared-memory rows, 32 channels at a time; the epilogue then runs on four
// channels of a row a thread, consecutive threads on consecutive channels,
// so a warp's stores cover whole 128-byte (f32) or 32-byte (s8) pieces of
// rows, and its code is one short loop rather than an unrolled pass over
// the accumulator registers for every output type. A tile's epilogue does not overlap its
// own loads or products, so one block an SM leaves the SM idle during it;
// the small staging area and __launch_bounds__(.., 2) let two blocks share
// an SM (their plan keeps the ring within half the shared memory), and one
// block's epilogue runs beside the other's mainloop.
#pragma once

#include <atomic>
#include <mutex>

#include "int8_mma.cuh"
#include "sm90.cuh"

namespace qtconv {
// Internal linkage: int8_conv.cu and int8_conv_flat.cu each build their own
// instances, and a function-local static of a shared template instance (the
// once-per-instance shared-memory opt-in below) would otherwise be one
// process-wide object that only the first library's kernel copy ever set.
namespace {

constexpr int TILE_M = 128;               // output pixels per tile: two warpgroups of 64 rows
constexpr int CONSUMERS = 256;            // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 32;   // and one producer warp
constexpr int MAX_STAGES = 8;

__host__ __device__ constexpr int stage_bytes(int kc, int bn) { return (TILE_M + bn) * kc; }
constexpr int PASS = 32;                          // channels of a tile staged at a time
constexpr int OUT_PITCH = PASS * 4 + 16;          // bytes of a staged row (int32), 16 of them padding

// the output pixel of a tile row (-1: not stored) and, for a K2 row whose
// window leaves the image, the offsets of its inside taps' corners in the
// border sums (else -1)
struct RowInfo {
  long long pix;
  int o00, o01, o10, o11;
};

// 1024 bytes to align the ring (the 128-byte swizzle repeats every 1024), the
// ring, a full and an empty mbarrier per slot, then each consumer warp's 16
// staged rows of 32 channels and its row table
__host__ __device__ constexpr int smem_bytes(int kc, int bn, int stages) {
  return 1024 + stages * stage_bytes(kc, bn) + 16 * stages +
         CONSUMERS / 32 * 16 * (OUT_PITCH + static_cast<int>(sizeof(RowInfo)));
}

struct ConvGeom {
  int N, H, W, Cin, Cout, KH, KW, SH, SW, PH, PW, Ho, Wo;  // flat rows: H, W = Hp, Wp; stride 1, no padding
  int flat;                // A as flat rows (B7; K2's 1x1 stride-1 convs), else as 4-D boxes (K2)
  int two, tho, nb;        // K2's boxes: the output box of a tile; flat rows: 128, 1, 1
  int chunks;              // ring stages per tap: ceil(Cin / KC)
  int m_tiles, n_tiles;
  int w_tiles, h_tiles;    // K2: m tile -> (image group, row band, column band), columns fastest
};

struct ConvEpi {
  const float* alpha;
  const float* beta;
  const int* border_sums;  // K2: ((KH + 1) * (KW + 1), Cout) int32, or null where no tap can fall outside
  void* out;
  int stored_zp, relu, out_int8;
  float inv, zps;
  const int8_t* residual;  // B8 (RES): s8 of the output's shape, else null
  float r_off, r_scale;    // B8: f32(128 - r_zp), f32(r_scale)
  const float* clip_lo;    // CLIP: (Cout,) bounds of y (f32 out) or of the rounded value (s8 out), else null
  const float* clip_hi;
};

// mbarrier wait that turns a lost TMA into a kernel error instead of a hang
__device__ __forceinline__ void wait_or_trap(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 36)) __trap();  // tens of seconds: no TMA takes that long
  }
}

// A 4-D box tile: its first image, output row and column (columns fastest)
__device__ __forceinline__ void box_origin(const ConvGeom& g, int mt, int& n0, int& ho0, int& wo0) {
  const int wi = mt % g.w_tiles, rest = mt / g.w_tiles;
  n0 = (rest / g.h_tiles) * g.nb;
  ho0 = (rest % g.h_tiles) * g.tho;
  wo0 = wi * g.two;
}

// Where a tile's A tile of tap (kh, kw) starts: a 4-D box at the input pixel
// of tap (0, 0) of its first output pixel (K2), or flat row m0 of the
// (N * Hp * Wp, Cin) rows, tap (dh, dw) reading row m0 + dh * Wp + dw
struct Corner {
  int n0, h0, w0, m0;
};

__device__ __forceinline__ Corner tile_corner(const ConvGeom& g, int mt) {
  if (g.flat) return {0, 0, 0, mt * TILE_M};
  int n0, ho0, wo0;
  box_origin(g, mt, n0, ho0, wo0);
  return {n0, ho0 * g.SH - g.PH, wo0 * g.SW - g.PW, 0};
}

__device__ __forceinline__ void load_a(const ConvGeom& g, const CUtensorMap* ta, uint32_t dst, uint32_t bar,
                                       const Corner& k, int kh, int kw, int c0) {
  if (g.flat)
    qt90::tma_load(dst, ta, bar, c0, k.m0 + kh * g.W + kw);
  else
    qt90::tma_load_4d(dst, ta, bar, c0, k.w0 + kw, k.h0 + kh, k.n0);
}

// The output pixel of tile row r: its element offset / Cout in out (-1 for a
// row that is not stored) and, for a box, the window's top-left input pixel.
__device__ __forceinline__ long long row_pixel(const ConvGeom& g, int mt, int r, int& hi0, int& wi0) {
  hi0 = wi0 = 0;
  if (g.flat) {
    const long long L = static_cast<long long>(g.H) * g.W;
    const long long m = static_cast<long long>(mt) * TILE_M + r;
    const long long img = m / L;
    const int rr = static_cast<int>(m - img * L), h = rr / g.W, w = rr - h * g.W;
    if (img >= g.N || h >= g.Ho || w >= g.Wo) return -1;
    return (img * g.Ho + h) * g.Wo + w;
  }
  int n0, ho0, wo0;
  box_origin(g, mt, n0, ho0, wo0);
  if (r >= g.two * g.tho * g.nb) return -1;
  const int w = wo0 + r % g.two, h = ho0 + (r / g.two) % g.tho, n = n0 + r / (g.two * g.tho);
  if (n >= g.N || h >= g.Ho || w >= g.Wo) return -1;
  hi0 = h * g.SH - g.PH;
  wi0 = w * g.SW - g.PW;
  return (static_cast<long long>(n) * g.Ho + h) * g.Wo + w;
}

// CLIP, f32 out: the bounds of this thread's four channels (the last one
// repeated past Cout), by loads kept where they are written (volatile: not
// hoisted out of the row loop, where they would hold eight registers across
// its iterations)
__device__ __forceinline__ void load_bounds(const ConvEpi& ep, int cout, int n, bool cvec, float (&lo)[4],
                                            float (&hi)[4]) {
  if (cvec && n + 3 < cout) {
    asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(lo[0]), "=f"(lo[1]), "=f"(lo[2]), "=f"(lo[3]) : "l"(ep.clip_lo + n));
    asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(hi[0]), "=f"(hi[1]), "=f"(hi[2]), "=f"(hi[3]) : "l"(ep.clip_hi + n));
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float* plo = ep.clip_lo + min(n + e, cout - 1);
    const float* phi = ep.clip_hi + min(n + e, cout - 1);
    asm volatile("ld.global.nc.f32 %0, [%1];\n" : "=f"(lo[e]) : "l"(plo));
    asm volatile("ld.global.nc.f32 %0, [%1];\n" : "=f"(hi[e]) : "l"(phi));
  }
}

// this thread's four residual bytes of a row (0 past Cout), packed little-endian
__device__ __forceinline__ uint32_t residual_word(const ConvEpi& ep, int cout, long long pix, int n, bool vec) {
  if (pix < 0 || n >= cout) return 0u;
  const int8_t* r = ep.residual + pix * cout + n;
  if (vec) return __ldg(reinterpret_cast<const unsigned int*>(r));
  uint32_t v = 0u;
  for (int e = 0; e < 4 && n + e < cout; ++e) v |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(r + e))) << (8 * e);
  return v;
}

template <int KC, int BN, bool RES, bool CLIP, bool EXP>
__global__ void __launch_bounds__(THREADS, 2)
    conv_sm90_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tw, ConvGeom g,
                     ConvEpi ep, int stages) {
  constexpr int ATILE = TILE_M * KC, STAGE = stage_bytes(KC, BN), R = BN / 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = qt90::smem_u32(smem_raw);
  const uint32_t sbase = (raw + 1023u) & ~1023u;
  const uint32_t full = sbase + stages * STAGE, empty = full + 8 * stages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ksteps = g.KH * g.KW * g.chunks, tiles = g.m_tiles * g.n_tiles;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      qt90::mbar_init(full + 8 * s, 1);
      qt90::mbar_init(empty + 8 * s, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {  // the producer warp: one thread issues every load
    if (lane == 0) {
      const uint32_t bytes = KC * ((g.flat ? TILE_M : g.two * g.tho * g.nb) + BN);
      int slot = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int mt = t / g.n_tiles, n0 = (t - mt * g.n_tiles) * BN;
        const Corner corner = tile_corner(g, mt);
        int kh = 0, kw = 0, c0 = 0, tap0 = 0;  // the stage's tap, its channel offset, the tap's first K column
        for (int ks = 0; ks < ksteps; ++ks) {
          wait_or_trap(empty + 8 * slot, phase ^ 1);  // a fresh slot passes at once
          const uint32_t a = sbase + slot * STAGE, bar = full + 8 * slot;
          qt90::mbar_expect_tx(bar, bytes);
          load_a(g, &ta, a, bar, corner, kh, kw, c0);
          qt90::tma_load(a + ATILE, &tw, bar, tap0 + c0, n0);
          if (++slot == stages) {
            slot = 0;
            phase ^= 1;
          }
          if ((c0 += KC) >= g.Cin) {
            c0 = 0;
            tap0 += g.Cin;
            if (++kw == g.KW) {
              kw = 0;
              ++kh;
            }
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg multiplies tile rows 64 * wg.. by the BN weight rows
  // warp w of warpgroup wg holds tile rows 64 wg + 16 (w % 4).. (wgmma's
  // accumulator layout), and runs the epilogue of those 16 rows on its own
  const int wg = warp >> 2, gq = lane >> 2, tq = lane & 3, row0 = 64 * wg + 16 * (warp & 3);
  uint8_t* stage_out = smem_raw + (sbase - raw) + stages * STAGE + 16 * stages + warp * 16 * OUT_PITCH;
  RowInfo* rows = reinterpret_cast<RowInfo*>(smem_raw + (sbase - raw) + stages * STAGE + 16 * stages +
                                             CONSUMERS / 32 * 16 * OUT_PITCH) + warp * 16;
  const int S = (g.KH + 1) * (g.KW + 1);  // border_sums: the summed-area table of the tap sums
  int slot = 0, last = 0;
  uint32_t phase = 0;
  int acc[R];
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int mt = t / g.n_tiles, n0 = (t - mt * g.n_tiles) * BN;
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0;
    for (int ks = 0; ks < ksteps; ++ks) {
      wait_or_trap(full + 8 * slot, phase);
      const uint32_t a = sbase + slot * STAGE + wg * 64 * KC, w = sbase + slot * STAGE + ATILE;
      qt90::wgmma_fence();
      qt90::fence_acc(acc);
#pragma unroll
      for (int kk = 0; kk < KC / 32; ++kk)
        qt90::Wgmma<BN>::ss(acc, qt90::sw_desc(a, KC) + 2 * kk, qt90::sw_desc(w, KC) + 2 * kk);
      qt90::wgmma_commit();
      qt90::wgmma_wait<1>();  // the previous stage has retired: its slot is free
      qt90::fence_acc(acc);
      if (ks > 0 && lane == 0) qt90::mbar_arrive(empty + 8 * last);
      last = slot;
      if (++slot == stages) {
        slot = 0;
        phase ^= 1;
      }
    }
    qt90::wgmma_wait<0>();
    qt90::fence_acc(acc);
    if (lane == 0) qt90::mbar_arrive(empty + 8 * last);

    // 1. each of the warp's 16 rows: its output pixel and, for K2 with
    //    border sums, the corners of its inside taps in the summed-area table
    if (lane < 16) {
      int hi0, wi0;
      RowInfo ri;
      ri.pix = row_pixel(g, mt, row0 + lane, hi0, wi0);
      ri.o00 = ri.o01 = ri.o10 = ri.o11 = -1;
      if (!g.flat && ep.border_sums != nullptr && ri.pix >= 0 &&
          (hi0 < 0 || hi0 + g.KH > g.H || wi0 < 0 || wi0 + g.KW > g.W)) {
        const int i0 = max(0, -hi0), i1 = max(i0, min(g.KH, g.H - hi0));
        const int j0 = max(0, -wi0), j1 = max(j0, min(g.KW, g.W - wi0));
        ri.o00 = (i0 * (g.KW + 1) + j0) * g.Cout;
        ri.o01 = (i0 * (g.KW + 1) + j1) * g.Cout;
        ri.o10 = (i1 * (g.KW + 1) + j0) * g.Cout;
        ri.o11 = (i1 * (g.KW + 1) + j1) * g.Cout;
      }
      rows[lane] = ri;
    }
    __syncwarp();

    // 2-3. per pass of 32 channels: the accumulators into the warp's staging
    //    rows, as int32 (accumulator v = 4j + 2h + e holds tile row row0 +
    //    gq + 8h, channel n0 + 8j + 2tq + e), then
    //    the epilogue on four channels of a row a thread, consecutive threads
    //    on consecutive channels of a row, out to the output where the
    //    channel count keeps the pieces aligned, else element by element
    const bool vec = (g.Cout & 3) == 0;
    const bool rvec = vec && (reinterpret_cast<uintptr_t>(ep.residual) & 3) == 0;  // RES: 4-byte residual loads
    const bool cvec = vec && (reinterpret_cast<uintptr_t>(ep.clip_lo) & 15) == 0 &&  // CLIP: 16-byte bound loads
                      (reinterpret_cast<uintptr_t>(ep.clip_hi) & 15) == 0;
    constexpr int GROUPS = PASS / 4, ROWS = 16 * GROUPS / 32;  // four-channel groups a row; rows a thread
#pragma unroll
    for (int pass = 0; pass < BN / PASS; ++pass) {
      // this thread's four channels, the same in each of its rows; their
      // constants are loaded first, so the loads overlap the staging below
      const int n = n0 + pass * PASS + (lane % GROUPS) * 4;
      float al[4], be[4];
      if (vec && n < g.Cout) {
        const float4 al4 = __ldg(reinterpret_cast<const float4*>(ep.alpha + n));
        const float4 be4 = __ldg(reinterpret_cast<const float4*>(ep.beta + n));
        al[0] = al4.x, al[1] = al4.y, al[2] = al4.z, al[3] = al4.w;
        be[0] = be4.x, be[1] = be4.y, be[2] = be4.z, be[3] = be4.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          al[e] = __ldg(ep.alpha + min(n + e, g.Cout - 1));
          be[e] = __ldg(ep.beta + min(n + e, g.Cout - 1));
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint8_t* srow = stage_out + (gq + 8 * h) * OUT_PITCH;
#pragma unroll
        for (int jj = 0; jj < PASS / 8; ++jj) {
          const int j = pass * (PASS / 8) + jj;
          *reinterpret_cast<int2*>(srow + 4 * (8 * jj + 2 * tq)) = make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
      __syncwarp();
      // CLIP, s8 out: each of the four channels' integer bounds in one
      // register, lo in the low half and hi in the high half, once a pass
      // (four floats a bound spilled the 128-channel instances under the
      // two-blocks-an-SM register cap)
      int cb[4] = {0, 0, 0, 0};
      if constexpr (CLIP) {
        if (ep.out_int8) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = min(n + e, g.Cout - 1);
            const uint32_t lo = static_cast<uint32_t>(__float2int_rn(__ldg(ep.clip_lo + c)));
            const uint32_t hi = static_cast<uint32_t>(__float2int_rn(__ldg(ep.clip_hi + c)));
            cb[e] = static_cast<int>((hi << 16) | (lo & 0xffffu));
          }
        }
      }
      // B8: the residual of all four of this thread's rows, in flight together
      uint32_t r0 = 0u, r1 = 0u, r2 = 0u, r3 = 0u;
      if constexpr (RES) {
        static_assert(ROWS == 4, "four rows a thread");
        r0 = residual_word(ep, g.Cout, rows[lane / GROUPS].pix, n, rvec);
        r1 = residual_word(ep, g.Cout, rows[lane / GROUPS + 4].pix, n, rvec);
        r2 = residual_word(ep, g.Cout, rows[lane / GROUPS + 8].pix, n, rvec);
        r3 = residual_word(ep, g.Cout, rows[lane / GROUPS + 12].pix, n, rvec);
      }
      // one row at a time: the accumulators of the later passes are still
      // live, and holding several rows here made ptxas spill at 128
      // channels under the two-blocks-an-SM register cap
#pragma unroll 1
      for (int it = 0; it < ROWS; ++it) {
        const int r = lane / GROUPS + it * (32 / GROUPS);
        const RowInfo ri = rows[r];
        uint32_t res_row = 0u;  // B8: this row's residual
        if constexpr (RES) {
          res_row = r0;
          r0 = r1;
          r1 = r2;
          r2 = r3;
        }
        if (ri.pix < 0 || n >= g.Cout) continue;
        const int4 a4 = *reinterpret_cast<const int4*>(stage_out + r * OUT_PITCH + 4 * (n - n0 - pass * PASS));
        int a[4] = {a4.x, a4.y, a4.z, a4.w};
        float y[4];
        float cl[4], ch[4];  // CLIP, f32 out: the bounds of y, read for each row (no registers across the rows)
        if constexpr (CLIP) {
          if (!ep.out_int8) load_bounds(ep, g.Cout, n, cvec, cl, ch);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (ri.o00 >= 0) {  // the zero-filled taps held stored_zp in K2's function
            const int* sat = ep.border_sums + min(n + e, g.Cout - 1);  // past Cout: computed, not stored
            a[e] += ep.stored_zp * (__ldg(sat + (S - 1) * g.Cout) - __ldg(sat + ri.o11) +
                                    __ldg(sat + ri.o01) + __ldg(sat + ri.o10) - __ldg(sat + ri.o00));
          }
          y[e] = __fadd_rn(__fmul_rn(static_cast<float>(a[e]), al[e]), be[e]);
          if constexpr (RES) {
            const float rv = static_cast<float>(static_cast<int8_t>(res_row >> (8 * e)));
            y[e] = __fadd_rn(y[e], __fmul_rn(__fadd_rn(rv, ep.r_off), ep.r_scale));
          }
          if constexpr (CLIP) {
            if (!ep.out_int8) y[e] = fminf(fmaxf(y[e], cl[e]), ch[e]);
          }
          // with s8 out a CLIP instance's lo holds the ReLU floor (zps <= lo), so ReLU changes nothing there
          if constexpr (EXP)
            y[e] = qt::activate_exp(y[e], ep.relu);  // SiLU or the sigmoid
          else if (ep.relu && !(CLIP && ep.out_int8))
            y[e] = fmaxf(y[e], 0.0f);
        }
        const long long o = ri.pix * g.Cout + n;
        if (ep.out_int8) {
          int8_t q[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // rint, then the clip to [-128, 127]: round half to even to int32, then clamp
            const int v = __float2int_rn(__fadd_rn(__fmul_rn(y[e], ep.inv), ep.zps));
            if constexpr (CLIP)  // the channel's bounds in place of [-128, 127]
              q[e] = static_cast<int8_t>(min(max(v, static_cast<int>(static_cast<int16_t>(cb[e]))), cb[e] >> 16));
            else
              q[e] = static_cast<int8_t>(min(max(v, -128), 127));
          }
          int8_t* out = static_cast<int8_t*>(ep.out) + o;
          if (vec) {
            *reinterpret_cast<char4*>(out) = make_char4(q[0], q[1], q[2], q[3]);
          } else {
            for (int e = 0; e < 4 && n + e < g.Cout; ++e) out[e] = q[e];
          }
        } else {
          float* out = static_cast<float*>(ep.out) + o;
          if (vec) {
            *reinterpret_cast<float4*>(out) = make_float4(y[0], y[1], y[2], y[3]);
          } else {
            for (int e = 0; e < 4 && n + e < g.Cout; ++e) out[e] = y[e];
          }
        }
      }
      __syncwarp();  // the staging rows (and, after the last pass, the row table) are free again
    }
  }
}

// ---- host side

// A tiled int8 tensor map, kept: encoding takes host time, and the
// activations come back to the same few pointers from PyTorch's caching
// allocator (the weights' pointers and shapes are fixed per layer). The key
// is everything the map encodes.
struct MapKey {
  const void* p;
  int rank, swizzle;
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4], estr[4];
  bool operator==(const MapKey& o) const {
    if (p != o.p || rank != o.rank || swizzle != o.swizzle) return false;
    for (int i = 0; i < rank; ++i)
      if (dims[i] != o.dims[i] || box[i] != o.box[i] || estr[i] != o.estr[i] ||
          (i + 1 < rank && strides[i] != o.strides[i]))
        return false;
    return true;
  }
};

inline bool conv_map(CUtensorMap* map, const MapKey& key) {
  constexpr int SLOTS = 512;
  static std::mutex mu;
  static MapKey keys[SLOTS];
  static CUtensorMap maps[SLOTS];
  static int used = 0, next = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i)
    if (keys[i] == key) {
      *map = maps[i];
      return true;
    }
  const qt90::EncodeTiled encode = qt90::encode_tiled();
  if (encode == nullptr) return false;
  const CUtensorMapSwizzle swz = key.swizzle == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : key.swizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                 : key.swizzle == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                                                     : CU_TENSOR_MAP_SWIZZLE_NONE;  // 0: dense boxes
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, key.rank, const_cast<void*>(key.p), key.dims, key.strides,
             key.box, key.estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  keys[next] = key;
  maps[next] = *map;
  next = (next + 1) % SLOTS;
  used = used < SLOTS ? used + 1 : SLOTS;
  return true;
}

// The map of a (rows, cols) row-major int8 matrix in boxes of (box_rows, kc bytes)
inline bool matrix_map(CUtensorMap* map, const void* p, long long rows, int cols, int box_rows, int kc) {
  MapKey k = {};
  k.p = p;
  k.rank = 2;
  k.swizzle = kc;
  k.dims[0] = static_cast<cuuint64_t>(cols);
  k.dims[1] = static_cast<cuuint64_t>(rows);
  k.strides[0] = static_cast<cuuint64_t>(cols);
  k.box[0] = static_cast<cuuint32_t>(kc);
  k.box[1] = static_cast<cuuint32_t>(box_rows);
  k.estr[0] = k.estr[1] = 1;
  return conv_map(map, k);
}

// The launch plan of ops.conv_plan: K bytes a stage, channels a tile, the
// output box (K2), ring slots, persistent blocks, dynamic shared memory.
struct ConvPlan {
  int kc, bn, two, tho, nb, stages, blocks, smem;
};

template <int KC, int BN, bool RES, bool CLIP, bool EXP>
int launch_instance(const CUtensorMap& ta, const CUtensorMap& tw, const ConvGeom& g, const ConvEpi& ep,
                    const ConvPlan& p, cudaStream_t stream) {
  auto kernel = conv_sm90_kernel<KC, BN, RES, CLIP, EXP>;
  static std::atomic<bool> opted_in{false};  // the full shared memory, asked for once per instance
  cudaError_t err;
  if (!opted_in.load()) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, qt::SMEM_LIMIT);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in.store(true);
  }
  kernel<<<p.blocks, THREADS, p.smem, stream>>>(ta, tw, g, ep, p.stages);
  return static_cast<int>(cudaGetLastError());
}

template <bool RES, bool CLIP, bool EXP>
int launch_kc_bn(const CUtensorMap& ta, const CUtensorMap& tw, const ConvGeom& g, const ConvEpi& ep,
                 const ConvPlan& p, cudaStream_t s) {
#define QT_CONV_BN(KC)                                                              \
  switch (p.bn) {                                                                   \
    case 32: return launch_instance<KC, 32, RES, CLIP, EXP>(ta, tw, g, ep, p, s);   \
    case 64: return launch_instance<KC, 64, RES, CLIP, EXP>(ta, tw, g, ep, p, s);   \
    default: return launch_instance<KC, 128, RES, CLIP, EXP>(ta, tw, g, ep, p, s);  \
  }
  switch (p.kc) {
    case 32: QT_CONV_BN(32)
    case 64: QT_CONV_BN(64)
    default: QT_CONV_BN(128)
  }
#undef QT_CONV_BN
  return static_cast<int>(cudaErrorInvalidValue);
}

// The conv on the mainloop: g.flat = 1 reads x as flat rows (N * H * W, Cin)
// (B7: the zero-point-padded image, H, W = Hp, Wp; K2: a 1x1 stride-1 conv
// without padding, whose rows are its output pixels), else as 4-D boxes of
// the NHWC input (K2). Both bases 16-byte aligned, Cin % 16 == 0; 0 or the
// CUDA error. Refuses a plan that does not fit the shape. RES: B8, with
// ep.residual, on its own kernel instances; CLIP: the clamp, with
// ep.clip_lo / clip_hi, on its own (not with RES: no engine needs both);
// EXP: SiLU or the sigmoid (ep.relu >= qt::ACT_SILU), on its own (with
// neither).
template <bool RES = false, bool CLIP = false, bool EXP = false>
int launch_conv(const void* x, const void* w, ConvGeom g, const ConvEpi& ep, const ConvPlan& p, void* stream) {
  static_assert(!(RES && CLIP), "the residual and the clamp have no instances together");
  static_assert(!(EXP && (RES || CLIP)), "SiLU and the sigmoid have instances of their own");
  const bool ok = (p.kc == 32 || p.kc == 64 || p.kc == 128) && (p.bn == 32 || p.bn == 64 || p.bn == 128) &&
                  g.Cin % 16 == 0 && (p.kc == 32 || g.Cin % p.kc == 0 || (g.KH * g.KW == 1 && g.Cin < p.kc)) &&
                  p.stages >= 2 && p.stages <= MAX_STAGES && p.blocks >= 1 &&
                  p.smem == smem_bytes(p.kc, p.bn, p.stages) && p.smem <= qt::SMEM_LIMIT && g.N >= 1 &&
                  g.Cout >= 1 && g.Ho >= 1 && g.Wo >= 1 && qt::aligned16(x) && qt::aligned16(w) &&
                  (g.flat ? p.two == TILE_M && p.tho == 1 && p.nb == 1 && g.SH == 1 && g.SW == 1 && g.PH == 0 &&
                                g.PW == 0
                          : g.SH >= 1 && g.SH <= 8 && g.SW >= 1 && g.SW <= 8 && p.two >= 1 && p.tho >= 1 &&
                                p.nb >= 1 && p.two * p.tho * p.nb <= TILE_M && p.two * g.SW <= 256 &&
                                p.tho * g.SH <= 256 && p.nb <= 256 &&
                                (ep.border_sums != nullptr || ep.stored_zp == 0 || (g.PH == 0 && g.PW == 0))) &&
                  (ep.residual != nullptr) == RES && (ep.clip_lo != nullptr) == CLIP &&
                  (ep.clip_hi != nullptr) == CLIP && (ep.relu >= qt::ACT_SILU) == EXP;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  g.two = p.two;
  g.tho = p.tho;
  g.nb = p.nb;
  g.chunks = (g.Cin + p.kc - 1) / p.kc;
  g.n_tiles = (g.Cout + p.bn - 1) / p.bn;
  MapKey k = {};
  k.p = x;
  k.swizzle = p.kc;
  k.box[0] = p.kc;
  k.estr[0] = k.estr[1] = k.estr[2] = k.estr[3] = 1;
  if (g.flat) {
    const long long rows = static_cast<long long>(g.N - 1) * g.H * g.W + static_cast<long long>(g.Ho) * g.W;
    g.w_tiles = g.h_tiles = 1;
    g.m_tiles = static_cast<int>((rows + TILE_M - 1) / TILE_M);
    k.rank = 2;
    k.dims[0] = k.strides[0] = static_cast<cuuint64_t>(g.Cin);
    k.dims[1] = static_cast<cuuint64_t>(g.N) * g.H * g.W;
    k.box[1] = TILE_M;
  } else {
    g.w_tiles = (g.Wo + p.two - 1) / p.two;
    g.h_tiles = (g.Ho + p.tho - 1) / p.tho;
    g.m_tiles = g.w_tiles * g.h_tiles * ((g.N + p.nb - 1) / p.nb);
    k.rank = 4;
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(g.Cin), static_cast<cuuint64_t>(g.W),
                                static_cast<cuuint64_t>(g.H), static_cast<cuuint64_t>(g.N)};
    for (int i = 0; i < 4; ++i) k.dims[i] = dims[i];
    k.strides[0] = dims[0];
    k.strides[1] = dims[0] * dims[1];
    k.strides[2] = dims[0] * dims[1] * dims[2];
    k.box[1] = p.two * g.SW;  // the stride as the traversal stride: every SW-th of two * SW columns
    k.box[2] = p.tho * g.SH;
    k.box[3] = p.nb;
    k.estr[1] = g.SW;
    k.estr[2] = g.SH;
  }
  CUtensorMap ta, tw;
  if (!conv_map(&ta, k) || !matrix_map(&tw, w, g.Cout, g.KH * g.KW * g.Cin, p.bn, p.kc))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_kc_bn<RES, CLIP, EXP>(ta, tw, g, ep, p, static_cast<cudaStream_t>(stream));
}

}  // namespace
}  // namespace qtconv
