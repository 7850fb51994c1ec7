// The Hopper route of B5 (fused_dw_pw.cu): a MobileNet-v1 depthwise-separable
// pair on clusters that split the channels, wgmma for the pointwise conv.
//
//   h1  = clip(rint(acc1*a1 + b1), lo1, 127)   depthwise 3x3/S over x, taps
//                                               outside the image read zp1
//   out = clip(rint(acc2*a2 + b2), lo2, 127)   pointwise 1x1 over h1 -> s8
//
// What held the tile kernel back (fused_dw_pw.cu's own kernel): one block
// walked all of Cout in 64x64 mma.sync steps, each staging its weights
// between two barriers, with nothing overlapped and single-byte stores. The
// wide pairs (C 256-512, Cout 512-1024 at 28x28-7x7) took 60-130x their
// bound, the narrow ones (C 32-128 at 112x112 and 56x56) 8-12x.
//
// Design:
// - A cluster of q blocks owns a tile of 128 output pixels at most: tho
//   whole output rows of one image, or nb whole images where an image is
//   small (7x7: two a tile). Block `rank` computes depthwise channels [rank
//   * C/q, (rank + 1) * C/q) of h1 and pointwise channels [rank * Cout/q,
//   (rank + 1) * Cout/q) of the output, as block_sm90.cuh splits B3 and B4.
//   Clusters are persistent: each walks the tiles with a stride of the
//   clusters resident at once (ops.dw_pw_plan).
// - The pair computes at C and Cout rounded up to multiples of 16 (g.C,
//   g.Cout); x, the weights, the constants and the output keep their true
//   widths (g.Cx, g.Co, multiples of 8). The added channels get zero
//   depthwise weights and constants and zero pointwise weight rows and
//   columns, read as 0 past the true widths, so whatever the window holds
//   there a new h1 channel is clip(rint(0), lo1, 127) and meets only zeros,
//   and a new output channel is never stored. Width 0.75's and 0.25's first
//   pair (C 24 and 8) take the route this way without a copy of x (padding
//   x in the wrapper cost 34-42% of the call, PERF.md).
// - The input window of a tile, nb x ((tho - 1) * S + 3) rows x (W + 2)
//   pixels x the block's C/q channels, arrives by one 4-D TMA box at (channel
//   rank * C/q, column -1, row ho0 * S - 1, image n0), double-buffered: the
//   next tile's window is in flight while this one is computed. TMA fills
//   the halo outside the image with zeros; the block overwrites it with zp1
//   (border columns and rows only) before the depthwise pass, so padding is
//   exact as in the plain version. Where Cx % 16 != 0 (then q = 1) the pixel
//   stride (Cx bytes) is one a tensor map cannot take, but an image row (W
//   Cx bytes, a multiple of 16) is one bulk copy: thread 0 sends each
//   in-image row of the window by a 1-D TMA bulk copy onto the same
//   mbarrier, into a row slot where pixels keep their Cx bytes (the left
//   halo pixel ends at byte C, where the row's first pixel starts, 16-byte
//   aligned), and a word of the added channels reads the next pixel's
//   bytes, which meet zero weights. The pointwise weights are then loaded once by the block's
//   threads into their swizzled layout. (A first form staged the pixels by
//   8-byte cp.async copies from every thread, some 1,000 a tile with their
//   index arithmetic: 0.080 ms for width 0.75's pair 0 at batch 32, against
//   0.062 for this one and the tile kernel's 0.151, on an H100 80GB HBM3.)
// - The depthwise pass runs on the CUDA cores in int32, a thread taking 4
//   channels (one word a tap) of up to 16 output pixels; each product is one
//   dp4a against a weight word that holds the channel's weight in the
//   channel's byte and zeros elsewhere (built once a block, held in
//   registers for the tile), so a multiply-add costs one instruction, not a
//   byte extraction each side and a multiply. Four lanes gather a pixel's
//   16 bytes by shuffles and write the block's h1 slice into its own h1 and
//   every peer's (distributed shared memory, 16-byte st.shared::cluster:
//   after four shuffles each lane of a quad stores whole 16-byte pieces of
//   its own rows), in wgmma's K-major layout under the
//   swizzle of KB = 32, 64 or 128 bytes a row. A cluster barrier then
//   gives every block all of h1; a second one, split around the next
//   tile's halo (arrive after the pointwise product, wait before the
//   depthwise pass writes), keeps a peer from overwriting h1 that a block
//   still reads.
//   An unclustered block (q = 1) needs neither: its own barriers order it.
// - The pointwise weights of the block's Cout/q channels stay resident (one
//   TMA load per K block at the start, 128-byte swizzle where C >= 128), so
//   the pointwise conv is one run of C/32 wgmma steps a tile, both operands
//   from shared memory.
// - The epilogue requantizes into a staging tile of Cout/q bytes a pixel
//   (its rows 16 bytes apart beyond that, so the fragments' 2-byte stores
//   of eight rows fall in distinct banks), then every thread copies
//   16-byte pieces of whole rows out to the output (pixels past the image
//   or the batch are not written).
// Every rounding is the plain version's: __fmul_rn/__fadd_rn under
// -fmad=false, and rint and the clip by adding 1.5 * 2^23 to the clipped
// value (sm90.cuh clip_round_byte), so each output equals
// fused_dw_pw_plain to the bit; the depthwise sums, at most 9 * 128 * 127,
// become floats the same way, without the conversion unit.
#pragma once

#include "block_sm90.cuh"

namespace qtdw {
// Internal linkage, as in conv_sm90.cuh.
namespace {

constexpr int TILE_M = 128;  // output pixels per tile: two warpgroups of 64 rows
constexpr int THREADS = 256;
constexpr int MAX_CS = 128;  // depthwise channels a block: at most 16 rows of one 4-channel word a thread
constexpr int MAX_UNITS = 16;  // TILE_M * MAX_CS / 4 / THREADS: rows of one word a thread

struct DwGeom {
  int N, H, W, C, Cout, S, Ho, Wo;  // C, Cout: the widths computed, multiples of 16
  int Cx, Co;     // the true widths of x, wdw, a1, b1 (Cx) and of wpw's rows, a2, b2, out (Co)
  int q, cs, no;  // cluster size; the block's depthwise and pointwise channels, C/q and Cout/q
  int tho, nb;    // a tile: tho rows of Wo pixels of one image, or nb whole images
  int WR, WP;     // the window: rows an image, pixels a row (W + 2)
  int RP;         // the window's bytes a row: WP C/q, or 2 C + (W + 1) Cx rounded up to 16 (its pixels Cx apart)
  int Kp, KB;     // the pointwise K (C rounded up to 32), the swizzle row bytes
  int h_tiles, tiles;
};

struct DwEpi {
  const float *a1, *b1, *a2, *b2;
  float lo1, lo2;
  int zp1;
};

__host__ __device__ constexpr int align128(int v) { return (v + 127) / 128 * 128; }

// Offsets in the dynamic shared memory (after aligning its base to 1024): h1
// and the weights (swizzled K blocks), two windows, the staging tile (rows
// of Cout/q + 16 bytes), the depthwise weight words (tap-major, one int32 a
// channel), the four constant vectors, two row tables (128 window offsets
// and 128 output pixels each), three mbarriers; `total` includes the 1024 bytes
// of alignment slack.
struct DwLayout {
  int h1, w, win, stage, wd, consts, rows, bars, total;
};

__host__ __device__ inline DwLayout dw_layout(const DwGeom& g) {
  const int nkb = (g.Kp + g.KB - 1) / g.KB;
  DwLayout l{};
  l.h1 = 0;
  l.w = TILE_M * g.KB * nkb;
  l.win = align128(l.w + g.no * g.KB * nkb);
  l.stage = l.win + 2 * align128(g.nb * g.WR * g.RP);
  l.wd = l.stage + align128(TILE_M * (g.no + 16));
  l.consts = l.wd + align128(9 * g.cs * 4);
  l.rows = l.consts + 8 * (g.cs + g.no);
  l.bars = l.rows + 4 * TILE_M * 4;
  l.total = l.bars + 3 * 8 + 1024;
  return l;
}

// clip(rint(accf*a + b), lo, 127) in the low byte, one float32 rounding per
// operation (accf: the accumulator, converted exactly)
__device__ __forceinline__ uint32_t requant_byte(float accf, float a, float b, float lo) {
  return qt90::clip_round_byte(__fadd_rn(__fmul_rn(accf, a), b), lo);
}

__device__ __forceinline__ void tile_origin(const DwGeom& g, int t, int& n0, int& ho0) {
  n0 = (t / g.h_tiles) * g.nb;
  ho0 = (t % g.h_tiles) * g.tho;
}

// blocks an SM the registers allow: three up to 64 pointwise channels a block, else two (ops.dw_pw_plan)
__host__ __device__ constexpr int blocks_per_sm(int bn) { return bn <= 64 ? 3 : 2; }

// NARROW: C % 16 != 0, x's rows by bulk copies (its own instances, so the
// tensor-map route keeps its window arithmetic)
template <int BN, int S, bool NARROW>
__global__ void __launch_bounds__(THREADS, blocks_per_sm(BN))
    dw_pw_sm90_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                      const int8_t* __restrict__ x, const int8_t* __restrict__ wdw,
                      const int8_t* __restrict__ wpw, int8_t* __restrict__ out, DwGeom g, DwEpi e) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = qt90::smem_u32(smem_raw);
  uint8_t* base = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const uint32_t sbase = qt90::smem_u32(base);
  const DwLayout l = dw_layout(g);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q = g.q, rank = blockIdx.x % q;  // clusters of (q, 1, 1) over a grid of q x clusters
  const int cid = blockIdx.x / q, clusters = gridDim.x / q;
  const int nkb = (g.Kp + g.KB - 1) / g.KB;
  const int wbytes = align128(g.nb * g.WR * g.RP);  // one window
  const uint32_t bar_w = sbase + l.bars, bar_win = bar_w + 8;  // the weights; window b at bar_win + 8b
  float* a1 = reinterpret_cast<float*>(base + l.consts);
  float* b1 = a1 + g.cs;
  float* a2 = b1 + g.cs;
  float* b2 = a2 + g.no;
  const int P = g.Wo * g.tho * g.nb;  // the tile's output pixels

  constexpr bool narrow = NARROW;
  auto load_window = [&](int t, int buf) {  // thread 0
    int n0, ho0;
    tile_origin(g, t, n0, ho0);
    const uint32_t win = sbase + l.win + buf * wbytes, bar = bar_win + 8 * buf;
    if (!narrow) {
      qt90::mbar_expect_tx(bar, g.nb * g.WR * g.RP);
      qt90::tma_load_4d(win, &tx, bar, rank * g.cs, -1, ho0 * S - 1, n0);
      return;
    }
    const int rowb = g.W * g.Cx;  // the halo rows and images past the batch are not loaded
    const int imgs = min(g.nb, g.N - n0), r0 = max(0, 1 - ho0 * S), r1 = min(g.WR, g.H + 1 - ho0 * S);
    qt90::mbar_expect_tx(bar, imgs * max(0, r1 - r0) * rowb);
    for (int img = 0; img < imgs; ++img)
      for (int r = r0; r < r1; ++r)
        qt90::bulk_load(win + (img * g.WR + r) * g.RP + g.cs,
                        x + (static_cast<long long>(n0 + img) * g.H + ho0 * S - 1 + r) * rowb, rowb, bar);
  };

  if (tid == 0) {
    for (int b = 0; b < 3; ++b) qt90::mbar_init(bar_w + 8 * b);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    if (!narrow) {
      qt90::mbar_expect_tx(bar_w, nkb * g.KB * BN);
      for (int b = 0; b < nkb; ++b) qt90::tma_load(sbase + l.w + b * BN * g.KB, &tw, bar_w, b * g.KB, rank * BN);
    }
    if (cid < g.tiles) load_window(cid, 0);
  }
  if (narrow) {  // the pointwise weights, zero past Cx and Co, into TMA's swizzled layout
    for (int i = tid; i < BN * g.Kp; i += THREADS) {
      const int n = i / g.Kp, k = i - n * g.Kp, row = rank * BN + n, blk = k / g.KB;
      base[l.w + blk * BN * g.KB + qt90::sw_offset(n, k - blk * g.KB, g.KB)] =
          row < g.Co && k < g.Cx ? static_cast<uint8_t>(wpw[static_cast<long long>(row) * g.Cx + k]) : 0;
    }
  }
  // the depthwise weights of the block's channels, tap-major, channel c's in
  // byte c % 4 of its word (dp4a's other three products are 0); the
  // constants; each 0 past the true widths
  for (int i = tid; i < 9 * g.cs; i += THREADS) {
    const int t = i / g.cs, c = i - t * g.cs, ch = rank * g.cs + c;
    const uint32_t v = ch < g.Cx ? static_cast<uint8_t>(wdw[ch * 9 + t]) : 0u;
    reinterpret_cast<uint32_t*>(base + l.wd)[i] = v << (8 * (c % 4));
  }
  for (int i = tid; i < g.cs; i += THREADS) {
    const int ch = rank * g.cs + i;
    a1[i] = ch < g.Cx ? e.a1[ch] : 0.0f;
    b1[i] = ch < g.Cx ? e.b1[ch] : 0.0f;
  }
  for (int i = tid; i < BN; i += THREADS) {
    const int ch = rank * BN + i;
    a2[i] = ch < g.Co ? e.a2[ch] : 0.0f;
    b2[i] = ch < g.Co ? e.b2[ch] : 0.0f;
  }
  if (q > 1) qtblock::cluster_arrive();  // h1 is free: the peers may write it once they have waited
  __syncthreads();

  // the depthwise pass's units: one 4-byte word (4 channels) of one output
  // pixel; word wrd of the block's C/q channels, rows rg, rg + groups, ...
  const int cw = g.cs / 4, wrd = tid % cw, rg = tid / cw, groups = THREADS / cw;
  const uint4 zp16 = qt::fill16(e.zp1);
  const int ucs = g.cs / 16;  // 16-byte pieces a pixel
  const int sp = BN + 16;  // the staging pitch
  const int wg = warp >> 2, gq = lane >> 2, tq = lane & 3;
  const int row0 = 64 * wg + 16 * (warp & 3) + gq;  // the thread's accumulator rows: row0, row0 + 8
  // the 16 h1 bytes that the thread's lane quad holds (4 consecutive words of one pixel)
  const int kh1 = rank * g.cs + 4 * (wrd & ~3), hblk = kh1 / g.KB, hc = kh1 - hblk * g.KB;
  const bool cl = q > 1;
  int i = 0;
  for (int t = cid; t < g.tiles; t += clusters, ++i) {
    const int buf = i & 1;
    // the row table, one per tile parity (the previous tile's copy-out may still read its own):
    // a tile row's window pixel (bytes), and its output pixel or -1
    int* dwoff = reinterpret_cast<int*>(base + l.rows) + buf * 2 * TILE_M;
    int* outpix = dwoff + TILE_M;
    if (tid == 0 && t + clusters < g.tiles) {
      qt90::fence_proxy_async();  // the halo writes to that buffer, two tiles ago, before TMA overwrites it
      load_window(t + clusters, buf ^ 1);
    }
    int n0, ho0;
    tile_origin(g, t, n0, ho0);
    if (tid < TILE_M) {  // the row table
      const int m = tid, img = m / (g.Wo * g.tho), rem = m - img * g.Wo * g.tho, ho = rem / g.Wo, wo = rem % g.Wo;
      const bool in_tile = m < P;
      const int rw = img * g.WR + ho * S;
      dwoff[m] = !in_tile ? 0 : narrow ? rw * g.RP + g.cs + (wo * S - 1) * g.Cx : (rw * g.WP + wo * S) * g.cs;
      outpix[m] = in_tile && n0 + img < g.N && ho0 + ho < g.Ho ? ((n0 + img) * g.Ho + ho0 + ho) * g.Wo + wo : -1;
    }
    qtconv::wait_or_trap(bar_win + 8 * buf, (i >> 1) & 1);

    // the halo: zp1 over the border columns and the rows outside the image
    uint8_t* win = base + l.win + buf * wbytes;
    for (int rr = warp; rr < g.nb * g.WR; rr += THREADS / 32) {
      const int img = rr / g.WR, hi = ho0 * S - 1 + rr - img * g.WR;
      if (n0 + img >= g.N) continue;  // an image past the batch: computed, never stored
      uint4* row = reinterpret_cast<uint4*>(win + rr * g.RP);
      if (hi < 0 || hi >= g.H) {
        for (int k = lane; k < g.RP / 16; k += 32) row[k] = zp16;
      } else if (lane < 2 * ucs) {  // the C/q bytes before the first pixel and from the right halo pixel on
        row[(lane < ucs ? 0 : (g.cs + g.W * (narrow ? g.Cx : g.cs)) / 16 - ucs) + lane] = zp16;
      }
    }
    __syncthreads();

    // the depthwise pass, 4 rows of the thread's word at a time, each group
    // into h1 as soon as it is done: once no peer reads h1 any more (the
    // cluster barrier's wait). Unclustered: each word where it belongs.
    // Clustered: a lane quad holds 4 consecutive words of each of its rows;
    // in four shuffles lane j of the quad collects the 16 bytes of row u0 +
    // j, and stores them here and into every peer (16-byte stores, all 32
    // lanes busy). Every thread runs the same iterations, for the shuffles.
    if (cl) qtblock::cluster_wait();
    {
      const uint8_t* wins = base + l.win + buf * wbytes + 4 * wrd;
      const uint32_t* wdp = reinterpret_cast<const uint32_t*>(base + l.wd) + 4 * wrd;
      uint32_t wk[9][4];  // the 4 channels' weight words of each tap
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const uint4 v = *reinterpret_cast<const uint4*>(wdp + tap * g.cs);
        wk[tap][0] = v.x, wk[tap][1] = v.y, wk[tap][2] = v.z, wk[tap][3] = v.w;
      }
      const float4 a4 = *reinterpret_cast<const float4*>(a1 + 4 * wrd);
      const float4 b4 = *reinterpret_cast<const float4*>(b1 + 4 * wrd);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w}, bv[4] = {b4.x, b4.y, b4.z, b4.w};
      const int j4 = lane & 3, quad = lane & ~3;
      const int kw = rank * g.cs + 4 * wrd, wblk = kw / g.KB, wc = kw - wblk * g.KB;  // the thread's h1 word
#pragma unroll 1
      for (int u0 = 0; u0 < MAX_UNITS; u0 += 4) {
        if (u0 * groups >= TILE_M) break;
        uint32_t hw[4];
#pragma unroll
        for (int k4 = 0; k4 < 4; ++k4) {
          const uint8_t* px = wins + dwoff[min(rg + (u0 + k4) * groups, TILE_M - 1)];
          int acc[4] = {0, 0, 0, 0};
#pragma unroll
          for (int tap = 0; tap < 9; ++tap) {
            const int xv = *reinterpret_cast<const int*>(
                px + (narrow ? (tap / 3) * g.RP + (tap % 3) * g.Cx : ((tap / 3) * g.WP + tap % 3) * g.cs));
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[k] = __dp4a(xv, static_cast<int>(wk[tap][k]), acc[k]);
          }
          uint32_t q[4];  // |acc| <= 9 * 128 * 127: exact without the conversion unit
#pragma unroll
          for (int k = 0; k < 4; ++k) q[k] = requant_byte(qt90::small_int_to_float(acc[k]), av[k], bv[k], e.lo1);
          hw[k4] = qt90::pack_low_bytes(q[0], q[1], q[2], q[3]);
        }
        if (cl) {
          uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int r = 0; r < 4; ++r) {  // lane j takes lane (j + r) % 4's word of row u0 + j
            const int give = (j4 - r) & 3, at = (j4 + r) & 3;
            const uint32_t mine = give == 0 ? hw[0] : give == 1 ? hw[1] : give == 2 ? hw[2] : hw[3];
            const uint32_t got = __shfl_sync(0xffffffffu, mine, quad + at);
#pragma unroll
            for (int k = 0; k < 4; ++k) v[k] = at == k ? got : v[k];
          }
          const int u = u0 + j4, m = rg + u * groups;
          if (u * groups < TILE_M && m < P && rg < groups) {
            const int off = l.h1 + hblk * TILE_M * g.KB + qt90::sw_offset(m, hc, g.KB);
            const uint4 v16 = make_uint4(v[0], v[1], v[2], v[3]);
            *reinterpret_cast<uint4*>(base + off) = v16;
            for (int r = 1; r < q; ++r) qtblock::st_cluster16(sbase + off, (rank + r) % q, v16);
          }
        } else {
#pragma unroll
          for (int k4 = 0; k4 < 4; ++k4) {
            const int m = rg + (u0 + k4) * groups;
            if ((u0 + k4) * groups < TILE_M && m < P && rg < groups)
              *reinterpret_cast<uint32_t*>(base + l.h1 + wblk * TILE_M * g.KB + qt90::sw_offset(m, wc, g.KB)) = hw[k4];
          }
        }
      }
    }
    if (cl) {
      asm volatile("fence.proxy.async.shared::cluster;\n" ::: "memory");
      qtblock::cluster_arrive();
      qtblock::cluster_wait();  // all of h1 is here
      qt90::fence_proxy_async();
    } else {
      qt90::fence_proxy_async();  // h1 before wgmma reads it
      __syncthreads();
    }

    // the pointwise conv: the block's BN channels over all of h1 (the
    // weights' load overlapped the first tile's window and depthwise pass)
    if (i == 0 && !narrow) qtconv::wait_or_trap(bar_w, 0);
    int acc[BN / 2];
#pragma unroll
    for (int r = 0; r < BN / 2; ++r) acc[r] = 0;
    qt90::wgmma_fence();
    qt90::fence_acc(acc);
    for (int s = 0; s < g.Kp / 32; ++s) {
      const int blk = s * 32 / g.KB, kk = s - blk * (g.KB / 32);
      const uint64_t da = qt90::sw_desc(sbase + l.h1 + blk * TILE_M * g.KB + wg * 64 * g.KB, g.KB) + 2 * kk;
      const uint64_t db = qt90::sw_desc(sbase + l.w + blk * BN * g.KB, g.KB) + 2 * kk;
      qt90::Wgmma<BN>::ss(acc, da, db);
    }
    qt90::wgmma_commit();
    qt90::wgmma_wait<0>();
    qt90::fence_acc(acc);
    if (cl) qtblock::cluster_arrive();  // this block no longer reads h1

    // the epilogue into the staging tile (the previous tile's copy-out read
    // it before the barriers since), then 16-byte pieces out
    int8_t* stage = reinterpret_cast<int8_t*>(base + l.stage);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = 8 * j + 2 * tq;
      const float2 av = *reinterpret_cast<const float2*>(a2 + n), bv = *reinterpret_cast<const float2*>(b2 + n);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = row0 + 8 * h;
        if (m >= P) continue;
        *reinterpret_cast<uint16_t*>(stage + m * sp + n) = static_cast<uint16_t>(__byte_perm(
            requant_byte(static_cast<float>(acc[4 * j + 2 * h]), av.x, bv.x, e.lo2),
            requant_byte(static_cast<float>(acc[4 * j + 2 * h + 1]), av.y, bv.y, e.lo2), 0x0040));
      }
    }
    __syncthreads();
    if (g.Co == g.Cout) {
      constexpr int CPR = BN / 16;  // 16-byte pieces a row
      for (int k = tid; k < P * CPR; k += THREADS) {
        const int m = k / CPR, piece = k - m * CPR, pix = outpix[m];
        if (pix < 0) continue;
        *reinterpret_cast<uint4*>(out + static_cast<long long>(pix) * g.Cout + rank * BN + 16 * piece) =
            *reinterpret_cast<const uint4*>(base + l.stage + m * sp + 16 * piece);
      }
    } else {  // Co % 16 != 0: the block's real channels of each row in 8-byte pieces
      const int cpr = min(BN, g.Co - rank * BN) / 8;
      for (int k = tid; k < P * cpr; k += THREADS) {
        const int m = k / cpr, piece = k - m * cpr, pix = outpix[m];
        if (pix < 0) continue;
        *reinterpret_cast<uint2*>(out + static_cast<long long>(pix) * g.Co + rank * BN + 8 * piece) =
            *reinterpret_cast<const uint2*>(base + l.stage + m * sp + 8 * piece);
      }
    }
  }
  if (cl) qtblock::cluster_wait();  // the last arrive
}

// ---- host side

// The launch plan of ops.dw_pw_plan
struct DwPlan {
  int q, tho, nb, clusters, smem;
};

// a 4-D (dims[0] fastest) int8 tensor's map in dense boxes
inline bool map4(CUtensorMap* map, const void* p, const int (&dims)[4], const int (&box)[4]) {
  qtconv::MapKey k = {};
  k.p = p;
  k.rank = 4;
  k.swizzle = 0;
  cuuint64_t stride = 1;
  for (int d = 0; d < 4; ++d) {
    k.dims[d] = static_cast<cuuint64_t>(dims[d]);
    k.box[d] = static_cast<cuuint32_t>(box[d]);
    k.estr[d] = 1;
    stride *= static_cast<cuuint64_t>(dims[d]);
    if (d < 3) k.strides[d] = stride;
  }
  return qtconv::conv_map(map, k);
}

template <int BN, int S, bool NARROW>
int launch_bn(const CUtensorMap& tx, const CUtensorMap& tw, const void* x, const void* wdw, const void* wpw, void* out,
              const DwGeom& g, const DwEpi& e, const DwPlan& p, cudaStream_t stream) {
  auto kernel = dw_pw_sm90_kernel<BN, S, NARROW>;
  static std::atomic<bool> opted_in{false};  // the full shared memory, asked for once per instance
  cudaError_t err;
  if (!opted_in.load()) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, qt::SMEM_LIMIT);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in.store(true);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.q * p.clusters);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.q;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, tx, tw, static_cast<const int8_t*>(x), static_cast<const int8_t*>(wdw),
                           static_cast<const int8_t*>(wpw), static_cast<int8_t*>(out), g, e);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int S, bool NARROW>
int launch_s(const CUtensorMap& tx, const CUtensorMap& tw, const void* x, const void* wdw, const void* wpw, void* out,
             const DwGeom& g, const DwEpi& e, const DwPlan& p, cudaStream_t s) {
  switch (g.no) {
    case 16: return launch_bn<16, S, NARROW>(tx, tw, x, wdw, wpw, out, g, e, p, s);
    case 32: return launch_bn<32, S, NARROW>(tx, tw, x, wdw, wpw, out, g, e, p, s);
    case 48: return launch_bn<48, S, NARROW>(tx, tw, x, wdw, wpw, out, g, e, p, s);
    case 64: return launch_bn<64, S, NARROW>(tx, tw, x, wdw, wpw, out, g, e, p, s);
    case 96: return launch_bn<96, S, NARROW>(tx, tw, x, wdw, wpw, out, g, e, p, s);
    default: return launch_bn<128, S, NARROW>(tx, tw, x, wdw, wpw, out, g, e, p, s);
  }
}

// B5 on its Hopper route under plan p, g.C and g.Cout the true widths
// (multiples of 8; C % 16 != 0 only unclustered and with W C % 16 == 0);
// 0 or the CUDA error. Refuses a plan that does not fit the shape.
inline int launch_dw_pw(const void* x, const void* wdw, const void* wpw, void* out, DwGeom g, const DwEpi& e,
                        const DwPlan& p, void* stream) {
  if ((g.S != 1 && g.S != 2) || g.C < 8 || g.C % 8 || g.Cout < 8 || g.Cout % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  g.Cx = g.C;
  g.Co = g.Cout;
  g.C = (g.Cx + 15) / 16 * 16;
  g.Cout = (g.Co + 15) / 16 * 16;
  const bool narrow = g.Cx != g.C;
  g.Ho = g.H / g.S;
  g.Wo = g.W / g.S;
  g.q = p.q;
  g.tho = p.tho;
  g.nb = p.nb;
  g.WR = (p.tho - 1) * g.S + 3;
  g.WP = g.W + 2;
  g.Kp = (g.C + 31) / 32 * 32;
  g.KB = g.Kp <= 32 ? 32 : g.Kp <= 64 ? 64 : 128;
  const bool q_ok = (p.q == 1 || p.q == 2 || p.q == 4 || p.q == 8) && g.C % p.q == 0 && g.Cout % p.q == 0;
  g.cs = q_ok ? g.C / p.q : 0;
  g.no = q_ok ? g.Cout / p.q : 0;
  g.RP = narrow ? (2 * g.cs + (g.W + 1) * g.Cx + 15) / 16 * 16 : g.WP * g.cs;
  g.h_tiles = p.tho >= 1 ? (g.Ho + p.tho - 1) / p.tho : 0;
  g.tiles = p.nb >= 1 ? g.h_tiles * ((g.N + p.nb - 1) / p.nb) : 0;
  const bool no_ok = g.no == 16 || g.no == 32 || g.no == 48 || g.no == 64 || g.no == 96 || g.no == 128;
  const bool ok = q_ok && no_ok && g.N >= 1 && g.H % g.S == 0 && g.W % g.S == 0 && g.cs % 16 == 0 && g.cs >= 16 &&
                  g.cs <= MAX_CS && p.tho >= 1 && p.nb >= 1 && g.Wo * p.tho * p.nb <= TILE_M &&
                  (p.nb == 1 || p.tho == g.Ho) && g.WP <= 256 && g.WR <= 256 && p.nb <= 256 && g.Wo <= 256 &&
                  p.clusters >= 1 && qt::aligned16(x) && (narrow ? p.q == 1 && g.W * g.Cx % 16 == 0 : qt::aligned16(wpw)) &&
                  qt::aligned(out, g.Co % 16 ? 8 : 16) && p.smem == dw_layout(g).total && p.smem <= qt::SMEM_LIMIT;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tx = {}, tw = {};  // narrow: x by bulk copies, wpw by the block's loads
  const int xd[4] = {g.C, g.W, g.H, g.N}, xb[4] = {g.cs, g.WP, g.WR, g.nb};
  if (!narrow && (!map4(&tx, x, xd, xb) || !qtconv::matrix_map(&tw, wpw, g.Co, g.C, g.no, g.KB)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (narrow)
    return g.S == 1 ? launch_s<1, true>(tx, tw, x, wdw, wpw, out, g, e, p, s)
                    : launch_s<2, true>(tx, tw, x, wdw, wpw, out, g, e, p, s);
  return g.S == 1 ? launch_s<1, false>(tx, tw, x, wdw, wpw, out, g, e, p, s)
                  : launch_s<2, false>(tx, tw, x, wdw, wpw, out, g, e, p, s);
}

}  // namespace
}  // namespace qtdw
