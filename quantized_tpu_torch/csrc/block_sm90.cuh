// The Hopper mainloop of B3 (the fused bottleneck) and B4 (the fused
// BasicBlock), and of the stage probes of the bottleneck (fused_stages.cu).
//
// Every stage of a block is one GEMM: its rows are output pixels of the
// stage, its columns a slice of the stage's output channels, its K the
// stage's taps times input channels.
//
// - A cluster of q blocks (q = 1, 2, 4 or 8) works on one band of output
//   rows of nb images (nb > 1 only where an image is small: 7x7 packs two
//   images into a 128-row tile). Block `rank` computes channels [rank *
//   Cm/q, (rank + 1) * Cm/q) of h1 (and of h2), and then writes them into
//   every peer's h1 through distributed shared memory (mapa +
//   st.shared::cluster, 16 bytes at a time) before a cluster barrier
//   (arrive.release / wait.acquire). Each block then holds all of h1 and
//   reads it locally for conv2; h2 works the same way. conv3 and the
//   shortcut (B3), or conv2 and the shortcut (B4), give each block Cout/q
//   channels of the final epilogue. So each block streams 1/q of the
//   weights, and a late stage runs on q times the blocks of one per image.
//   The last write to a peer is followed by a cluster barrier, so no block
//   leaves while a peer may still write to it.
// - Weights by TMA through an mbarrier ring: a stage is a box of (bn output
//   channels, 128 K bytes) with the 128-byte swizzle that wgmma's
//   descriptors read. The ring runs through all the block's GEMMs in one
//   sequence (conv1's jobs, conv2's, conv3's), so the loads of the next
//   job's first weights are in flight while this job's epilogue runs. As in
//   the GEMM of K1 (gemm_sm90.cuh), thread 0 refills a slot once every warp
//   has passed the wgmma wait that retires it; its cursor over the stream
//   and the ring's state stay in registers (no array indexed at run time:
//   in local memory they made layer1.1 take 0.19 ms rather than 0.15).
// - A in registers, wgmma's register-sourced operand (the m16n8k32
//   fragment layout of qt::mma_tile: rows g and g + 8 of a warp's 16, K
//   bytes 4t.. and 16 + 4t.. of each 32-byte step), gathered through any
//   pixel mapping. From h1 and h2 in shared memory by ldmatrix: the 3x3
//   taps at stride 1 or 2 over h1, whose border holds conv2's stored zero
//   point, so padding is exact by construction, and h2 for conv3. From x
//   in device memory (L1/L2) by 4-byte loads: conv1, the shortcut, and B4's
//   conv1, whose taps outside the image read conv1's stored zero point. x
//   is not staged: at the late stages a tile's x is 100-200 KB, beside h1
//   and h2. A 4-byte word never straddles a tap (C % 16 == 0), so the
//   narrow CIFAR widths need no special case: K runs over the taps in
//   128-byte stages, and bytes past K meet zero-filled weight columns.
// - Two consumer warpgroups of 64 rows share each weight stage: a job is a
//   tile of 128 GEMM rows x bn (16, 32 or 64) channels.
//
// What bounds it on the H100: the blocks' int8 operations (1979 TOP/s) at
// the late stages, the input and output bytes (3.35 TB/s) at layer1 (the
// bound_ms of chip_smoke.py). What holds it back (probes/fused_stages):
// about 1 us a ring stage at one block an SM, and a fixed cost a job (the
// final wgmma wait, the epilogue's arithmetic, its constants' latency), so
// the final 1x1 conv of a block, one ring stage a job, takes half of
// layer1's time.
//
// The epilogues (requant, shortcut_leg, residual_out) round one float32
// operation at a time, __fmul_rn/__fadd_rn and rintf under -fmad=false, so
// every output equals the plain PyTorch version to the bit. Cout is a
// multiple of 16 (the wrapper pads a bottleneck's other Cout).
#pragma once

#include <atomic>
#include <type_traits>

#include "conv_sm90.cuh"

namespace qtblock {
// Internal linkage, as in conv_sm90.cuh: fused_block.cu and fused_stages.cu
// each build their own instances, each with its own shared-memory opt-in.
namespace {

constexpr int TILE_M = 128;  // GEMM rows per job: two consumer warpgroups of 64
constexpr int THREADS = 256;
constexpr int KB = 128;      // K bytes per ring stage: one 128-byte swizzle row
constexpr int MAX_STAGES = 8;

struct BlockGeom {
  int N, H, W, C, Cm, Cout;
  int Ho, Wo;
  int R, nb;      // output rows per band; images per cluster (nb > 1: R = Ho)
  int HR, WP, P;  // h1 per image: rows, pixels a row; h1/h2 pixel pitch
  int q, stages;  // cluster size; ring slots
};

struct BlockEpi {
  const float *a1, *b1, *a2, *b2, *a3, *b3, *ad, *bd;
  float lo1, lo2, shift, id_k, id_c, fine, inv_fine;
  int zp1, zp2;
};

// The launch plan of ops.block_plan
struct BlockPlan {
  int q, nb, bn, stages, smem;
};

// Dynamic shared memory: 1024 bytes to align the ring, the ring, 16 bytes a
// slot for its mbarrier (h1 stays 16-byte aligned), h1, and h2 for B3.
__host__ __device__ constexpr long long smem_bytes(int bn, int stages, int nb, int HR, int WP, int P, int h2_pix) {
  return 1024 + static_cast<long long>(stages) * bn * KB + 16 * stages +
         static_cast<long long>(nb) * HR * WP * P + static_cast<long long>(nb) * h2_pix * P;
}

// ---- the weight stream: phases of jobs, each job ksa stages of map ma then ksb of map mb

struct Phase {
  int jobs, nsub, ksa, ksb, ma, mb, nbase;
};

// The block's weight stream. No array is indexed at run time, so it all
// stays in registers: the consumers' position (g, its slot and parity) and
// thread 0's cursor over the phases (the next stage it issues).
struct Ring {
  Phase ph0, ph1, ph2;
  int nph, total, stages;
  uint32_t ring, full;
  const CUtensorMap *m0, *m1, *m2, *m3;
  int g, slot, parity;         // the next stage the consumers take
  int next, cp, cjob, cns, cs;  // the next stage thread 0 issues: phase, job, channel job, K stage
};

__device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ Phase phase_of(const Ring& rg, int p) { return p == 0 ? rg.ph0 : p == 1 ? rg.ph1 : rg.ph2; }

__device__ __forceinline__ void add_phase(Ring& rg, Phase p) {
  if (rg.nph == 0)
    rg.ph0 = p;
  else if (rg.nph == 1)
    rg.ph1 = p;
  else
    rg.ph2 = p;
  ++rg.nph;
  rg.total += p.jobs * p.nsub * (p.ksa + p.ksb);
}

// thread 0: the next stage of the stream into its slot, then the cursor on
template <int BN>
__device__ __forceinline__ void issue_next(Ring& rg) {
  const Phase f = phase_of(rg, rg.cp);
  const bool second = rg.cs >= f.ksa;
  const int m = second ? f.mb : f.ma;
  const CUtensorMap* map = m == 0 ? rg.m0 : m == 1 ? rg.m1 : m == 2 ? rg.m2 : rg.m3;
  const int slot = rg.next % rg.stages;
  const uint32_t bar = rg.full + 16 * slot;
  qt90::mbar_expect_tx(bar, BN * KB);
  qt90::tma_load(rg.ring + slot * (BN * KB), map, bar, (second ? rg.cs - f.ksa : rg.cs) * KB, f.nbase + rg.cns * BN);
  ++rg.next;
  if (++rg.cs == f.ksa + f.ksb) {
    rg.cs = 0;
    if (++rg.cns == f.nsub) {
      rg.cns = 0;
      if (++rg.cjob == f.jobs) {
        rg.cjob = 0;
        ++rg.cp;
      }
    }
  }
}

__device__ __forceinline__ void fence_frag(uint32_t (&f)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(f[i][r])::"memory");
}

// acc += A (the job's 128 rows, gathered) x W (the ring's next ks stages)^T.
// A stage's fragments are gathered while the previous stage's wgmmas run;
// they stay in their registers (two sets, alternating) until the stage
// retires, one stage later (wait_group 1).
template <int BN, typename Gather>
__device__ __forceinline__ void run_k(Ring& rg, int (&acc)[BN / 2], int ks, Gather&& gather) {
  uint32_t frag[2][4][4];
  int k = 0;
  auto step = [&](auto parity) {
    constexpr int P = decltype(parity)::value;
    gather(k * KB, frag[P]);
    qtconv::wait_or_trap(rg.full + 16 * rg.slot, rg.parity);
    const uint32_t b = rg.ring + rg.slot * (BN * KB);
    qt90::wgmma_fence();
    qt90::fence_acc(acc);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      qt90::Wgmma<BN>::rs(acc, frag[P][kk][0], frag[P][kk][1], frag[P][kk][2], frag[P][kk][3],
                          qt90::sw_desc(b, KB) + 2 * kk);
    qt90::wgmma_commit();
    qt90::wgmma_wait<1>();  // the previous stage has retired: its fragments and its slot are free
    qt90::fence_acc(acc);
    fence_frag(frag[1 - P]);
    __syncthreads();  // every warp is past the wait before TMA refills the slot
    if (threadIdx.x == 0 && rg.g >= 1 && rg.next < rg.total) issue_next<BN>(rg);  // into the retired slot
    ++rg.g;
    if (++rg.slot == rg.stages) {
      rg.slot = 0;
      rg.parity ^= 1;
    }
    ++k;
  };
  while (k + 1 < ks) {
    step(std::integral_constant<int, 0>{});
    step(std::integral_constant<int, 1>{});
  }
  if (k < ks) step(std::integral_constant<int, 0>{});
  qt90::wgmma_wait<0>();
  qt90::fence_acc(acc);
  fence_frag(frag[0]);
  fence_frag(frag[1]);
}

// ---- A gathers: f[kk][2 * half + h] is row g + 8h, K bytes 32kk + 16half + 4t..

__device__ __forceinline__ uint32_t ldg_word(const int8_t* p) { return __ldg(reinterpret_cast<const unsigned int*>(p)); }

// a 1x1 GEMM over x in device memory: each row's K bytes from its pointer
// (null: a row past the GEMM's)
__device__ __forceinline__ void gather_rows(const int8_t* const (&src)[2], int kb, int klim, uint32_t (&f)[4][4]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int k = kb + 32 * kk + 16 * half + 4 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) f[kk][2 * half + h] = (src[h] != nullptr && k < klim) ? ldg_word(src[h] + k) : 0u;
    }
}

// (tap, channel) of the thread's eight K bytes kb + 16i + 4t of a stage,
// i = 2kk + half: one division a stage (cin % 16 == 0, so a step of 16
// crosses at most one tap boundary); for B4's conv1 over x
__device__ __forceinline__ void tap_split(int kb, int cin, int (&tap)[8], int (&ch)[8]) {
  int tp = kb / cin;
  int c = kb - tp * cin + 4 * (threadIdx.x & 3);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    tap[i] = tp;
    ch[i] = c;
    c += 16;
    if (c >= cin) {
      c -= cin;
      ++tp;
    }
  }
}

// From shared memory (h1, h2) a warp loads its fragments with ldmatrix:
// lane i gives the address of row i % 16 of the warp's 16 at K bytes 16 *
// (i / 16) of a 32-byte step, and the four 8x8 b16 matrices come back in
// the fragment's order (rows g and g + 8, K bytes 4t and 16 + 4t), one
// instruction where 4-byte loads take four. A row past the GEMM's reads a
// valid row (its products are not stored), a K byte past K reads offset 0
// (it meets zero-filled weight columns).
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The lane's ldmatrix row in a job tile
__device__ __forceinline__ int ldsm_row() {
  const int warp = threadIdx.x >> 5;
  return (warp >> 2) * 64 + (warp & 3) * 16 + (threadIdx.x & 15);
}

// a 1x1 GEMM over a shared buffer: `row`, the shared address of the lane's row
__device__ __forceinline__ void ldsm_rows(uint32_t row, int kb, int klim, uint32_t (&f)[4][4]) {
  const int k0 = kb + 16 * ((threadIdx.x & 31) >> 4);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int k = k0 + 32 * kk;
    ldsm4(f[kk], row + (k < klim ? k : 0));
  }
}

// the 3x3 taps over a shared buffer whose border holds the stored zero
// point (h1): K byte k = tap * cin + ch at the row's window corner plus
// (tap / 3) rows and (tap % 3) pixels
__device__ __forceinline__ void ldsm_taps(uint32_t row, int kb, int cin, int row_bytes, int pix_bytes,
                                          uint32_t (&f)[4][4]) {
  const int k0 = kb + 16 * ((threadIdx.x & 31) >> 4);
  int tp = k0 / cin, c = k0 - tp * cin;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int dy = tp / 3;
    ldsm4(f[kk], row + (tp < 9 ? dy * row_bytes + (tp - 3 * dy) * pix_bytes + c : 0));
    c += 32;
    while (c >= cin) {
      c -= cin;
      ++tp;
    }
  }
}

// the 3x3 taps over x in device memory (B4's conv1): taps outside the image
// read the stored zero point's bytes zpw
struct XRow {
  const int8_t* img;  // the image's first byte; null: a row past the GEMM's
  int hi0, wi0;       // the window's top-left input pixel
};

__device__ __forceinline__ void gather_x_taps(const XRow (&r)[2], int kb, int H, int W, int C, uint32_t zpw,
                                              uint32_t (&f)[4][4]) {
  int tap[8], ch[8];
  tap_split(kb, C, tap, ch);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const bool in = tap[i] < 9;
    const int dy = tap[i] / 3, dx = tap[i] - 3 * dy;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t v = 0u;
      if (r[h].img != nullptr && in) {
        const int hi = r[h].hi0 + dy, wi = r[h].wi0 + dx;
        v = (hi >= 0 && hi < H && wi >= 0 && wi < W)
                ? ldg_word(r[h].img + (static_cast<size_t>(hi) * W + wi) * C + ch[i])
                : zpw;
      }
      f[i >> 1][2 * (i & 1) + h] = v;
    }
  }
}

// ---- epilogues

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

// The thread's first row in a job tile; its second is 8 below. Accumulator
// v = 4j + 2h + e holds row + 8h, channel 8j + 2t + e of the job.
__device__ __forceinline__ int job_row() {
  const int warp = threadIdx.x >> 5;
  return (warp >> 2) * 64 + (warp & 3) * 16 + ((threadIdx.x & 31) >> 2);
}

// A job's per-channel epilogue constants: this thread's channels n0 + 8j +
// 2t and + 1, loaded before the job's mainloop so their latency is hidden.
template <int BN>
struct Consts {
  float a[BN / 8][2], b[BN / 8][2];
};

template <int BN>
__device__ __forceinline__ void load_consts(Consts<BN>& c, const float* a, const float* b, int n0) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      c.a[j][e] = __ldg(a + n0 + 8 * j + 2 * t + e);
      c.b[j][e] = __ldg(b + n0 + 8 * j + 2 * t + e);
    }
}

// h1 or h2 <- clip(rint(acc * a[n] + b[n]), lo, 127) at channels n0.. of each row's pixel
template <int BN>
__device__ __forceinline__ void store_requant(const int (&acc)[BN / 2], int8_t* const (&dst)[2], int n0,
                                              const Consts<BN>& c, float lo) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (dst[h] != nullptr)
        *reinterpret_cast<char2*>(dst[h] + n0 + 8 * j + 2 * t) =
            make_char2(qt::requant(acc[4 * j + 2 * h], c.a[j][0], c.b[j][0], lo),
                       qt::requant(acc[4 * j + 2 * h + 1], c.a[j][1], c.b[j][1], lo));
}

// The identity's x at the job's channels of each row's pixel
template <int BN>
__device__ __forceinline__ void load_identity(char2 (&xv)[BN / 8][2], const int8_t* const (&xid)[2], int n0) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      xv[j][h] = xid[h] != nullptr ? *reinterpret_cast<const char2*>(xid[h] + n0 + 8 * j + 2 * t) : make_char2(0, 0);
}

// out <- the final epilogue at channels n0.. of each row's output pixel:
// y = acc * a[n] + b[n]; idq from the shortcut conv's accd (DS: constants
// cd) or from the identity's x (xv); clip(rint(y + idq), shift, 127)
template <int BN, bool DS>
__device__ __forceinline__ void store_out(const int (&acc)[BN / 2], const int (&accd)[BN / 2], int8_t* const (&dst)[2],
                                          int n0, const Consts<BN>& c, const Consts<BN>& cd,
                                          const char2 (&xv)[BN / 8][2], const BlockEpi& e) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (dst[h] == nullptr) continue;
      int8_t q[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int v = 4 * j + 2 * h + i;
        const float y = __fadd_rn(__fmul_rn(static_cast<float>(acc[v]), c.a[j][i]), c.b[j][i]);
        float idq;
        if constexpr (DS)
          idq = shortcut_leg(accd[v], cd.a[j][i], cd.b[j][i], e.fine, e.inv_fine);
        else
          idq = __fadd_rn(__fmul_rn(static_cast<float>(i == 0 ? xv[j][h].x : xv[j][h].y), e.id_k), e.id_c);
        q[i] = residual_out(y, idq, e.shift);
      }
      *reinterpret_cast<char2*>(dst[h] + n0 + 8 * j + 2 * t) = make_char2(q[0], q[1]);
    }
}

// A final GEMM row's input pixel (the shortcut conv's or the identity's)
// and output pixel
struct Pixel {
  const int8_t* x;
  int8_t* out;
};

// The final jobs (mt, ns), mt-major, nsub channel jobs of bn a tile. A
// job's epilogue constants (and the identity's pixels) are loaded before
// its last GEMM, so their latency overlaps it. pix(m) gives GEMM row m's
// pixels; main(mt, acc) runs the job's GEMM, and with DS, shortcut(xs,
// accd) the shortcut conv's over the thread's rows' input pixels. (Loading
// them a whole job ahead, in a second set of registers, and staging the
// output through shared memory for whole 16-byte stores, timed no faster
// on the H100; loading the shortcut's constants before both GEMMs made
// ptxas spill.)
template <int BN, bool DS, typename Pix, typename Main, typename Shortcut>
__device__ __forceinline__ void final_jobs(int mts, int nsub, int nbase, int M, const float* a, const float* b,
                                           const BlockEpi& e, Pix&& pix, Main&& main, Shortcut&& shortcut) {
  const int row = job_row();
  for (int mt = 0; mt < mts; ++mt) {
    const int8_t* xs[2];
    int8_t* dst[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = mt * TILE_M + row + 8 * h;
      const Pixel p = pix(min(m, M - 1));
      xs[h] = m < M ? p.x : nullptr;
      dst[h] = m < M ? p.out : nullptr;
    }
    for (int ns = 0; ns < nsub; ++ns) {
      const int n0 = nbase + ns * BN;
      Consts<BN> c, cd;
      char2 xv[BN / 8][2];
      int acc[BN / 2] = {}, accd[BN / 2] = {};
      if constexpr (!DS) {
        load_consts(c, a, b, n0);
        load_identity<BN>(xv, xs, n0);
      }
      main(mt, acc);
      if constexpr (DS) {
        load_consts(c, a, b, n0);
        load_consts(cd, e.ad, e.bd, n0);
        shortcut(xs, accd);
      }
      store_out<BN, DS>(acc, accd, dst, n0, c, cd, xv, e);
    }
  }
}

// ---- the cluster

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// 16 bytes into the cluster's block `rank` at shared address `saddr` of its own layout
__device__ __forceinline__ void st_cluster16(uint32_t saddr, int rank, uint4 v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(saddr), "r"(rank));
  asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(remote), "r"(v.x), "r"(v.y), "r"(v.z),
               "r"(v.w)
               : "memory");
}

// This block's channels [c0, c0 + width) of the npix pixels at buf +
// off(m) into every peer's buffer at the same place (the layouts are
// equal), 16 bytes at a time; the caller's cluster barrier follows.
template <typename Off>
__device__ __forceinline__ void broadcast(const int8_t* buf, int q, int rank, int npix, int c0, int width, Off&& off) {
  if (q == 1) return;
  const int chunks = width / 16;
  const uint32_t base = qt90::smem_u32(buf);
  for (int i = threadIdx.x; i < npix * chunks; i += THREADS) {
    const int m = i / chunks;
    const int o = off(m) + c0 + 16 * (i - m * chunks);
    const uint4 v = *reinterpret_cast<const uint4*>(buf + o);
    for (int r = 1; r < q; ++r) st_cluster16(base + o, (rank + r) % q, v);
  }
}

// The block's shared memory: the ring, its mbarriers, h1 (16-byte aligned)
struct Smem {
  uint32_t ring, full;
  int8_t* h1;
};

template <int BN>
__device__ __forceinline__ Smem carve(uint8_t* smem_raw, int stages) {
  const uint32_t raw = qt90::smem_u32(smem_raw);
  uint8_t* base = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  Smem s;
  s.ring = qt90::smem_u32(base);
  s.full = s.ring + stages * (BN * KB);
  s.h1 = reinterpret_cast<int8_t*>(base + stages * (BN * KB) + 16 * stages);
  return s;
}

// mbarriers initialised, h1 filled with conv2's stored zero point, every
// block of the cluster past both, then the ring's first stages issued
template <int BN>
__device__ __forceinline__ void start(Ring& rg, int8_t* h1, int h1_bytes, int zp2) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < rg.stages; ++s) qt90::mbar_init(rg.full + 16 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const uint4 fill = qt::fill16(zp2);
  for (int i = threadIdx.x; i < h1_bytes / 16; i += THREADS) reinterpret_cast<uint4*>(h1)[i] = fill;
  cluster_sync();  // no peer writes h1 before its owner has filled it
  if (threadIdx.x == 0)
    while (rg.next < min(rg.stages, rg.total)) issue_next<BN>(rg);
}

// ---- B3: the bottleneck, and its stage probes (STOP 1: after conv1, 2: after conv2)
//
// Grid (q, bands, image groups), clusters of (q, 1, 1). h1 per image: HR =
// (R - 1) * S + 3 rows of W + 2 pixels, local row lr = image row r0 * S - 1
// + lr, column c at pixel c + 1; h2: R * Wo pixels per image.

template <int BN, int S, bool DS, int STOP>
__global__ void __launch_bounds__(THREADS, 1)
    bottleneck_sm90_kernel(const __grid_constant__ CUtensorMap tw1, const __grid_constant__ CUtensorMap tw2,
                           const __grid_constant__ CUtensorMap tw3, const __grid_constant__ CUtensorMap twd,
                           const int8_t* __restrict__ x, int8_t* __restrict__ out, BlockGeom g, BlockEpi e) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const Smem sm = carve<BN>(smem_raw, g.stages);
  int8_t* h1 = sm.h1;
  const int h1_img = g.HR * g.WP * g.P;
  int8_t* h2 = h1 + g.nb * h1_img;
  const int rank = blockIdx.x, q = g.q;
  const int slice1 = g.Cm / q, slice3 = g.Cout / q;
  const int img0 = blockIdx.z * g.nb, nbk = min(g.nb, g.N - img0);
  const int r0 = blockIdx.y * g.R, rb = min(g.R, g.Ho - r0);
  const int hb = r0 * S - 1;  // image row of h1's local row 0
  const int lr_lo = max(0, -hb), lr_hi = min((rb - 1) * S + 3, g.H - hb);
  const int L1 = (lr_hi - lr_lo) * g.W, m1 = nbk * L1;  // conv1's rows: the band's in-image h1 pixels
  const int L2 = rb * g.Wo, m2 = nbk * L2;              // conv2's and conv3's: the band's output pixels
  const int mt1 = cdiv(m1, TILE_M), mt2 = cdiv(m2, TILE_M);

  Ring rg = {};
  rg.stages = g.stages;
  rg.ring = sm.ring;
  rg.full = sm.full;
  rg.m0 = &tw1;
  rg.m1 = &tw2;
  rg.m2 = &tw3;
  rg.m3 = &twd;
  add_phase(rg, {mt1, slice1 / BN, cdiv(g.C, KB), 0, 0, 0, rank * slice1});
  if (STOP != 1) add_phase(rg, {mt2, slice1 / BN, cdiv(9 * g.Cm, KB), 0, 1, 1, rank * slice1});
  if (STOP == 0) add_phase(rg, {mt2, slice3 / BN, cdiv(g.Cm, KB), DS ? cdiv(g.C, KB) : 0, 2, 3, rank * slice3});
  start<BN>(rg, h1, g.nb * h1_img, e.zp2);

  const int row = job_row();
  auto h1_off = [&](int m) {  // conv1 row m -> its pixel in h1
    const int im = m / L1, rem = m - im * L1, lr = lr_lo + rem / g.W, col = rem % g.W;
    return im * h1_img + (lr * g.WP + col + 1) * g.P;
  };

  // conv1 (1x1) on the band's in-image h1 pixels
  for (int mt = 0; mt < mt1; ++mt) {
    const int8_t* src[2];
    int8_t* dst[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = mt * TILE_M + row + 8 * h;
      src[h] = nullptr;
      dst[h] = nullptr;
      if (m < m1) {
        const int im = m / L1, rem = m - im * L1, lr = lr_lo + rem / g.W, col = rem % g.W;
        src[h] = x + ((static_cast<size_t>(img0 + im) * g.H + hb + lr) * g.W + col) * g.C;
        dst[h] = h1 + h1_off(m);
      }
    }
    for (int ns = 0; ns < slice1 / BN; ++ns) {
      const int n0 = rank * slice1 + ns * BN;
      Consts<BN> c;
      load_consts(c, e.a1, e.b1, n0);
      int acc[BN / 2] = {};
      run_k<BN>(rg, acc, cdiv(g.C, KB), [&](int kb, uint32_t(&f)[4][4]) { gather_rows(src, kb, g.C, f); });
      store_requant<BN>(acc, dst, n0, c, e.lo1);
    }
  }
  __syncthreads();
  broadcast(h1, q, rank, m1, rank * slice1, slice1, h1_off);
  cluster_sync();

  auto out_pix = [&](int m) {  // conv2's / conv3's row m -> (local image, output row, column)
    const int im = m / L2, rem = m - im * L2;
    return make_int3(im, rem / g.Wo, rem % g.Wo);
  };
  if constexpr (STOP == 1) {  // the probe's output: h1 at the band's pixels, tiled across C channels
    const int width = g.Cout / q, chunks = width / 16;
    for (int i = threadIdx.x; i < m2 * chunks; i += THREADS) {
      const int m = i / chunks, ch = rank * width + 16 * (i - m * chunks);
      const int3 p = out_pix(m);
      const int8_t* s = h1 + p.x * h1_img + ((p.y + 1) * g.WP + p.z + 1) * g.P + ch % g.Cm;
      *reinterpret_cast<uint4*>(out + ((static_cast<size_t>(img0 + p.x) * g.Ho + r0 + p.y) * g.Wo + p.z) * g.Cout +
                                ch) = *reinterpret_cast<const uint4*>(s);
    }
    return;
  }

  // conv2 (3x3, stride S): output (i, j), tap (dy, dx) reads h1 local pixel (i*S + dy, j*S + dx)
  const uint32_t h1s = qt90::smem_u32(h1), h2s = qt90::smem_u32(h2);
  for (int mt = 0; mt < mt2; ++mt) {
    int8_t* dst[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = mt * TILE_M + row + 8 * h;
      dst[h] = m < m2 ? h2 + m * g.P : nullptr;
    }
    const int3 pl = out_pix(min(mt * TILE_M + ldsm_row(), m2 - 1));
    const uint32_t src = h1s + pl.x * h1_img + (pl.y * S * g.WP + pl.z * S) * g.P;
    for (int ns = 0; ns < slice1 / BN; ++ns) {
      const int n0 = rank * slice1 + ns * BN;
      Consts<BN> c;
      load_consts(c, e.a2, e.b2, n0);
      int acc[BN / 2] = {};
      run_k<BN>(rg, acc, cdiv(9 * g.Cm, KB),
                [&](int kb, uint32_t(&f)[4][4]) { ldsm_taps(src, kb, g.Cm, g.WP * g.P, g.P, f); });
      store_requant<BN>(acc, dst, n0, c, e.lo2);
    }
  }
  __syncthreads();
  broadcast(h2, q, rank, m2, rank * slice1, slice1, [&](int m) { return m * g.P; });
  cluster_sync();  // the last write to a peer: no block leaves before it

  if constexpr (STOP == 2) {
    const int width = g.Cout / q, chunks = width / 16;
    for (int i = threadIdx.x; i < m2 * chunks; i += THREADS) {
      const int m = i / chunks, ch = rank * width + 16 * (i - m * chunks);
      const int3 p = out_pix(m);
      *reinterpret_cast<uint4*>(out + ((static_cast<size_t>(img0 + p.x) * g.Ho + r0 + p.y) * g.Wo + p.z) * g.Cout +
                                ch) = *reinterpret_cast<const uint4*>(h2 + m * g.P + ch % g.Cm);
    }
    return;
  }

  // conv3 (1x1) over h2 and the shortcut, then the final epilogue
  final_jobs<BN, DS>(
      mt2, slice3 / BN, rank * slice3, m2, e.a3, e.b3, e,
      [&](int m) {
        const int3 p = out_pix(m);
        return Pixel{x + ((static_cast<size_t>(img0 + p.x) * g.H + (r0 + p.y) * S) * g.W + p.z * S) * g.C,
                     out + ((static_cast<size_t>(img0 + p.x) * g.Ho + r0 + p.y) * g.Wo + p.z) * g.Cout};
      },
      [&](int mt, int(&acc)[BN / 2]) {
        const uint32_t src = h2s + min(mt * TILE_M + ldsm_row(), m2 - 1) * g.P;
        run_k<BN>(rg, acc, cdiv(g.Cm, KB), [&](int kb, uint32_t(&f)[4][4]) { ldsm_rows(src, kb, g.Cm, f); });
      },
      [&](const int8_t* const(&xs)[2], int(&accd)[BN / 2]) {
        run_k<BN>(rg, accd, cdiv(g.C, KB), [&](int kb, uint32_t(&f)[4][4]) { gather_rows(xs, kb, g.C, f); });
      });
}

// ---- B4: the BasicBlock
//
// h1 per image: R + 2 rows of Wo + 2 pixels, local row = output-grid row -
// r0 + 1, column j at pixel j + 1; no h2: conv2's accumulators go straight
// into the final epilogue.

template <int BN, int S, bool DS>
__global__ void __launch_bounds__(THREADS, 1)
    basic_sm90_kernel(const __grid_constant__ CUtensorMap tw1, const __grid_constant__ CUtensorMap tw2,
                      const __grid_constant__ CUtensorMap twd, const int8_t* __restrict__ x,
                      int8_t* __restrict__ out, BlockGeom g, BlockEpi e) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const Smem sm = carve<BN>(smem_raw, g.stages);
  int8_t* h1 = sm.h1;
  const int h1_img = g.HR * g.WP * g.P;
  const int rank = blockIdx.x, q = g.q, slice = g.Cm / q;
  const int img0 = blockIdx.z * g.nb, nbk = min(g.nb, g.N - img0);
  const int r0 = blockIdx.y * g.R, rb = min(g.R, g.Ho - r0);
  const int i_lo = max(0, r0 - 1), i_hi = min(g.Ho, r0 + rb + 1);
  const int L1 = (i_hi - i_lo) * g.Wo, m1 = nbk * L1;  // conv1's rows: grid rows r0-1 .. r0+rb in the image
  const int L2 = rb * g.Wo, m2 = nbk * L2;
  const int mt1 = cdiv(m1, TILE_M), mt2 = cdiv(m2, TILE_M);

  Ring rg = {};
  rg.stages = g.stages;
  rg.ring = sm.ring;
  rg.full = sm.full;
  rg.m0 = &tw1;
  rg.m1 = &tw2;
  rg.m2 = rg.m3 = &twd;
  add_phase(rg, {mt1, slice / BN, cdiv(9 * g.C, KB), 0, 0, 0, rank * slice});
  add_phase(rg, {mt2, slice / BN, cdiv(9 * g.Cm, KB), DS ? cdiv(g.C, KB) : 0, 1, 2, rank * slice});
  start<BN>(rg, h1, g.nb * h1_img, e.zp2);

  const int row = job_row();
  auto h1_off = [&](int m) {
    const int im = m / L1, rem = m - im * L1, i = i_lo + rem / g.Wo, j = rem % g.Wo;
    return im * h1_img + ((i - r0 + 1) * g.WP + j + 1) * g.P;
  };
  const uint32_t zpw = qt::zp_bytes(e.zp1);

  // conv1 (3x3, stride S) over x, taps outside the image at conv1's stored zero point
  for (int mt = 0; mt < mt1; ++mt) {
    XRow src[2];
    int8_t* dst[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = mt * TILE_M + row + 8 * h;
      src[h] = XRow{nullptr, 0, 0};
      dst[h] = nullptr;
      if (m < m1) {
        const int im = m / L1, rem = m - im * L1, i = i_lo + rem / g.Wo, j = rem % g.Wo;
        src[h] = XRow{x + static_cast<size_t>(img0 + im) * g.H * g.W * g.C, i * S - 1, j * S - 1};
        dst[h] = h1 + h1_off(m);
      }
    }
    for (int ns = 0; ns < slice / BN; ++ns) {
      const int n0 = rank * slice + ns * BN;
      Consts<BN> c;
      load_consts(c, e.a1, e.b1, n0);
      int acc[BN / 2] = {};
      run_k<BN>(rg, acc, cdiv(9 * g.C, KB),
                [&](int kb, uint32_t(&f)[4][4]) { gather_x_taps(src, kb, g.H, g.W, g.C, zpw, f); });
      store_requant<BN>(acc, dst, n0, c, e.lo1);
    }
  }
  __syncthreads();
  broadcast(h1, q, rank, m1, rank * slice, slice, h1_off);
  cluster_sync();  // the last write to a peer: no block leaves before it

  // conv2 (3x3, stride 1) over h1 and the shortcut, then the final epilogue
  const uint32_t h1s = qt90::smem_u32(h1);
  auto pix = [&](int m) {
    const int im = m / L2, rem = m - im * L2, i = rem / g.Wo, j = rem % g.Wo;
    return Pixel{x + ((static_cast<size_t>(img0 + im) * g.H + (r0 + i) * S) * g.W + j * S) * g.C,
                 out + ((static_cast<size_t>(img0 + im) * g.Ho + r0 + i) * g.Wo + j) * g.Cm};
  };
  final_jobs<BN, DS>(
      mt2, slice / BN, rank * slice, m2, e.a2, e.b2, e, pix,
      [&](int mt, int(&acc)[BN / 2]) {
        const int ml = min(mt * TILE_M + ldsm_row(), m2 - 1), iml = ml / L2, reml = ml - iml * L2;
        const uint32_t src = h1s + iml * h1_img + ((reml / g.Wo) * g.WP + reml % g.Wo) * g.P;
        run_k<BN>(rg, acc, cdiv(9 * g.Cm, KB),
                  [&](int kb, uint32_t(&f)[4][4]) { ldsm_taps(src, kb, g.Cm, g.WP * g.P, g.P, f); });
      },
      [&](const int8_t* const(&xs)[2], int(&accd)[BN / 2]) {
        run_k<BN>(rg, accd, cdiv(g.C, KB), [&](int kb, uint32_t(&f)[4][4]) { gather_rows(xs, kb, g.C, f); });
      });
}

// ---- host side

// Whether a plan fits the shape (the C entries refuse any other)
inline bool plan_ok(const BlockGeom& g, const BlockPlan& p, int h2_pix) {
  const bool q_ok = (p.q == 1 || p.q == 2 || p.q == 4 || p.q == 8) && g.Cm % p.q == 0 && g.Cout % p.q == 0;
  if (!q_ok || !(p.bn == 16 || p.bn == 32 || p.bn == 64)) return false;
  const int s1 = g.Cm / p.q, s3 = g.Cout / p.q;
  return s1 % 16 == 0 && s3 % 16 == 0 && s1 % p.bn == 0 && s3 % p.bn == 0 && p.stages >= 2 &&
         p.stages <= MAX_STAGES && p.nb >= 1 && g.R >= 1 && (p.nb == 1 || g.R == g.Ho) &&
         p.smem == smem_bytes(p.bn, p.stages, p.nb, g.HR, g.WP, g.P, h2_pix) && p.smem <= qt::SMEM_LIMIT;
}

// cudaLaunchKernelEx with clusters of (q, 1, 1) over (q, bands, image groups)
template <typename Kernel, typename... Args>
int launch_cluster(Kernel kernel, std::atomic<bool>& opted_in, const BlockGeom& g, int smem, void* stream,
                   Args... args) {
  cudaError_t err;
  if (!opted_in.load()) {  // the full shared memory, asked for once per instance
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, qt::SMEM_LIMIT);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in.store(true);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.q, (g.Ho + g.R - 1) / g.R, (g.N + g.nb - 1) / g.nb);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.q;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// the weight maps: (rows, K) row-major s8 in boxes of (bn rows, 128 bytes)
inline bool weight_map(CUtensorMap* map, const void* w, int rows, int k, int bn) {
  return qt::aligned16(w) && qtconv::matrix_map(map, w, rows, k, bn, KB);
}

template <int BN, int S, bool DS, int STOP>
int launch_bottleneck_bn(const void* x, const void* w1, const void* w2, const void* w3, const void* wd, void* out,
                         const BlockGeom& g, const BlockEpi& e, int smem, void* stream) {
  static std::atomic<bool> opted_in{false};
  CUtensorMap t1, t2, t3, td;
  if (!weight_map(&t1, w1, g.Cm, g.C, BN) || !weight_map(&t2, w2, g.Cm, 9 * g.Cm, BN))
    return static_cast<int>(cudaErrorInvalidValue);
  t3 = t1;  // the probes stop before conv3 and run no shortcut
  td = t1;
  if (STOP == 0 && !weight_map(&t3, w3, g.Cout, g.Cm, BN)) return static_cast<int>(cudaErrorInvalidValue);
  if (DS && !weight_map(&td, wd, g.Cout, g.C, BN)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_cluster(bottleneck_sm90_kernel<BN, S, DS, STOP>, opted_in, g, smem, stream, t1, t2, t3, td,
                        static_cast<const int8_t*>(x), static_cast<int8_t*>(out), g, e);
}

// B3 (STOP 0) or a probe (STOP 1, 2) on the mainloop under plan p (R in g);
// 0 or the CUDA error
template <int S, bool DS, int STOP>
int launch_bottleneck_sm90(const void* x, const void* w1, const void* w2, const void* w3, const void* wd, void* out,
                           BlockGeom g, const BlockEpi& e, const BlockPlan& p, void* stream) {
  g.Ho = g.H / S;
  g.Wo = g.W / S;
  g.HR = (g.R - 1) * S + 3;
  g.WP = g.W + 2;
  g.P = g.Cm + 16;
  g.q = p.q;
  g.nb = p.nb;
  g.stages = p.stages;
  if (g.N < 1 || g.C % 16 || g.Cm % 16 || g.H % S || g.W % S || !qt::aligned16(x) || !qt::aligned16(out) ||
      !plan_ok(g, p, g.R * g.Wo))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (p.bn) {
    case 16: return launch_bottleneck_bn<16, S, DS, STOP>(x, w1, w2, w3, wd, out, g, e, p.smem, stream);
    case 32: return launch_bottleneck_bn<32, S, DS, STOP>(x, w1, w2, w3, wd, out, g, e, p.smem, stream);
    default: return launch_bottleneck_bn<64, S, DS, STOP>(x, w1, w2, w3, wd, out, g, e, p.smem, stream);
  }
}

template <int BN, int S, bool DS>
int launch_basic_bn(const void* x, const void* w1, const void* w2, const void* wd, void* out, const BlockGeom& g,
                    const BlockEpi& e, int smem, void* stream) {
  static std::atomic<bool> opted_in{false};
  CUtensorMap t1, t2, td;
  if (!weight_map(&t1, w1, g.Cm, 9 * g.C, BN) || !weight_map(&t2, w2, g.Cm, 9 * g.Cm, BN))
    return static_cast<int>(cudaErrorInvalidValue);
  td = t1;
  if (DS && !weight_map(&td, wd, g.Cm, g.C, BN)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_cluster(basic_sm90_kernel<BN, S, DS>, opted_in, g, smem, stream, t1, t2, td,
                        static_cast<const int8_t*>(x), static_cast<int8_t*>(out), g, e);
}

// B4 on the mainloop under plan p (R in g); 0 or the CUDA error
template <int S, bool DS>
int launch_basic_sm90(const void* x, const void* w1, const void* w2, const void* wd, void* out, BlockGeom g,
                      const BlockEpi& e, const BlockPlan& p, void* stream) {
  g.Cout = g.Cm;
  g.Ho = g.H / S;
  g.Wo = g.W / S;
  g.HR = g.R + 2;
  g.WP = g.Wo + 2;
  g.P = g.Cm + 16;
  g.q = p.q;
  g.nb = p.nb;
  g.stages = p.stages;
  if (g.N < 1 || g.C % 16 || g.Cm % 16 || g.H % S || g.W % S || (!DS && g.C != g.Cm) || !qt::aligned16(x) ||
      !qt::aligned16(out) || !plan_ok(g, p, 0))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (p.bn) {
    case 16: return launch_basic_bn<16, S, DS>(x, w1, w2, wd, out, g, e, p.smem, stream);
    case 32: return launch_basic_bn<32, S, DS>(x, w1, w2, wd, out, g, e, p.smem, stream);
    default: return launch_basic_bn<64, S, DS>(x, w1, w2, wd, out, g, e, p.smem, stream);
  }
}

}  // namespace
}  // namespace qtblock
