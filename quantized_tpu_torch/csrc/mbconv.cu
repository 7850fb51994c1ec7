// The MBConv kernels of the port's EfficientNet engine
// (engine/int8_efficientnet.py): the depthwise conv with its SiLU epilogue
// and the squeeze's sums, the squeeze's mean onto the SE reduce conv's grid,
// and the gate pass. Port-only: the JAX package has no EfficientNet, so no
// Pallas kernel stands behind them.
//
// Depthwise (qt_dw_conv): x NHWC s8 (stored u - 128) over C % 16 == 0
// channels, a k x k kernel (k 3 or 5) at stride 1 or 2, padded k // 2 on
// every side with the stored zero point;
//   acc[n, ho, wo, c] = sum_taps x[n, ho*s - p + dy, wo*s - p + dx, c] * w[dy, dx, c]
//   y = act(acc * alpha[c] + beta[c]);  q = clip(rint(y * inv + zps), -128, 127) -> s8
// and, for the squeeze, sums[n, c] = sum over (ho, wo) of q, exact in int32.
// What bounds it on the H100: a depthwise conv does 2 * k * k operations a
// byte it writes, far below the int8 tensor cores' rate per byte, so it is
// bound by memory and by its instruction issue, which the SiLU's expf and
// division take much of. A thread carries 4 channels (one 4-byte word) of
// two neighbouring output pixels of a row and walks the pairs of its
// block's band; neighbouring threads take neighbouring words, so a warp's
// loads are 128 contiguous bytes, and a thread needs few registers, so the
// SMs hold many warps to hide the loads' latency (a first form, 16 channels
// of one pixel a thread in 146 registers, ran one block of 8 warps an SM
// and took 2.5 ms a batch of 128 over B0's 16 convs on an H100, this one
// 1.3 ms). The two pixels share
// their input columns, loaded once a row (k + s words, not 2k), as they
// share the weights. The taps go four at a time through __dp4a: four taps'
// words are transposed (8 byte permutes) into one word of four taps a
// channel, against the weights packed the same way on the host
// (ops.mbconv.dw_weight_words, by the groups of ops.mbconv.dw_tap_groups).
// The input's reuse across rows is left to L1. The squeeze's sums go
// through shared memory, one atomic add a channel a block, into a buffer
// this entry zeroes first.
//
// Squeeze (qt_se_squeeze): mean[n, c] = f32(sums + HW * (128 - zp)) * scale / HW,
// the mean of the stored depthwise output on its grid, then onto the reduce
// conv's grid: q = clip(rint(mean * inv + zps), -128, 127).
//
// Gate pass (qt_se_gate): the gate g (N, C) f32 scales the depthwise output
// onto the project conv's grid: q = clip(rint(((x + off) * scale * g[n, c]) * inv
// + zps), -128, 127), off = f32(128 - zp).
//
// Every epilogue rounds once per operation (__fmul_rn, __fadd_rn, __fdiv_rn,
// the accurate expf; the build passes -fmad=false), in the order of the
// plain versions in ops/mbconv.py, so the s8 outputs agree with them bit for
// bit wherever expf agrees with the host's exp.

#include "int8_mma.cuh"

namespace {

constexpr int CPT = 4;            // channels a depthwise thread carries: one 4-byte word
constexpr int VEC = 16;           // channels a gate-pass thread carries: one 16-byte load
constexpr int DW_THREADS = 256;   // threads a block, at most

struct DwArgs {
  const int8_t* x;
  const int* wq;  // (groups, C): group j's four taps of channel c in word [j, c] (ops.mbconv.dw_tap_groups)
  const float* alpha;
  const float* beta;
  int8_t* out;
  int* sums;  // (N, C) int32
  int H, W, C, Ho, Wo, pad, stored_zp, act;
  float inv, zps;
  int band;  // output pixel pairs a block
};

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// A 4 x 4 byte transpose: t[i] = (a.byte i, b.byte i, c.byte i, d.byte i)
__device__ __forceinline__ void transpose4(uint32_t a, uint32_t b, uint32_t c, uint32_t d, uint32_t (&t)[4]) {
  const uint32_t ab_lo = __byte_perm(a, b, 0x5140), ab_hi = __byte_perm(a, b, 0x7362);
  const uint32_t cd_lo = __byte_perm(c, d, 0x5140), cd_hi = __byte_perm(c, d, 0x7362);
  t[0] = __byte_perm(ab_lo, cd_lo, 0x5410);
  t[1] = __byte_perm(ab_lo, cd_lo, 0x7632);
  t[2] = __byte_perm(ab_hi, cd_hi, 0x5410);
  t[3] = __byte_perm(ab_hi, cd_hi, 0x7632);
}

// Four taps' words transposed into four channels' words, against a weight
// word of four taps a channel: acc[e] += the four products of channel e.
__device__ __forceinline__ void dot4(uint32_t x0, uint32_t x1, uint32_t x2, uint32_t x3, const uint4& w,
                                     int (&acc)[CPT]) {
  uint32_t t[4];
  transpose4(x0, x1, x2, x3, t);
  acc[0] = __dp4a(static_cast<int>(t[0]), static_cast<int>(w.x), acc[0]);
  acc[1] = __dp4a(static_cast<int>(t[1]), static_cast<int>(w.y), acc[1]);
  acc[2] = __dp4a(static_cast<int>(t[2]), static_cast<int>(w.z), acc[2]);
  acc[3] = __dp4a(static_cast<int>(t[3]), static_cast<int>(w.w), acc[3]);
}

// Grid (bands, channel chunks, N), block (bx channel words, by lanes of
// output pixel pairs). A thread computes two neighbouring output pixels of
// a row from the NC = S + K input columns they share, row by row. The tap
// groups (ops.mbconv.dw_tap_groups): k 3, one a row (its 3 taps and a zero
// weight); k 5, one a row of its first 4 taps, then column 4 of rows 0-3,
// then tap (4, 4) with three zero weights.
template <int K, int S>
__global__ void __launch_bounds__(DW_THREADS) dw_kernel(const DwArgs a) {
  constexpr int NC = S + K;
  extern __shared__ int red[];  // by x bx x CPT partial sums
  const int tx = threadIdx.x, ty = threadIdx.y, bx = blockDim.x, by = blockDim.y;
  const int n = blockIdx.z, c0 = (blockIdx.y * bx + tx) * CPT;
  const int pairs = (a.Wo + 1) / 2, items = a.Ho * pairs;
  const int p0 = blockIdx.x * a.band, p1 = min(items, p0 + a.band);
  int sum[CPT] = {0, 0, 0, 0};
  if (c0 < a.C) {
    const float4 a4 = __ldg(reinterpret_cast<const float4*>(a.alpha + c0));
    const float4 b4 = __ldg(reinterpret_cast<const float4*>(a.beta + c0));
    const float al[CPT] = {a4.x, a4.y, a4.z, a4.w}, be[CPT] = {b4.x, b4.y, b4.z, b4.w};
    const uint32_t zpw = qt::zp_bytes(a.stored_zp);
    const long long row_pitch = static_cast<long long>(a.W) * a.C;
    const int8_t* xn = a.x + static_cast<long long>(n) * a.H * row_pitch + c0;
    const int* wq = a.wq + c0;
    uint32_t* on = reinterpret_cast<uint32_t*>(a.out + static_cast<size_t>(n) * a.Ho * a.Wo * a.C + c0);
    for (int p = p0 + ty; p < p1; p += by) {
      const int ho = p / pairs, wo = 2 * (p - ho * pairs);
      const int hi0 = ho * S - a.pad, wi0 = wo * S - a.pad;
      bool col_in[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) col_in[c] = static_cast<unsigned>(wi0 + c) < static_cast<unsigned>(a.W);
      const long long col0 = static_cast<long long>(wi0) * a.C;
      int acc[2][CPT] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
      uint32_t tail[2][4];  // k 5: column 4 of rows 0-3 of each output
#pragma unroll
      for (int r = 0; r < K; ++r) {
        const int hi = hi0 + r;
        const bool row_in = static_cast<unsigned>(hi) < static_cast<unsigned>(a.H);
        const long long row = hi * row_pitch + col0;  // offsets, dereferenced only inside the image
        uint32_t xr[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c)
          xr[c] = row_in && col_in[c] ? __ldg(reinterpret_cast<const uint32_t*>(xn + row + c * a.C)) : zpw;
        const uint4 w = __ldg(reinterpret_cast<const uint4*>(wq + static_cast<size_t>(r) * a.C));
#pragma unroll
        for (int o = 0; o < 2; ++o) {
          if constexpr (K == 3) {
            dot4(xr[o * S], xr[o * S + 1], xr[o * S + 2], zpw, w, acc[o]);
          } else {
            dot4(xr[o * S], xr[o * S + 1], xr[o * S + 2], xr[o * S + 3], w, acc[o]);
            if (r < 4) tail[o][r & 3] = xr[o * S + 4];
          }
        }
        if constexpr (K == 5) {
          if (r == 4) {
            const uint4 w6 = __ldg(reinterpret_cast<const uint4*>(wq + static_cast<size_t>(6) * a.C));
#pragma unroll
            for (int o = 0; o < 2; ++o) dot4(xr[o * S + 4], zpw, zpw, zpw, w6, acc[o]);
          }
        }
      }
      if constexpr (K == 5) {
        const uint4 w5 = __ldg(reinterpret_cast<const uint4*>(wq + static_cast<size_t>(5) * a.C));
#pragma unroll
        for (int o = 0; o < 2; ++o) dot4(tail[o][0], tail[o][1], tail[o][2], tail[o][3], w5, acc[o]);
      }
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        if (o == 1 && wo + 1 >= a.Wo) break;  // an odd width's last pair holds one pixel
        uint32_t packed = 0u;
#pragma unroll
        for (int e = 0; e < CPT; ++e) {
          const float y = qt::activate(__fadd_rn(__fmul_rn(static_cast<float>(acc[o][e]), al[e]), be[e]), a.act);
          const int q = min(max(__float2int_rn(__fadd_rn(__fmul_rn(y, a.inv), a.zps)), -128), 127);
          sum[e] += q;
          packed |= (static_cast<uint32_t>(q) & 0xFFu) << (8 * e);
        }
        on[(static_cast<size_t>(ho) * a.Wo + wo + o) * (a.C / CPT)] = packed;
      }
    }
  }
#pragma unroll
  for (int e = 0; e < CPT; ++e) red[(ty * bx + tx) * CPT + e] = sum[e];
  __syncthreads();
  for (int i = ty * bx + tx; i < bx * CPT; i += bx * by) {
    const int c = blockIdx.y * bx * CPT + i;
    if (c >= a.C) continue;
    int s = 0;
    for (int r = 0; r < by; ++r) s += red[r * bx * CPT + i];
    atomicAdd(a.sums + static_cast<size_t>(n) * a.C + c, s);
  }
}

__global__ void squeeze_kernel(const int* __restrict__ sums, int8_t* __restrict__ out, int total, int off,
                               float scale, float hw, float inv, float zps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const float mean = __fdiv_rn(__fmul_rn(static_cast<float>(sums[i] + off), scale), hw);
  out[i] = static_cast<int8_t>(min(max(__float2int_rn(__fadd_rn(__fmul_rn(mean, inv), zps)), -128), 127));
}

// One thread a 16-channel vector of one pixel: (N, HW, C / 16) of them.
__global__ void gate_kernel(const int8_t* __restrict__ x, const float* __restrict__ g, int8_t* __restrict__ out,
                            long long vecs, long long image_vecs, int C, float off, float scale, float inv,
                            float zps) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= vecs) return;
  const int n = static_cast<int>(i / image_vecs), c0 = static_cast<int>(i % (C / VEC)) * VEC;
  const uint4 xv = __ldg(reinterpret_cast<const uint4*>(x) + i);
  const float* gn = g + static_cast<size_t>(n) * C + c0;
  uint32_t packed[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < VEC; e += 4) {
    const float4 g4 = __ldg(reinterpret_cast<const float4*>(gn + e));
    const float ge[4] = {g4.x, g4.y, g4.z, g4.w};
    const uint32_t w = word(xv, e / 4);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float xs = static_cast<float>(static_cast<int8_t>(w >> (8 * k)));
      const float y = __fmul_rn(__fmul_rn(__fadd_rn(xs, off), scale), ge[k]);
      const int q = min(max(__float2int_rn(__fadd_rn(__fmul_rn(y, inv), zps)), -128), 127);
      packed[e / 4] |= (static_cast<uint32_t>(q) & 0xFFu) << (8 * k);
    }
  }
  reinterpret_cast<uint4*>(out)[i] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
}

template <int K, int S>
int launch_dw(const DwArgs& a, int N, int bands, int chunks, int bx, int by, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(bx) * by * CPT * sizeof(int);
  dw_kernel<K, S><<<dim3(bands, chunks, N), dim3(bx, by), smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (N, H, W, C) s8, wq (ceil(K*K / 4), C) int32 (ops.mbconv.dw_weight_words),
// alpha, beta (C,) f32, out (N, Ho, Wo, C) s8, sums (N, C) int32 (zeroed here);
// K 3 or 5, S 1 or 2, pad K / 2; act: the activation code (qt::activate);
// (bx, by, bands, chunks): the plan of ops.mbconv.dw_plan. C % 16 == 0 and
// 16-byte-aligned bases, or the call is refused.
extern "C" int qt_dw_conv(const void* x, const void* wq, const void* alpha, const void* beta, void* out, void* sums,
                          int N, int H, int W, int C, int K, int S, int pad, int Ho, int Wo, int stored_zp, int act,
                          float inv, float zps, int bx, int by, int bands, int chunks, void* stream) {
  const bool aligned = qt::aligned16(x) && qt::aligned16(wq) && qt::aligned16(alpha) && qt::aligned16(beta) &&
                       qt::aligned16(out) && sums != nullptr;
  if (C % VEC || !aligned || bx < 1 || by < 1 || bx * by > DW_THREADS || bands < 1 || chunks * bx * CPT < C ||
      (K != 3 && K != 5) || (S != 1 && S != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t rc = cudaMemsetAsync(sums, 0, static_cast<size_t>(N) * C * sizeof(int), st);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int items = Ho * ((Wo + 1) / 2);  // pairs of output pixels
  const DwArgs a{static_cast<const int8_t*>(x), static_cast<const int*>(wq), static_cast<const float*>(alpha),
                 static_cast<const float*>(beta), static_cast<int8_t*>(out), static_cast<int*>(sums),
                 H, W, C, Ho, Wo, pad, stored_zp, act, inv, zps, (items + bands - 1) / bands};
  if (K == 3)
    return S == 1 ? launch_dw<3, 1>(a, N, bands, chunks, bx, by, st) : launch_dw<3, 2>(a, N, bands, chunks, bx, by, st);
  return S == 1 ? launch_dw<5, 1>(a, N, bands, chunks, bx, by, st) : launch_dw<5, 2>(a, N, bands, chunks, bx, by, st);
}

// sums (N*C,) int32 -> out (N*C,) s8: off = HW * (128 - zp) of the summed
// grid, scale its step, hw = f32(HW); (inv, zps) the reduce conv's grid.
extern "C" int qt_se_squeeze(const void* sums, void* out, int total, int off, float scale, float hw, float inv,
                             float zps, void* stream) {
  squeeze_kernel<<<(total + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(sums), static_cast<int8_t*>(out), total, off, scale, hw, inv, zps);
  return static_cast<int>(cudaGetLastError());
}

// x (N, HW, C) s8 on (scale, zp), off = f32(128 - zp); g (N, C) f32; out
// (N, HW, C) s8 on (1/inv, zps + 128). C % 16 == 0 and 16-byte-aligned
// bases, or the call is refused.
extern "C" int qt_se_gate(const void* x, const void* g, void* out, int N, int HW, int C, float off, float scale,
                          float inv, float zps, void* stream) {
  if (C % VEC || !qt::aligned16(x) || !qt::aligned16(g) || !qt::aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long image_vecs = static_cast<long long>(HW) * (C / VEC), vecs = image_vecs * N;
  const int threads = 256;
  gate_kernel<<<static_cast<unsigned>((vecs + threads - 1) / threads), threads, 0,
                static_cast<cudaStream_t>(stream)>>>(static_cast<const int8_t*>(x), static_cast<const float*>(g),
                                                     static_cast<int8_t*>(out), vecs, image_vecs, C, off, scale,
                                                     inv, zps);
  return static_cast<int>(cudaGetLastError());
}
