// B3 and B4: a whole int8 ResNet block in one kernel, on the Hopper block
// mainloop of block_sm90.cuh (wgmma on a TMA weight ring, clusters that
// split each stage's channels and share h1 and h2 through distributed
// shared memory), under the launch plan of ops.block_plan.
//
// ---- B3, the bottleneck (1x1 -> 3x3/S -> 1x1) ----
//
// Replaces the Pallas kernels _fused_bottleneck_kernel and
// _fused_bottleneck_ds_kernel (quantized_tpu/ops/fused_block.py:54 and :368,
// behind fused_bottleneck_s1 :116 and fused_bottleneck_ds :445). One
// template serves both: the identity block is the downsample block with
// stride 1 and the prescaled input in place of the shortcut conv.
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
// The Pallas kernels keep whole images in VMEM (up to 1.7 MB); a Hopper
// block has at most 227 KB of shared memory, so a cluster owns a band of
// output rows (or a few small images) and its blocks split the channels
// (block_sm90.cuh). Epilogues use __fmul_rn/__fadd_rn and rintf (the build
// passes -fmad=false): the kernels round exactly as their plain PyTorch
// versions.

#include "block_sm90.cuh"

// The C entries take the plan of ops.block_plan: R output rows a band,
// clusters of q blocks, nb images a cluster, wgmma N = bn, a ring of
// `stages` slots and `smem` bytes of dynamic shared memory.
#define QT_PLAN_ARGS int q, int nb, int bn, int stages, int smem

namespace {

qtblock::BlockGeom block_geom(int N, int H, int W, int C, int Cm, int Cout, int R) {
  qtblock::BlockGeom g = {};
  g.N = N, g.H = H, g.W = W, g.C = C, g.Cm = Cm, g.Cout = Cout, g.R = R;
  return g;
}

const float* f(const void* p) { return static_cast<const float*>(p); }

}  // namespace

// Identity block: Cout = C, stride 1, idq = x*id_k + id_c.
extern "C" int qt_fused_bottleneck_s1(const void* x, const void* w1, const void* w2, const void* w3,
                                      const void* a1, const void* b1, const void* a2, const void* b2,
                                      const void* a3, const void* b3, void* out, int N, int H, int W,
                                      int C, int Cm, int R, int zp2, float lo1, float lo2, float shift,
                                      float id_k, float id_c, QT_PLAN_ARGS, void* stream) {
  const qtblock::BlockEpi e{f(a1), f(b1), f(a2), f(b2), f(a3), f(b3), nullptr, nullptr,
                            lo1, lo2, shift, id_k, id_c, 0.0f, 0.0f, 0, zp2};
  return qtblock::launch_bottleneck_sm90<1, false, 0>(x, w1, w2, w3, nullptr, out, block_geom(N, H, W, C, Cm, C, R),
                                                      e, {q, nb, bn, stages, smem}, stream);
}

// Downsample block: stride 1 or 2, the 1x1/stride shortcut conv on x[::S, ::S].
extern "C" int qt_fused_bottleneck_ds(const void* x, const void* w1, const void* w2, const void* w3,
                                      const void* wd, const void* a1, const void* b1, const void* a2,
                                      const void* b2, const void* a3, const void* b3, const void* ad,
                                      const void* bd, void* out, int N, int H, int W, int C, int Cm,
                                      int Cout, int stride, int R, int zp2, float lo1, float lo2,
                                      float shift, float fine, float inv_fine, QT_PLAN_ARGS, void* stream) {
  const qtblock::BlockEpi e{f(a1), f(b1), f(a2), f(b2), f(a3), f(b3), f(ad), f(bd),
                            lo1, lo2, shift, 0.0f, 0.0f, fine, inv_fine, 0, zp2};
  const qtblock::BlockGeom g = block_geom(N, H, W, C, Cm, Cout, R);
  const qtblock::BlockPlan p{q, nb, bn, stages, smem};
  if (stride == 1) return qtblock::launch_bottleneck_sm90<1, true, 0>(x, w1, w2, w3, wd, out, g, e, p, stream);
  if (stride == 2) return qtblock::launch_bottleneck_sm90<2, true, 0>(x, w1, w2, w3, wd, out, g, e, p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Identity BasicBlock: C == Cm, stride 1, idq = x*id_k + id_c.
extern "C" int qt_fused_basicblock_s1(const void* x, const void* w1, const void* w2, const void* a1,
                                      const void* b1, const void* a2, const void* b2, void* out, int N,
                                      int H, int W, int C, int Cm, int R, int zp1, int zp2, float lo1,
                                      float shift, float id_k, float id_c, QT_PLAN_ARGS, void* stream) {
  const qtblock::BlockEpi e{f(a1), f(b1), f(a2), f(b2), nullptr, nullptr, nullptr, nullptr,
                            lo1, 0.0f, shift, id_k, id_c, 0.0f, 0.0f, zp1, zp2};
  return qtblock::launch_basic_sm90<1, false>(x, w1, w2, nullptr, out, block_geom(N, H, W, C, Cm, Cm, R), e,
                                              {q, nb, bn, stages, smem}, stream);
}

// Downsample BasicBlock: stride 1 or 2, the 1x1/stride shortcut conv on x[::S, ::S].
extern "C" int qt_fused_basicblock_ds(const void* x, const void* w1, const void* w2, const void* wd,
                                      const void* a1, const void* b1, const void* a2, const void* b2,
                                      const void* ad, const void* bd, void* out, int N, int H, int W,
                                      int C, int Cm, int stride, int R, int zp1, int zp2, float lo1,
                                      float shift, float fine, float inv_fine, QT_PLAN_ARGS, void* stream) {
  const qtblock::BlockEpi e{f(a1), f(b1), f(a2), f(b2), nullptr, nullptr, f(ad), f(bd),
                            lo1, 0.0f, shift, 0.0f, 0.0f, fine, inv_fine, zp1, zp2};
  const qtblock::BlockGeom g = block_geom(N, H, W, C, Cm, Cm, R);
  const qtblock::BlockPlan p{q, nb, bn, stages, smem};
  if (stride == 1) return qtblock::launch_basic_sm90<1, true>(x, w1, w2, wd, out, g, e, p, stream);
  if (stride == 2) return qtblock::launch_basic_sm90<2, true>(x, w1, w2, wd, out, g, e, p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
