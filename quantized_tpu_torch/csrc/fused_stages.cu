// The stage split of the fused bottleneck: B3's mainloop (block_sm90.cuh)
// stopped after conv1 or after conv2.
//
// Replaces the Pallas stage bodies k_conv1 and k_conv12 of
// bench/fused_probe.py (:66 and :75, behind _mk :45), which time the
// stages of the fused bottleneck at its layer1 geometry: (B, 56, 56, 256)
// s8 in and out, C = 256, Cm = 64.
//
//   h1  = clip(rint(acc1 * a), -128, 127)        conv1 1x1, a (Cm,), no bias
//   h2  = clip(rint(acc2 * a), -128, 127)        conv2 3x3 over h1, halo 0
//   out = h1 (stop 1) or h2 (stop 2), tiled C / Cm times across the channels
//
// They run the bottleneck's kernel itself, with b = 0 (rint(acc * a + 0)
// equals rint(acc * a)), the clip floor at -128, a halo of 0, and the stage's
// output copied out in place of the next stages. So the time of copy, conv1,
// conv12 and the full block on one input say which stage of B3 takes the
// time. What bounds them on the H100: the input and output bytes, 2 x 25.7
// MB at batch 32 (0.015 ms at 3.35 TB/s), over 3.3 (conv1) and 7.4 G
// (conv2) int8 operations.

// the stopped instances return before the later stages' loops, which nvcc
// then reports as unreachable (warning 128)
#pragma nv_diag_suppress 128

#include "block_sm90.cuh"

// stop 1: conv1; 2: conv1 then conv2. The plan of ops.block_plan (kind
// "bottleneck" at C = Cout), R its band.
extern "C" int qt_fused_stages(const void* x, const void* w1, const void* w2, const void* a, const void* zero,
                               void* out, int N, int H, int W, int C, int Cm, int stop, int R, int q, int nb,
                               int bn, int stages, int smem, void* stream) {
  const float* fa = static_cast<const float*>(a);
  const float* fz = static_cast<const float*>(zero);
  const qtblock::BlockEpi e{fa, fz, fa, fz, nullptr, nullptr, nullptr, nullptr, -128.0f, -128.0f,
                            0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0, 0};
  qtblock::BlockGeom g = {};
  g.N = N, g.H = H, g.W = W, g.C = C, g.Cm = Cm, g.Cout = C, g.R = R;
  const qtblock::BlockPlan p{q, nb, bn, stages, smem};
  if (stop == 1) return qtblock::launch_bottleneck_sm90<1, false, 1>(x, w1, w2, nullptr, nullptr, out, g, e, p, stream);
  if (stop == 2) return qtblock::launch_bottleneck_sm90<1, false, 2>(x, w1, w2, nullptr, nullptr, out, g, e, p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
