#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``quantized_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA GPU and the CUDA toolkit (nvcc); the kernels are built from
``quantized_tpu_torch/csrc`` at first use. Without a GPU, or without the
package beside it, it exits non-zero before printing any result.

Phases, each printed as it runs; any failure ends the run with an exception
and a non-zero exit:

1. device: the GPU's name, and its name and power limit from nvidia-smi,
   then the predictions this run tests (``PREDICTIONS``);
2. build: one nvcc per CUDA source, all started together;
3. kernels: each kernel against its plain PyTorch version on the same GPU
   tensors, at the shapes the serving paths give it (batch 32): int8
   outputs must be equal, f32 outputs within F32_ATOL; then each one's
   device time (CUDA events, the L2 flushed and the host's launch hidden
   behind a sleep kernel), its time between CUDA events with the host's
   launch time in it (``event_ms``), its plain version's device time, the
   device time of one PyTorch call computing the same integer product where
   there is one (``torch._int_mm`` for K1 and for K2's 1x1 stride-1 case, a
   yardstick only; the port never calls it) and the least time the card
   could take (the bytes the function must move over 3.35 TB/s or its int8
   operations over 1979 TOP/s, whichever is larger: ``bound_ms`` of
   ``probes/gemm_sweep.py``). The fused bottleneck
   kernels (B3) run at seven of ResNet-50's block shapes (layer1-4, the
   layer3 blocks included), the fused BasicBlock kernels (B4) at
   ResNet-18's and CIFAR ResNet-20's, each on the Hopper mainloop (route
   "sm90", asserted) with its launch plan (``block_plan``: cluster, images
   a cluster, band, job width, ring stages, shared memory) and its
   instance's ptxas line printed first; the stage probes of B3
   (``fused_stages_conv1`` and ``_conv12``, ``bench/fused_probe.py``'s
   ``k_conv1`` and ``k_conv12``) at (32, 56, 56, 256), C 256, Cm 64; the fused
   depthwise-separable kernel (B5) at MobileNet-v1's eight distinct pair
   shapes (pairs 0-5, 6-10 and 11) and at width 0.75's and 0.25's pair 0
   (C = 24 and 8), each with its launch plan (``dw_pw_plan``: route, cluster
   size, tile, shared memory, clusters) and its instance's ptxas line, the
   route asserted: the Hopper route ("sm90") everywhere, C 24 and 8
   computed as 32 and 16 (at both narrow pairs, batches 32 and 128, the
   call's time beside the tile kernel's on the same inputs and, on a line of
   its own, the time a pad of x to 32 or 16 channels would add); K2's gather-K form at
   the s2d stem, MobileNet's stem at widths 1.0 and 0.75 (3x3/s2 over Cin =
   3), AlexNet's conv1 (11x11/s4 over Cin = 3), the CIFAR stem and CIFAR's
   3x3 convs over Cin 16 and 32 (strides 1 and 2), each on its Hopper route
   ("sm90", asserted), its per-tap form also at AlexNet's conv2 (5x5/p2,
   64->192) and at 1x1 convs over Cin 24, 8 and 9, each case with its
   launch plan (``conv_plan``), its ptxas line and the route it took: the
   Hopper mainloop ("sm90") for the per-tap form over Cin % 16 == 0 and for
   the 1x1s over Cin 24 and 8 (MobileNet-v1's first pointwise conv at widths
   0.75 and 0.25) on groups of four pixels, asserted, each beside the
   general tile's time on the same inputs (the route they took before) and
   ``torch._int_mm``'s; the general tile for Cin 9; no PyTorch call
   computes a fused block or pair. K1's f32 form also runs at AlexNet's fc1-3 at
   batches 1, 8, 32 and 128, and the int4 GEMM (B6) there too, f32 and
   requant forms; B6's yardstick is ``torch._int_mm`` on the unpacked int8
   weights (which refuses M <= 16: ``library_ms`` is then None), and K1's
   time on the same unpacked product at batch 32 is printed beside it
   (``int8_matmul_ms``); these products and their bytes come from
   ``probes/gemm_sweep.py``. Before each K1 and B6 row its launch plan
   (``gemm_plan``: tile width, split and cluster, stages, shared memory,
   blocks, TMA or general tile) is printed with its kernel instance's
   ptxas line from this run's build. The
   flat-row conv (B7) runs at ResNet-50's four stride-1 3x3 shapes and a
   1x1 (``torch._int_mm`` its yardstick), each on the mainloop, K2's time on the same inputs
   beside it (``int8_conv_direct_ms``; the bound counts K2's work, not B7's
   junk columns); K2's residual form (B8) at ResNet-18's conv2 + identity
   (layer1 and layer3), f32 and s8 out, on the mainloop's RES instances
   (route "sm90", asserted), each beside K2 on the same inputs without the
   residual and the general tile on the same inputs; the copy kernels (B9) on the
   (32, 56, 56, 256) layer1 activation, ``Tensor.copy_`` their yardstick
   and 2 x its bytes their bound, ``grid_copy``, ``ring_copy`` and
   ``bulk_copy`` on their Hopper route ("sm90", asserted) with their plans
   (``copy_plan``, ``ring_plan``, ``bulk_plan``) printed. B3 and B4 also run at C = 24 (Cm 16 and 24,
   Cout 32 and 40, strides 1 and 2), which their wrappers pad to multiples
   of 16, each equal to its plain version. The CLIP instances of K2 and K1
   (the RangeBN observer clamp, ``y_clip``) run at the RangeBN ResNet-50's
   shapes: K2's 3x3 s1 64 (s8) and 1x1 64->256 (f32 and s8) on the
   mainloop, the s2d stem on the gather-K route, K1's im2col requant and a
   1x1 f32 im2col product, each equal to its plain version with the clamp,
   on route "sm90+clip" (asserted), and timed beside the unclamped instance
   on the same inputs;
4. the op paths, each with the launch counts set to 0 just before and read
   just after: "conv sweep", the per-shape sweep of ``probes/sweep_conv``
   over ResNet-50's 24 conv shapes at batch 32 on K2, B7 and im2col + K1
   (B7 refuses exactly the 7 stride-2 shapes; every K2 per-tap and B7
   launch on the mainloop), then ``torch._int_mm`` on its 1x1 stride-1
   shapes (a yardstick, no kernel of the port); "conv ops", B8 through
   ``int8_conv_direct(..., residual=, res_grid=)`` (2 launches, both on the
   mainloop, equal to its plain version), then a grouped conv of 2 groups (``int8_conv_xla``,
   plain PyTorch) against its CPU twin; "copy probe", every variant of
   ``probes/dma_ring`` checked exact, then timed, every ``grid_copy``,
   ``ring_copy`` and ``bulk_copy`` launch on the Hopper route; "fused stages", ``probes/fused_stages``:
   copy, conv1, conv12 and the full identity block on one (32, 56, 56,
   256) input, each equal to its plain version, then timed (which stage of
   B3 takes the time);
5. the serving paths, each through the entry points a user calls
   (``_calibrated_model`` from a seeded generator, ``build_int8_resident(...,
   backend="pallas")`` or ``build_int8_mobilenet``, ``IntExecutor(...,
   ingest="u8")``, then ``fuse_resident_blocks`` or
   ``fuse_mobilenet_blocks``), each answering 3 requests of 32 uint8 images
   with the launch counts set to 0 just before and read just after; every
   kernel must launch exactly the stated number of times per forward, and
   every K2 per-tap launch takes the mainloop (at width 0.75 the first
   pointwise conv, over Cin 24, on groups of four pixels), every B3 and B4 launch
   takes the Hopper mainloop, every gather-K launch its Hopper route, and
   every B5 launch its Hopper route (at width 0.75 the first pair's C = 24
   computed as 32):
   - ResNet-50 (ImageNet geometry, 224x224, layers [3, 4, 6, 3], 1000
     classes): unfused, 52 K2 per-tap (48 block convs, 4 downsamples), 1 K2
     gather-K (the space-to-depth stem) and 1 K1 (the fc); the "gemm"
     backend, 33 K1 requant and 21 K1 f32 on 2 images; fused (15 blocks), 11
     ``fused_bottleneck_s1``, 4 ``fused_bottleneck_ds``, 3 K2 per-tap (the
     last block), 1 K2 gather-K and 1 K1;
   - ResNet-18 (ImageNet geometry, 224x224, layers [2, 2, 2, 2], 1000
     classes): unfused, 19 K2 per-tap (16 block convs, 3 downsamples), 1 K2
     gather-K and 1 K1; fused (7 blocks), 4 ``fused_basicblock_s1``, 3
     ``fused_basicblock_ds``, 2 K2 per-tap, 1 K2 gather-K and 1 K1;
   - CIFAR ResNet-20 (32x32, 16/32/64 channels, 10 classes): unfused, 14 K2
     gather-K (the stem over Cin = 3 and the 13 block convs over Cin 16 or
     32) and 7 K2 per-tap (5 block convs over Cin 64, 2 downsamples) and 1
     K1; fused (8 blocks), 6 ``fused_basicblock_s1``, 2
     ``fused_basicblock_ds``, 2 K2 per-tap, 1 K2 gather-K and 1 K1;
   - MobileNet-v1 (224x224, width 1.0, 1000 classes; its observers set by
     two observer-update passes on seeded images, since a random-init
     MobileNet's activations vanish within four convs of frozen [-4, 4]
     grids): unfused, 13 K2 per-tap (the pointwise convs), 1 K2 gather-K
     (the stem) and 1 K1, the 13 depthwise convs on the plain grouped path;
     fused (12 pairs), 12 ``fused_dw_pw``, 1 K2 per-tap (the last pointwise
     conv, f32 out), 1 K2 gather-K and 1 K1; the same plans at width 0.75,
     whose stem, first depthwise conv, first pointwise conv and first pair
     run over C = 24;
   - AlexNet-OWT-BN (224x224, 1000 classes, observers frozen at [-4, 4];
     every 7th BN scale of bn1, bn2 and bn5 negated, so the min-pool dual
     runs): int8 (``build_int8_alexnet``), 4 K2 per-tap (conv2-5), 1 K2
     gather-K (conv1, 11x11/s4 over Cin = 3) and 3 K1 (fc1-3); int4
     weight-only (``weight_bits=4``), the same convs (conv2-5 unpacking
     their packed bytes on each call) and 3 ``int4_matmul`` (fc1-3), no K1;
     each layer's count of distinct output values is printed, and none may
     be constant;
   - ResNet-50 int4 weight-only (``build_int8_resident(...,
     weight_bits=4)``): 52 K2 per-tap, 1 K2 gather-K, 1 K1 (the fc stays
     int8 storage); ``fuse_resident_blocks`` fuses 0 blocks of it;
   - "resnet50 rangebn": the RangeBN ResNet-50 (``resnet_quantized``,
     ImageNet, depth 50) from seed 0, two train-mode passes on seeded
     images on the CPU, its RangeBN input observers then narrowed to 40% so
     the clamp binds: 52 K2 per-tap, 1 gather-K and 1 K1, every conv launch
     on a CLIP instance ("sm90+clip"), the fc on "sm90"; its logits move when
     the clamps are removed, and ``fuse_resident_blocks`` fuses 0 of its
     blocks; the same engine on "gemm" (33 K1 requant, 21 K1 f32, all but
     the fc clamped) block by block within 1 step of "pallas";
     ``convert_to_int(backend="pallas")`` (K2's clamped f32 form, the raw
     stem on the gather-K route) against its CPU twin; the strict engine
     (``convert_to_int_strict``, plain PyTorch) on a batch of 8, its first 2
     logits within 2 fc steps of its CPU twin's.
   Each engine is held on 2 of the images against the same engine built on
   the CPU (plain versions): int8 stages equal, logits within F32_ATOL of
   their magnitude. The gemm and fused engines are also held, block by
   block (or pair by pair) on shared inputs, against the unfused GPU
   engine: int8 within 1 step on under 1% of a block, logits within
   LOGIT_ATOL (the fused downsample blocks carry the int16 shortcut leg);
6. throughput: batch-128 uint8 224x224 forwards of ResNet-50 (unfused,
   fused, int4 and the RangeBN flavor unfused), ResNet-18 and MobileNet-v1 at widths 1.0 and 0.75
   (unfused and fused), and
   AlexNet int8 and int4 at batches 1, 8 and 128, timed with CUDA events in
   turns (a, b, b, a) per model and batch, a profile of where the device
   time goes and the peak memory of each, and the device time of each
   unfused MobileNet's 13 plain depthwise convs; the existing serving
   paths build their executors with ``graphs=False``, so their launch
   counts stay those of eager forwards;
7. graphs: every engine built so far (ResNet-50 unfused, fused, int4 and
   RangeBN, ResNet-18 and CIFAR ResNet-20 unfused and fused, both
   MobileNets fused, AlexNet int8 and int4 on uint8 ingest; the RangeBN
   ``convert_to_int`` and strict engines on f32) captured at batch 8 by
   ``IntExecutor(graphs=True)``: two replays bit-equal to the eager
   forward, every launch of the captured forward on its Hopper route
   ("sm90", or "sm90+clip" where the clamp rides), its capture time and
   pool printed; then AlexNet int8 and int4 at batches 1 and 8, graph
   against eager (CUDA events over 10 calls from device inputs, in turns,
   and a profile: kernel time and idle share);
8. autotune: ResNet-50 and MobileNet-v1 w1.0 at batch 128 (``bench.py``'s
   batch) built on "pallas", then ``engine.autotune_resident`` with every
   race on (conv backends, maxpool, stem, fc, blocks or pairs), measured
   afresh into a temporary cache, one printed line per race with every
   candidate's time; the tuned engine against the untuned one step by step
   (bit-equal where every conv kept K2's function, within 1 step on under
   1% where gemm or a fused kernel won, logits within 0.35 where a bf16
   form won, else LOGIT_ATOL); ``apply_cached_backends`` on a fresh engine
   (the same forms, bit-equal logits); one tuned forward with the launch
   counts set to 0 just before and read just after ("resnet50 autotuned",
   "mobilenet autotuned"), every launch on its Hopper route (each C entry
   runs the route its wrapper passes, or refuses the call); an engine with every
   conv on "bf16", logits within 0.35 and timed, and MobileNet's depthwise
   convs on it and on the plain grouped path;
   then the tuned, fused and unfused forwards (and ResNet-50's float twin,
   ``models.get_model("resnet")``, fp32 with TF32 off) timed in turns by
   ``engine.model_throughput``, img/s and the tuned/float ratio printed
   with the card's name and power limit; the phase's seconds;
9. serve batcher: the tuned ResNet-50 behind ``ContinuousBatcher``
   (uint8 ingest, buckets 1, 8, 32 and 128) at pipeline depths 1 and 4,
   once with an ``IntExecutor`` replaying one CUDA graph per bucket and
   once eager, with the launch counts set to 0 just before and read just
   after: 320 seeded requests in bursts of 1-128, submitted 12 times over,
   every answer bit-equal to an eager batch-1 forward of its image (within
   LOGIT_ATOL where a bf16 conv form serves), one graph per bucket, every
   captured launch on its Hopper route, one replay per served batch;
   ``stats()`` (latency p50/p95/p99, occupancy, stage means), img/s, the
   pinned slots' memory, each bucket's capture time and pool; then one
   journaled pass (not timed: the journal fsyncs every request), three
   ``/predict`` requests through ``_start_http`` on 127.0.0.1 (the eager
   top-5) and the journal replayed into a fresh batcher (the same answers);
10. mesh: the float-BN ResNet-50 on "pallas" and the tuned one, saved
   for ``quantized_tpu_torch.probes.mesh_ranks``, started on every GPU
   (``torch.cuda.device_count()`` ranks, torchrun's variables, NCCL: one
   rank on one card): each rank checks an all-gather, a reduce-scatter and
   an all-reduce over both mesh axes, runs ``IntExecutor(mesh=...)`` once
   eagerly (launches by kernel and route and collectives a forward counted,
   the launches equal to the single-device forward's) and then with one
   CUDA graph per shape, the NCCL collectives captured in it (every
   captured launch on its Hopper route), its logits at batch 128 bit-equal
   to the single-device executor's, the two timed in turns, and serves the
   backlog's 320 requests through ``serve_multihost`` over the tuned engine
   at buckets 1, 8, 32 and 128 (each answer bit-equal to a batch-1
   forward; p50 and p99 printed with the card); no fallback to gloo, eager
   or the CPU. Then the shards in turn: at model degrees 2 and 4 every
   sharded conv and the fc of the "pallas" engine (layer4's convs are the
   explicit-TP stage) run shard by shard on the card on one forward's
   inputs at batch 32, the shards' outputs concatenated bit-equal to the
   whole layer, each layer's routes printed (a shard off the Hopper route
   named), and the explicit-TP fc head's K blocks, their int32 partials
   summed as its reduce-scatter sums them, bit-equal to the whole fc;
11. cli: ``quantized_tpu_torch.cli.main.main`` in-process on ResNet-50
   (``resnet_quantized_float_bn``, ImageNet, depth 50) with ``--calibrate
   2 --convert-int --resident -b 128``: ``-e`` over the synthetic
   stand-in's 512 images (top-1 and top-5 printed), then ``--serve
   --serve-steps 20 --serve-u8 --serve-pipeline 4``; both return 0;
12. train: QAT on the card, no kernel of the port launched in training
   (the counts set to 0 just before each training run and read after):
   the flagship ``resnet_quantized`` (ImageNet ResNet-50, 8-bit gradients
   and bi-precision) through ``Trainer`` for 6 SGD steps (lr 0.01,
   momentum 0.9) at batch 64 on the synthetic ImageNet stand-in, every
   parameter moved and finite, the observers' and RangeBN's statistics
   moved, every grad-quant stream advanced by 6, the loss lower over a
   second pass; ResNet-50 train steps at batch 128 through
   ``probes/train_step`` (float-BN f32 and bf16, the flagship full,
   ``nobiprec`` and ``nogradq``): device ms, ms between events with the
   host's launches, img/s, peak memory, and the profiler's kernel ms, idle
   share and launches a step, and the library's convs and products against
   the elementwise passes and reductions; one SGD step of CIFAR ResNet-20
   (the float ``resnet`` and the float-BN model) at batch 32 on the card
   against its CPU twin (the loss, every parameter and buffer, within
   ``TRAIN_PARITY_TOL``); the trained
   float-BN ResNet-50 and the trained flagship converted by
   ``build_int8_resident(..., backend="pallas")`` and served 3 requests of
   32 ("train float-bn serve": every K1 and K2 launch on "sm90"; "train
   flagship serve": every conv on "sm90+clip"), stage by stage against
   their CPU twins; then ``python -m quantized_tpu_torch.cli.main --model
   mnist --dataset mnist -b 32 --epochs 1`` in three processes at once,
   plain and twice ``--deterministic --seed 7``: each exits 0 with its
   ``results.csv`` and checkpoint, the two deterministic files equal;
13. the card's nvidia-smi line, then the kernels line: one JSON object with
   each kernel's numbers; ``launches`` is the count on the path that runs
   the kernel (``path``: a serving path's 3 forwards, or an op path),
   ``launches_autotuned`` its count in one tuned forward of each model,
   ``launches_rangebn`` on the RangeBN path's 3 forwards,
   ``launches_mesh`` in one forward of the "pallas" engine over the mesh
   on rank 0, and ``clip`` (K1, K2) its CLIP instances' numbers beside the
   unclamped instance's;
14. last line: ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent
SERVE_BATCH = 32
SERVE_REQUESTS = 3
THROUGHPUT_BATCH = 128
F32_ATOL = 1e-3  # f32 outputs against their plain versions, and GPU logits against CPU ones
LOGIT_ATOL = 0.25  # gemm or fused against pallas: they round their requant in another order

# name: (registered model, its config, image side, classes)
MODELS = {
    "resnet50": ("resnet_quantized_float_bn", dict(dataset="imagenet", depth=50), 224, 1000),
    "resnet18": ("resnet_quantized_float_bn", dict(dataset="imagenet", depth=18), 224, 1000),
    "cifar20": ("resnet_quantized_float_bn", dict(dataset="cifar10", depth=20), 32, 10),
    "mobilenet": ("mobilenet_quantized", dict(num_classes=1000, width_mult=1.0), 224, 1000),
    # C = 24 at the first pair: K2's per-tap form on groups of four pixels, B5 computing at C = 32
    "mobilenet w0.75": ("mobilenet_quantized", dict(num_classes=1000, width_mult=0.75), 224, 1000),
    "alexnet": ("alexnet_quantized", dict(num_classes=1000), 224, 1000),
    # the reference's own flavor, RangeBN: every conv carries the folded observer clamp
    "resnet50 rangebn": ("resnet_quantized", dict(dataset="imagenet", depth=50), 224, 1000),
}
# launches per forward of each path (every kernel not named: 0), and the
# blocks (or MobileNet pairs) that fusing fuses
PLANS = {
    "resnet50": ({"int8_conv_direct": 52, "int8_conv_direct_gatherk": 1, "int8_matmul": 1},
                 {"fused_bottleneck_s1": 11, "fused_bottleneck_ds": 4, "int8_conv_direct": 3,
                  "int8_conv_direct_gatherk": 1, "int8_matmul": 1}, 15),
    "resnet18": ({"int8_conv_direct": 19, "int8_conv_direct_gatherk": 1, "int8_matmul": 1},
                 {"fused_basicblock_s1": 4, "fused_basicblock_ds": 3, "int8_conv_direct": 2,
                  "int8_conv_direct_gatherk": 1, "int8_matmul": 1}, 7),
    "cifar20": ({"int8_conv_direct": 7, "int8_conv_direct_gatherk": 14, "int8_matmul": 1},
                {"fused_basicblock_s1": 6, "fused_basicblock_ds": 2, "int8_conv_direct": 2,
                 "int8_conv_direct_gatherk": 1, "int8_matmul": 1}, 8),
    "mobilenet": ({"int8_conv_direct": 13, "int8_conv_direct_gatherk": 1, "int8_matmul": 1},
                  {"fused_dw_pw": 12, "int8_conv_direct": 1, "int8_conv_direct_gatherk": 1,
                   "int8_matmul": 1}, 12),
}
PLANS["mobilenet w0.75"] = PLANS["mobilenet"]
GEMM_PLAN = {"int8_matmul_requant": 33, "int8_matmul": 21}  # ResNet-50 on the "gemm" backend
# AlexNet (int8 and int4 weights) and the int4 ResNet-50, launches per forward
ALEXNET_PLANS = {8: {"int8_conv_direct": 4, "int8_conv_direct_gatherk": 1, "int8_matmul": 3},
                 4: {"int8_conv_direct": 4, "int8_conv_direct_gatherk": 1, "int4_matmul": 3}}
RESNET50_INT4_PLAN = {"int8_conv_direct": 52, "int8_conv_direct_gatherk": 1, "int8_matmul": 1}
# the RangeBN ResNet-50: its launches and routes per forward, every conv on a
# CLIP instance of its Hopper route (the fc carries no clamp)
RANGEBN_NARROW = 0.4  # its RangeBN input observers narrowed to 40% of their range, so the clamp binds
RANGEBN_ROUTES = {"int8_conv_direct": {"sm90+clip": 52}, "int8_conv_direct_gatherk": {"sm90+clip": 1},
                  "int8_matmul": {"sm90": 1}}
RANGEBN_GEMM_ROUTES = {"int8_matmul_requant": {"sm90+clip": 33}, "int8_matmul": {"sm90+clip": 20, "sm90": 1}}
RANGEBN_STRICT_BATCH = 8
ALEXNET_BATCHES = (1, 8, 128)  # the JAX package's small-batch int4 regime, and the throughput batch

KERNEL_INFO = {
    "int8_matmul": ("quantized_tpu_torch/csrc/int8_gemm.cu", "quantized_tpu/ops/int8_matmul.py:56"),
    "int8_matmul_requant": ("quantized_tpu_torch/csrc/int8_gemm.cu", "quantized_tpu/ops/int8_matmul.py:76"),
    "int8_conv_direct": ("quantized_tpu_torch/csrc/int8_conv.cu", "quantized_tpu/ops/int8_conv_pallas.py:57"),
    "int8_conv_direct_gatherk": ("quantized_tpu_torch/csrc/int8_conv.cu",
                                 "quantized_tpu/ops/int8_conv_pallas.py:106"),
    "fused_bottleneck_s1": ("quantized_tpu_torch/csrc/fused_block.cu", "quantized_tpu/ops/fused_block.py:54"),
    "fused_bottleneck_ds": ("quantized_tpu_torch/csrc/fused_block.cu", "quantized_tpu/ops/fused_block.py:368"),
    "fused_basicblock_s1": ("quantized_tpu_torch/csrc/fused_block.cu", "quantized_tpu/ops/fused_block.py:198"),
    "fused_basicblock_ds": ("quantized_tpu_torch/csrc/fused_block.cu", "quantized_tpu/ops/fused_block.py:537"),
    "fused_dw_pw": ("quantized_tpu_torch/csrc/fused_dw_pw.cu", "quantized_tpu/ops/fused_block.py:701"),
    "int4_matmul": ("quantized_tpu_torch/csrc/int4_gemm.cu", "quantized_tpu/ops/int4.py:180"),
    "int8_conv_flat": ("quantized_tpu_torch/csrc/int8_conv_flat.cu", "quantized_tpu/ops/int8_conv_pallas.py:189"),
    "int8_conv_direct_residual": ("quantized_tpu_torch/csrc/int8_conv.cu",
                                  "quantized_tpu/ops/int8_conv_pallas.py:147"),
    "grid_copy": ("quantized_tpu_torch/csrc/copy_probe.cu",
                  "bench/fused_probe.py:45, bench/dma_ring_probe.py:132, bench/dma_ring_probe3.py:89"),
    "ring_copy": ("quantized_tpu_torch/csrc/copy_probe.cu",
                  "bench/dma_ring_probe.py:103, bench/dma_ring_probe2.py:90, bench/dma_ring_probe3.py:164"),
    "bulk_copy": ("quantized_tpu_torch/csrc/copy_probe.cu", "bench/dma_ring_probe2.py:47, bench/dma_ring_probe3.py:185"),
    "fused_stages_conv1": ("quantized_tpu_torch/csrc/fused_stages.cu", "bench/fused_probe.py:66"),
    "fused_stages_conv12": ("quantized_tpu_torch/csrc/fused_stages.cu", "bench/fused_probe.py:75"),
}
# what this run should show, written before it ran; printed as it starts
PREDICTIONS = ("autotune phase, batch 128, as the first run of this tree measured it within 3%: 14 of ResNet-50's 15 "
               "fusable blocks 'fused' (layer4.0, the last downsample block, 'unfused': 0.37 against 0.64 ms), the "
               "stem 'raw-pallas', 7 of the 17 conv signatures on 'gemm' (1x1s), none on bf16, the fc 'pallas'; the "
               "tuned ResNet-50 about 7.5 ms (fused 7.9, unfused 17.9, float fp32 55.3: tuned/float about 7.3); "
               "MobileNet: the 9 depthwise signatures on 'bf16', all 12 pairs 'fused', tuned 2.3 ms (fused 2.9); "
               "the tuned ResNet-50's device idle share under 0.06; "
               "the float twin's BN and ReLU passes a third or more of its device time; "
               "train phase (ResNet-50, batch 128, as earlier runs of this tree measured it within 10%): float-BN f32 "
               "about 277 ms a step, bf16 185-216, the flagship 613-679, nobiprec 4-6% and nogradq about 25% under "
               "it; the card's step within TRAIN_PARITY_TOL of the CPU's; the phase 140-190 s; "
               "mesh phase (one rank, batch 128): mesh / single forward 1.10-1.20 on 'pallas' (54 all-gathers, "
               "each now one copy of a conv's output), under 1.03 autotuned; every shard at degrees 2 and 4 on "
               "the Hopper route; served p50 20-45 ms; the phase 10-30 s")
# the path whose launch counts the kernels line reports (default: resnet50 unfused)
KERNEL_PATH = {"int8_matmul_requant": "resnet50 gemm", "fused_bottleneck_s1": "resnet50 fused",
               "fused_bottleneck_ds": "resnet50 fused", "fused_basicblock_s1": "resnet18 fused",
               "fused_basicblock_ds": "resnet18 fused", "fused_dw_pw": "mobilenet fused",
               "int4_matmul": "alexnet int4 serve", "int8_conv_flat": "conv sweep",
               "int8_conv_direct_residual": "conv ops", "grid_copy": "copy probe", "ring_copy": "copy probe",
               "bulk_copy": "copy probe", "fused_stages_conv1": "fused stages", "fused_stages_conv12": "fused stages"}
OUR_KERNELS = ("int8_conv_kernel", "conv_sm90_kernel", "gatherk_sm90_kernel", "int8_matmul_kernel", "gemm_sm90_kernel",
               "bottleneck_sm90_kernel", "basic_sm90_kernel", "fused_dw_pw_kernel", "dw_pw_sm90_kernel",
               "int4_matmul_kernel", "int8_conv_flat_kernel", "grid_copy_kernel", "grid_copy_tma_kernel",
               "ring_copy_kernel", "bulk_copy_kernel")  # device kernel names
SWEEP_MODES = ("direct", "flat", "gemm")  # the conv sweep path: K2, B7 and im2col + K1
BLOCK_KERNELS = ("fused_bottleneck_s1", "fused_bottleneck_ds", "fused_basicblock_s1", "fused_basicblock_ds")
PATH_ROUTES = {}  # path: {kernel: {route: launches}} of the kernels with routes
SWEEP_TARGET_SECS = 0.02  # per timed loop of the sweep; the probe's own default is 1 s
COPY_TARGET_SECS = 0.05


def log(msg: str) -> None:
    print(msg, flush=True)


def require_environment():
    """The GPU and the package, or exit non-zero with nothing printed on stdout."""
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch sees no CUDA GPU; this script runs on one")
    if not (ROOT / "quantized_tpu_torch" / "csrc").is_dir():
        sys.exit("chip_smoke: quantized_tpu_torch/ is not beside this script; run it from a checkout")
    sys.path.insert(0, str(ROOT))


# ----------------------------------------------------------------- timing


def library_ms(timer, fn):
    """Time of the PyTorch yardstick, or None where this build refuses the
    call (the yardstick is not part of the port; its refusal is printed)."""
    try:
        fn()
    except RuntimeError as exc:
        log(f"[kernels] yardstick refused: {exc}")
        return None
    return timer.ms(fn)


def window_extent(size: int, out: int, k: int, stride: int, pad: int) -> int:
    """Input rows (or columns) that a conv's windows read: all of them when
    the windows cover the image, a share when a stride skips some (a 1x1
    stride-2 conv reads every other one)."""
    return len({o * stride - pad + t for o in range(out) for t in range(k)} & set(range(size)))


# ----------------------------------------------------------------- phases


def phase_device():
    name = torch.cuda.get_device_name(0)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} device 0: {name} "
        f"(count {torch.cuda.device_count()})")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    return name, card


def phase_build():
    from quantized_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    seconds = _cuda.build_kernels()
    log(f"[build] {json.dumps({k: round(v, 2) for k, v in seconds.items()})} "
        f"wall {time.perf_counter() - t0:.2f} s")
    for source, text in _cuda.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {source}: {line.strip()}")


def _rand_int8(gen, shape, low=-128, high=128, device="cuda"):
    return torch.randint(low, high, shape, generator=gen, dtype=torch.int8).to(device)


def _epilogue_params(gen, n, device):
    alpha = (torch.rand(n, generator=gen) * 2e-5 + 1e-5).to(device)
    beta = (torch.rand(n, generator=gen) - 0.5).to(device)
    return alpha, beta


def _ptxas_lines(source):
    """{kernel's mangled name: its ptxas register and shared-memory line}
    from this run's build log of a source (empty where nothing was built)."""
    from quantized_tpu_torch.ops import _cuda

    lines, name = {}, None
    for line in _cuda.BUILD_LOGS.get(source, "").splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "Used" in line and name is not None:
            lines[name] = line.split(":", 1)[1].strip()
    return lines


def _log_gemm_plan(kernel, label, a, w, n, packed, clip=False):
    """The Hopper GEMM's plan of a product and its kernel instance's ptxas
    line (the ring is dynamic shared memory, the plan's ``smem``). The C
    entry takes TMA where the plan's shape does and both bases are 16-byte
    aligned, else the general tile."""
    from quantized_tpu_torch.ops import gemm_plan

    m, k = a.shape
    plan = gemm_plan(m, n, k, packed=packed)
    tma = plan.tma_shape and a.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    source = "int4_gemm.cu" if packed else "int8_gemm.cu"
    instance = f"gemm_sm90_kernelILi{plan.tile}ELb{int(packed)}ELb{int(clip)}EE"
    ptxas = next((v for key, v in _ptxas_lines(source).items() if instance in key), "not built in this run")
    log(f"[kernels] {kernel} {label} {m}x{k}x{n} plan: tile {plan.tile}, split {plan.split} "
        f"(cluster {plan.split}x1x1), steps {plan.steps}, stages {plan.stages}, dynamic smem {plan.smem} B, "
        f"blocks {plan.blocks}, {'TMA' if tma else 'general tile'}; ptxas: {ptxas}")


def _log_conv_plan(kernel, label, x, wc, ks, stride, pad, form, clip=False):
    """The conv mainloop's plan of a call (``conv_plan``; the gather-K
    form's own route for form "gatherk") and its instance's ptxas line (the
    CLIP instance's with ``clip``); the route is asserted by the caller from
    the counts."""
    from quantized_tpu_torch.ops import conv_plan

    n, h, w, cin = x.shape
    plan = conv_plan(n, h, w, cin, wc.shape[0], ks, stride, pad, form)
    if plan.route != "sm90":
        log(f"[kernels] {kernel} {label} plan: general tile ({form}, Cin {cin})")
        return plan
    if plan.mode == 2:
        ch = 16 if cin % 16 == 0 else 4 if cin % 4 == 0 else 1
        instance = f"gatherk_sm90_kernelILi{ch}ELi{plan.bn}ELb{int(clip)}EE"
        ptxas = next((v for key, v in _ptxas_lines("int8_conv.cu").items() if instance in key), "not built in this run")
        log(f"[kernels] {kernel} {label} plan: gather-K route, swizzle row {plan.kc} B, bn {plan.bn}, tile "
            f"{plan.two}x{plan.tho}x{plan.nb}, dynamic smem {plan.smem} B, wgmma steps {plan.k_stages}, tiles "
            f"{plan.tiles}, blocks {plan.blocks}; ptxas: {ptxas}")
        return plan
    source = "int8_conv_flat.cu" if form == "flat" else "int8_conv.cu"
    instance = f"conv_sm90_kernelILi{plan.kc}ELi{plan.bn}ELb{int(form == 'residual')}ELb{int(clip)}EE"
    ptxas = next((v for key, v in _ptxas_lines(source).items() if instance in key), "not built in this run")
    groups = (f"groups of {plan.pixels} pixels ({n * h * w // plan.pixels} rows of {plan.pixels * cin} B, "
              f"{plan.pixels * wc.shape[0]} channels), " if plan.pixels > 1 else "")
    log(f"[kernels] {kernel} {label} plan: {groups}kc {plan.kc}, bn {plan.bn}, tile {plan.two}x{plan.tho}x{plan.nb}, "
        f"stages {plan.stages}, dynamic smem {plan.smem} B, k stages {plan.k_stages}, tiles {plan.tiles}, "
        f"blocks {plan.blocks}; ptxas: {ptxas}")
    return plan


def _conv_tile_ms(timer, x, wc, args, got, residual=None, res_grid=None):
    """Device time of K2's general tile (the per-tap or residual form) on
    the same inputs as a call that took the mainloop, launched here for the
    comparison only, after checking that it computes the call's output."""
    from quantized_tpu_torch.ops import int8_conv_pallas as cp

    (kh, kw), alpha, beta, (sh, sw), (ph, pw), zp, relu, req = (args[0], args[1], args[2], (args[3],) * 2,
                                                                 (args[4],) * 2, *args[5:])
    n, h, w, cin = x.shape
    cout = wc.shape[0]
    ho, wo = cp.conv_out_hw(h, w, (kh, kw), (sh, sw), (ph, pw))
    out, out_int8, inv, zps = cp._requant_args(req, (n, ho, wo, cout), x.device)
    kernel, r_ptr, r_off, r_scale = cp.CONV_TAP, None, 0.0, 0.0
    if residual is not None:
        kernel, r_ptr = cp.CONV_RESIDUAL, residual.data_ptr()
        r_off, r_scale = cp.f32(128 - res_grid[1]), cp.f32(res_grid[0])

    def run():
        kernel(x.device, x.data_ptr(), wc.data_ptr(), alpha.data_ptr(), beta.data_ptr(), r_ptr, None, out.data_ptr(),
               n, h, w, cin, cout, kh, kw, sh, sw, ph, pw, ho, wo, zp, int(relu), out_int8, inv, zps, r_off, r_scale,
               *cp._TILE_PLAN.args(False), None, None, route="tile")
        return out

    if not torch.equal(run(), got):
        raise AssertionError("the general tile and the mainloop differ on the same inputs")
    return timer.ms(run)


def _log_block_plan(kernel, label, kind, x, cm, cout, stride, ds):
    """B3's or B4's plan of a call (``block_plan``: cluster size, images a
    cluster, band, job width, ring stages, shared memory, blocks) at the
    widths the wrapper launches (C, Cm and Cout padded to multiples of 16)
    and its instance's ptxas line; the route is asserted by the caller from
    the counts."""
    from quantized_tpu_torch.ops import block_plan

    n, h, w, c = x.shape
    c, cm, cout = (-(-v // 16) * 16 for v in (c, cm, cout))
    plan = block_plan(kind, n, h, w, c, cm, cout, stride, ds)
    instance = (f"bottleneck_sm90_kernelILi{plan.bn}ELi{stride}ELb{int(ds)}ELi0E" if kind == "bottleneck"
                else f"basic_sm90_kernelILi{plan.bn}ELi{stride}ELb{int(ds)}E")
    ptxas = next((v for key, v in _ptxas_lines("fused_block.cu").items() if instance in key), "not built in this run")
    log(f"[kernels] {kernel} {label} plan: cluster {plan.q}x1x1, images a cluster {plan.nb}, band {plan.r}, "
        f"bn {plan.bn}, stages {plan.stages}, dynamic smem {plan.smem} B, blocks {plan.blocks}, ring stages a "
        f"block {plan.steps}; ptxas: {ptxas}")
    return plan


def _log_dw_pw_plan(label, x, cout, stride):
    """B5's plan of a call (``dw_pw_plan``) and its instance's ptxas line;
    the route is asserted by the caller from the counts."""
    from quantized_tpu_torch.ops.fused_block import dw_pw_plan

    n, h, w, c = x.shape
    plan = dw_pw_plan(n, h, w, c, cout, stride)
    if plan.route == "sm90":
        instance = f"dw_pw_sm90_kernelILi{plan.cout // plan.q}ELi{stride}ELb{int(plan.c != c)}EE"
        desc = (f"Hopper route at C {plan.c}, Cout {plan.cout}, cluster {plan.q}x1x1, tile "
                f"{w // stride}x{plan.tho}x{plan.nb}, dynamic smem {plan.smem} B, tiles {plan.tiles}, clusters "
                f"{plan.clusters} ({plan.per_sm} blocks an SM)")
    else:
        ch = 16 if c % 16 == 0 else 4 if c % 4 == 0 else 1
        instance = f"fused_dw_pw_kernelILi{stride}ELi{ch}EE"
        desc = f"tile kernel, band {plan.tho}, grid {-(-(h // stride) // plan.tho)}x{n}"
    ptxas = next((v for key, v in _ptxas_lines("fused_dw_pw.cu").items() if instance in key), "not built in this run")
    log(f"[kernels] fused_dw_pw {label} plan: {desc}; ptxas: {ptxas}")
    return plan


def _log_dw_pw_narrow(timer, label, x, args, batch):
    """B5 at a C that is not a multiple of 16: the device time of the call
    (the Hopper route staging x at its true width) beside the tile kernel's
    on the same inputs (the route these pairs took before, launched here for
    the comparison only), and on a line of its own the time of the copy of x
    that padding it to a multiple of 16 in the wrapper would add (the design
    not taken)."""
    from quantized_tpu_torch import ops
    from quantized_tpu_torch.ops import fused_block as fb

    n, h, w, c = x.shape
    wdw, wpw, *vecs = args[:6]
    s, lo1, lo2, zp1 = args[6:]
    cout = wpw.shape[0]
    tile = fb.dw_pw_tile_plan(n, h, w, c, cout, s)
    out = torch.empty((n, h // s, w // s, cout), dtype=torch.int8, device=x.device)

    def run_tile():
        fb.DW_PW(x.device, x.data_ptr(), wdw.data_ptr(), wpw.data_ptr(), *(v.data_ptr() for v in vecs),
                 out.data_ptr(), n, h, w, c, cout, s, tile.tho, zp1, lo1, lo2, *tile.args(), route="tile")
        return out

    if not torch.equal(run_tile(), ops.fused_dw_pw_ck(x, *args)):
        raise AssertionError(f"fused_dw_pw {label}: the tile kernel and the Hopper route differ")
    call_ms, tile_ms = timer.ms(lambda: ops.fused_dw_pw_ck(x, *args)), timer.ms(run_tile)
    pad_ms = timer.ms(lambda: torch.nn.functional.pad(x, (0, -c % 16)))
    log(f"[kernels] fused_dw_pw {label} batch {batch}: ms {call_ms:.4f} on the Hopper route, the tile kernel on "
        f"the same inputs {tile_ms:.4f} (ratio {call_ms / tile_ms:.2f})")
    log(f"[kernels] fused_dw_pw {label} batch {batch}: a pad of x from C {c} to {c - c % -16} (F.pad, not run "
        f"by the port) would add ms {pad_ms:.4f}, {pad_ms / call_ms:.2f} of the call")
    return call_ms, tile_ms


def _route_of(name, before):
    """The route of the one launch of ``name`` since ``before`` (its routes then)."""
    from quantized_tpu_torch import ops

    now = ops.KERNELS[name].routes
    taken = [r for r in now if now[r] != before.get(r, 0)]
    if len(taken) != 1:
        raise AssertionError(f"{name}: routes {before} -> {now}")
    return taken[0]


def phase_kernels(timer):
    """Each kernel against its plain version at serving shapes; returns
    {kernel name: numbers} for the kernels line."""
    from quantized_tpu_torch import ops
    from quantized_tpu_torch.probes.gemm_sweep import BATCHES, FC, IM2COL, INT4_FC, bound_ms, gemm_work

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1234)
    results = {}

    def record(name, case, kernel, plain, lib, nbytes, nops, representative, plain_iters=10):
        before = ops.KERNELS[name].launches
        got = kernel()
        if ops.KERNELS[name].launches != before + 1:
            raise AssertionError(f"{case} did not go through {name}")
        want = plain()
        if got.dtype == torch.int8:
            err = (got.to(torch.int32) - want.to(torch.int32)).abs().max().item()
            ok = err == 0
        else:
            err = (got - want).abs().max().item()
            ok = err <= F32_ATOL
        if not ok:
            raise AssertionError(f"{name} {case}: kernel and plain version differ by {err}")
        ms, event_ms = timer.ms(kernel), timer.event_ms(kernel)
        plain_ms = timer.ms(plain, iters=plain_iters, warmup=1)
        lib_ms = None if lib is None else library_ms(timer, lib)
        b_ms, b_by = bound_ms(nbytes, nops)
        log(f"[kernels] {name} {case}: max_abs_err {err} ms {ms:.4f} event_ms {event_ms:.4f} "
            f"plain_ms {plain_ms:.4f} library_ms {lib_ms if lib_ms is None else round(lib_ms, 4)} "
            f"bound_ms {b_ms:.4f} ({b_by}, {nbytes} bytes) ops/s {nops / ms * 1e3:.3e}")
        entry = results.setdefault(name, {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], float(err))
        if representative:
            entry.update(case=case, ms=ms, event_ms=event_ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=b_ms, bound_by=b_by)
        return ms, plain_ms, b_ms, b_by

    def _block_case(name, case, kind, x, cm, cout, s, ds, kernel, plain, nbytes, nops, rep):
        """B3 or B4: its plan, then the kernel against its plain version and
        timed; it must take the mainloop."""
        _log_block_plan(name, case, kind, x, cm, cout, s, ds)
        before = dict(ops.KERNELS[name].routes)
        record(name, case, kernel, plain, None, nbytes, nops, rep, plain_iters=3)
        if _route_of(name, before) != "sm90":
            raise AssertionError(f"{name} {case}: not on the mainloop")

    # K1, f32 form: the fc head, (32, 2048) x (2048, 1000), then AlexNet's
    # fc1-3 at batches 1, 8, 32 and 128 (torch._int_mm refuses M <= 16)
    k1_cases = [("resnet fc", SERVE_BATCH, True)] + [(fc, b, False) for fc in INT4_FC for b in BATCHES]
    for label, m, rep in k1_cases:
        n, k = FC[label]
        a, w = _rand_int8(gen, (m, k)), _rand_int8(gen, (n, k), low=-127)
        alpha, beta = _epilogue_params(gen, n, dev)
        _log_gemm_plan("int8_matmul", label, a, w, n, packed=False)
        record("int8_matmul", f"{label} {m}x{k}x{n} f32",
               lambda a=a, w=w, alpha=alpha, beta=beta: ops.int8_matmul_nk(a, w, alpha, beta),
               lambda a=a, w=w, alpha=alpha, beta=beta: ops.int8_matmul_plain(a, w, alpha, beta),
               lambda a=a, w=w: torch._int_mm(a, w.T),
               *gemm_work(m, n, k), rep, plain_iters=3)

    # K1, requant form: layer1's 3x3 conv through im2col on the gemm path
    m, n, k = IM2COL
    a2, w2 = _rand_int8(gen, (m, k)), _rand_int8(gen, (n, k), low=-127)
    alpha2, beta2 = _epilogue_params(gen, n, dev)
    _log_gemm_plan("int8_matmul_requant", "im2col", a2, w2, n, packed=False)
    record("int8_matmul_requant", f"im2col {m}x{k}x{n} s8",
           lambda: ops.int8_matmul_requant_nk(a2, w2, alpha2, beta2, 0.05, 113, True),
           lambda: ops.int8_matmul_requant_plain(a2, w2, alpha2, beta2, 0.05, 113, True),
           lambda: torch._int_mm(a2, w2.T),
           *gemm_work(m, n, k, s8_out=True), True)

    # K2: the four per-tap shapes of ResNet-50, then the stem in gather-K form
    b = SERVE_BATCH
    conv_cases = [
        # name, label, (h, cin, cout, k, stride, pad, requant), representative;
        # torch._int_mm computes the 1x1 stride-1 case's integer product, and no
        # PyTorch call computes an int8 conv on CUDA for the others
        ("int8_conv_direct", "layer1 1x1 s1 64->256 f32", (56, 64, 256, 1, 1, 0, None), False),
        ("int8_conv_direct", "layer1 3x3 s1 64->64 s8", (56, 64, 64, 3, 1, 1, (0.05, 113)), True),
        ("int8_conv_direct", "layer2 3x3 s2 128->128 s8", (56, 128, 128, 3, 2, 1, (0.05, 113)), False),
        ("int8_conv_direct", "layer2 1x1 s2 256->512 f32", (56, 256, 512, 1, 2, 0, None), False),
        ("int8_conv_direct_gatherk", "stem s2d 4x4 s1 12->64 s8", (115, 12, 64, 4, 1, 0, (0.05, 113)), True),
        ("int8_conv_direct_gatherk", "cifar stem 3x3 s1 3->16 s8", (32, 3, 16, 3, 1, 1, (0.05, 113)), False),
        ("int8_conv_direct_gatherk", "mobilenet stem 3x3 s2 3->32 s8", (224, 3, 32, 3, 2, 1, (0.05, 113)),
         False),
        ("int8_conv_direct_gatherk", "mobilenet w0.75 stem 3x3 s2 3->24 s8", (224, 3, 24, 3, 2, 1, (0.05, 113)),
         False),
        ("int8_conv_direct_gatherk", "alexnet conv1 11x11 s4 3->64 s8", (224, 3, 64, 11, 4, 2, (0.05, 113)),
         False),
        # CIFAR ResNet-20's block convs over Cin 16 and 32 (13 of its 14 gather-K launches)
        ("int8_conv_direct_gatherk", "cifar 3x3 s1 16->16 s8", (32, 16, 16, 3, 1, 1, (0.05, 113)), False),
        ("int8_conv_direct_gatherk", "cifar 3x3 s2 16->32 s8", (32, 16, 32, 3, 2, 1, (0.05, 113)), False),
        ("int8_conv_direct_gatherk", "cifar 3x3 s1 32->32 s8", (16, 32, 32, 3, 1, 1, (0.05, 113)), False),
        ("int8_conv_direct_gatherk", "cifar 3x3 s2 32->64 s8", (16, 32, 64, 3, 2, 1, (0.05, 113)), False),
        ("int8_conv_direct", "alexnet conv2 5x5 s1 p2 64->192 s8", (27, 64, 192, 5, 1, 2, (0.05, 113)), False),
        # the per-tap form over Cin % 16 != 0: MobileNet-v1's first pointwise
        # conv at widths 0.75 and 0.25 (pixel groups on the mainloop) and Cin 9
        # (the general tile, single bytes)
        ("int8_conv_direct", "mobilenet w0.75 pw 1x1 s1 24->48 s8", (112, 24, 48, 1, 1, 0, (0.05, 113)), False),
        ("int8_conv_direct", "mobilenet w0.25 pw 1x1 s1 8->16 s8", (112, 8, 16, 1, 1, 0, (0.05, 113)), False),
        ("int8_conv_direct", "1x1 s1 9->40 f32", (56, 9, 40, 1, 1, 0, None), False),
    ]
    for name, label, (h, cin, cout, kk, s, p, req), rep in conv_cases:
        x = _rand_int8(gen, (b, h, h, cin))
        wc = _rand_int8(gen, (cout, kk * kk * cin), low=-127)
        ac, bc = _epilogue_params(gen, cout, dev)
        args = ((kk, kk), ac, bc, s, p, -5, True, req)
        ho = (h + 2 * p - kk) // s + 1
        rows = window_extent(h, ho, kk, s, p)
        in_bytes = b * rows * rows * cin
        out_bytes = b * ho * ho * cout * (1 if req else 4)
        lib = (lambda x=x, wc=wc: torch._int_mm(x.reshape(-1, x.shape[-1]), wc.T)) if (kk, s) == (1, 1) else None
        form = "gatherk" if name == "int8_conv_direct_gatherk" else "tap"
        plan = _log_conv_plan(name, label, x, wc, (kk, kk), (s, s), (p, p), form)
        before = dict(ops.KERNELS[name].routes)
        # computed once per weight, as the engines do
        bs = ops.conv_border_sums(wc, (kk, kk))
        pg = ops.pixel_group_operands(wc, ac, bc) if plan.pixels > 1 else None
        call = (lambda x=x, wc=wc, args=args, bs=bs, pg=pg:
                ops.int8_conv_direct_ck(x, wc, *args, border_sums=bs, pixel_groups=pg))
        record(name, f"{label} batch {b}", call,
               lambda x=x, wc=wc, args=args: ops.int8_conv_direct_plain(x, wc, *args),
               lib, in_bytes + wc.numel() + 8 * cout + out_bytes,
               2 * b * ho * ho * kk * kk * cin * cout, rep, plain_iters=3)
        route = _route_of(name, before)
        log(f"[kernels] {name} {label}: route {route}")
        if (route != plan.route or (name == "int8_conv_direct_gatherk" and route != "sm90")
                or (cin in (24, 8) and route != "sm90")):
            raise AssertionError(f"{name} {label}: took {route}, planned {plan.route}")
        if plan.pixels > 1:  # the narrow 1x1s: the tile's time on the same inputs, and _int_mm's
            call_ms, tile_ms = timer.ms(call), _conv_tile_ms(timer, x, wc, args, call())
            lib_ms = library_ms(timer, lib)
            log(f"[kernels] {name} {label} batch {b}: ms {call_ms:.4f} on pixel groups, the general tile on the "
                f"same inputs {tile_ms:.4f} (ratio {call_ms / tile_ms:.2f}), torch._int_mm "
                f"{lib_ms if lib_ms is None else round(lib_ms, 4)}")
            if label.startswith("mobilenet w0.75") and not (call_ms <= tile_ms / 2 and call_ms < lib_ms):
                log(f"[kernels] {name} {label}: MISSED the target of at most half the tile's time and under "
                    f"torch._int_mm")

    # the CLIP instances of K2 and K1 (the RangeBN observer clamp, y_clip) at
    # the RangeBN ResNet-50's serving shapes, each against its plain version
    # with the clamp and timed beside the unclamped instance on the same
    # inputs; the bound is the unclamped call's (the same work). The bounds
    # bind on a large share of the outputs, and channel 3's cross (hi < lo).
    def clip_bounds(n, span):
        lo = -(torch.rand(n, generator=gen) * 0.75 + 0.25) * span
        hi = (torch.rand(n, generator=gen) * 0.75 + 0.25) * span
        lo[3], hi[3] = 0.2 * span, -0.1 * span
        return torch.stack([lo, hi]).to(dev)

    def clip_case(name, label, call, plain, unclamped, nbytes, nops, route):
        before = dict(ops.KERNELS[name].routes)
        ms, plain_ms, b_ms, b_by = record(name, label, call, plain, None, nbytes, nops, False, plain_iters=3)
        took = _route_of(name, before)
        if took != route:
            raise AssertionError(f"{name} {label}: took {took}, expected {route}")
        if torch.equal(call(), unclamped()):
            raise AssertionError(f"{name} {label}: the clamp changed nothing")
        base_ms = timer.ms(unclamped)
        log(f"[kernels] {name} {label}: CLIP instance ms {ms:.4f}, the unclamped instance on the same inputs "
            f"{base_ms:.4f} (ratio {ms / base_ms:.3f}), bound_ms {b_ms:.4f} ({b_by})")
        results[name].setdefault("clip", []).append(dict(case=label, ms=ms, unclamped_ms=base_ms, plain_ms=plain_ms,
                                                         bound_ms=b_ms, bound_by=b_by))

    clip_convs = [
        # name, label, (h, cin, cout, k, stride, pad, requant), the clamp's span
        ("int8_conv_direct", "layer1 3x3 s1 64->64 s8", (56, 64, 64, 3, 1, 1, (0.05, 113)), 2.0),
        ("int8_conv_direct", "layer1 1x1 s1 64->256 f32", (56, 64, 256, 1, 1, 0, None), 0.6),
        ("int8_conv_direct", "layer1 1x1 s1 64->256 s8", (56, 64, 256, 1, 1, 0, (0.05, 113)), 0.6),
        ("int8_conv_direct_gatherk", "stem s2d 4x4 s1 12->64 s8", (115, 12, 64, 4, 1, 0, (0.05, 113)), 1.0),
    ]
    for name, label, (h, cin, cout, kk, s, p, req), span in clip_convs:
        x = _rand_int8(gen, (b, h, h, cin))
        wc = _rand_int8(gen, (cout, kk * kk * cin), low=-127)
        ac, bc = _epilogue_params(gen, cout, dev)
        yc = clip_bounds(cout, span)
        args = ((kk, kk), ac, bc, s, p, -5, True, req)
        ho = (h + 2 * p - kk) // s + 1
        bs = ops.conv_border_sums(wc, (kk, kk))
        # the kernel's bounds, formed once per layer and grid as the engines form them
        cb = ops.kernel_clip(yc, cout, req, True)
        _log_conv_plan(name, f"clip {label}", x, wc, (kk, kk), (s, s), (p, p),
                       "gatherk" if name == "int8_conv_direct_gatherk" else "tap", clip=True)
        clip_case(name, f"clip {label} batch {b}",
                  lambda x=x, wc=wc, args=args, bs=bs, cb=cb: ops.int8_conv_direct_ck(x, wc, *args, border_sums=bs,
                                                                                    clip=cb),
                  lambda x=x, wc=wc, args=args, cb=cb: ops.int8_conv_direct_plain(x, wc, *args, clip=cb),
                  lambda x=x, wc=wc, args=args, bs=bs: ops.int8_conv_direct_ck(x, wc, *args, border_sums=bs),
                  x.numel() + wc.numel() + 8 * cout + b * ho * ho * cout * (1 if req else 4),
                  2 * b * ho * ho * kk * kk * cin * cout, "sm90+clip")
    # K1 on the "gemm" backend: layer1's 3x3 conv through im2col (s8), and
    # conv3's 1x1 64->256 (f32, the prescaled leg's form)
    for label, (m, k, n), req, span in (("im2col 3x3 64->64 s8", IM2COL, (0.05, 113), 2.0),
                                        ("im2col 1x1 64->256 f32", (b * 56 * 56, 64, 256), None, 0.6)):
        a, w = _rand_int8(gen, (m, k)), _rand_int8(gen, (n, k), low=-127)
        ak, bk = _epilogue_params(gen, n, dev)
        yc = clip_bounds(n, span)
        kname = "int8_matmul" if req is None else "int8_matmul_requant"
        _log_gemm_plan(kname, f"clip {label}", a, w, n, packed=False, clip=True)
        cb = ops.kernel_clip(yc, n, req, True)
        if req is None:
            call = lambda a=a, w=w, ak=ak, bk=bk, cb=cb: ops.int8_matmul_nk(a, w, ak, bk, True, clip=cb)
            plain = lambda a=a, w=w, ak=ak, bk=bk, cb=cb: ops.int8_matmul_plain(a, w, ak, bk, True, clip=cb)
            unclamped = lambda a=a, w=w, ak=ak, bk=bk: ops.int8_matmul_nk(a, w, ak, bk, True)
        else:
            call = (lambda a=a, w=w, ak=ak, bk=bk, cb=cb, req=req:
                    ops.int8_matmul_requant_nk(a, w, ak, bk, *req, True, clip=cb))
            plain = (lambda a=a, w=w, ak=ak, bk=bk, cb=cb, req=req:
                     ops.int8_matmul_requant_plain(a, w, ak, bk, *req, True, clip=cb))
            unclamped = lambda a=a, w=w, ak=ak, bk=bk, req=req: ops.int8_matmul_requant_nk(a, w, ak, bk, *req, True)
        clip_case(kname, f"clip {label} {m}x{k}x{n}", call, plain, unclamped,
                  *gemm_work(m, n, k, s8_out=req is not None), "sm90+clip")

    # B7: the flat-row conv at ResNet-50's stride-1 shapes, K2's time on the
    # same inputs beside it; the bound counts K2's bytes and operations (the
    # junk columns are B7's own overhead, not the function's work)
    flat_cases = [
        # label, (h, cin, cout, k, requant), representative
        ("l1_3x3 56x56 64->64 s8", (56, 64, 64, 3, (0.05, 113)), True),
        ("l2_3x3 28x28 128->128 s8", (28, 128, 128, 3, (0.05, 113)), False),
        ("l3_3x3 14x14 256->256 s8", (14, 256, 256, 3, (0.05, 113)), False),
        ("l4_3x3 7x7 512->512 s8", (7, 512, 512, 3, (0.05, 113)), False),
        ("l1_1x1b 56x56 64->256 f32", (56, 64, 256, 1, None), False),
    ]
    for label, (h, cin, cout, kk, req), rep in flat_cases:
        x = _rand_int8(gen, (b, h, h, cin))
        wc = _rand_int8(gen, (cout, kk * kk * cin), low=-127)
        ac, bc = _epilogue_params(gen, cout, dev)
        args = ((kk, kk), ac, bc, 1, kk // 2, -5, True, req)
        lib = (lambda x=x, wc=wc: torch._int_mm(x.reshape(-1, x.shape[-1]), wc.T)) if kk == 1 else None
        _log_conv_plan("int8_conv_flat", label, x, wc, (kk, kk), (1, 1), (kk // 2, kk // 2), "flat")
        before = dict(ops.KERNELS["int8_conv_flat"].routes)
        record("int8_conv_flat", f"{label} batch {b}",
               lambda x=x, wc=wc, args=args: ops.int8_conv_flat_ck(x, wc, *args),
               lambda x=x, wc=wc, args=args: ops.int8_conv_flat_plain(x, wc, *args),
               lib, x.numel() + wc.numel() + 8 * cout + b * h * h * cout * (1 if req else 4),
               2 * b * h * h * kk * kk * cin * cout, rep, plain_iters=3)
        if _route_of("int8_conv_flat", before) != "sm90":
            raise AssertionError(f"int8_conv_flat {label}: not on the mainloop")
        bs = ops.conv_border_sums(wc, (kk, kk))
        k2_ms = timer.ms(lambda x=x, wc=wc, args=args, bs=bs: ops.int8_conv_direct_ck(x, wc, *args, border_sums=bs))
        log(f"[kernels] int8_conv_direct (K2) on the same inputs: ms {k2_ms:.4f}")
        if rep:
            results["int8_conv_flat"]["int8_conv_direct_ms"] = k2_ms

    # B8: K2 with the fused int8 residual, at ResNet-18's conv2 + identity
    # (layer1 and layer3), f32 and s8 out
    residual_cases = [
        # label, (h, c), requant, representative
        ("layer1 56x56 64 s8", (56, 64), (0.06, 105), True),
        ("layer1 56x56 64 f32", (56, 64), None, False),
        ("layer3 14x14 256 s8", (14, 256), (0.06, 105), False),
        ("layer3 14x14 256 f32", (14, 256), None, False),
    ]
    for label, (h, c), req, rep in residual_cases:
        x, r = _rand_int8(gen, (b, h, h, c)), _rand_int8(gen, (b, h, h, c))
        wc = _rand_int8(gen, (c, 9 * c), low=-127)
        ac, bc = _epilogue_params(gen, c, dev)
        args = ((3, 3), ac, bc, 1, 1, -5, True, req)
        kw = dict(residual=r, res_grid=(0.03, 117))
        bs = ops.conv_border_sums(wc, (3, 3))
        _log_conv_plan("int8_conv_direct_residual", label, x, wc, (3, 3), (1, 1), (1, 1), "residual")
        before = dict(ops.KERNELS["int8_conv_direct_residual"].routes)
        call = (lambda x=x, wc=wc, args=args, kw=kw, bs=bs:
                ops.int8_conv_direct_ck(x, wc, *args, **kw, border_sums=bs))
        record("int8_conv_direct_residual", f"{label} batch {b}", call,
               lambda x=x, wc=wc, args=args, kw=kw: ops.int8_conv_direct_plain(x, wc, *args, **kw),
               None, 2 * x.numel() + wc.numel() + 8 * c + x.numel() * (1 if req else 4),
               2 * b * h * h * 9 * c * c, rep, plain_iters=3)
        if _route_of("int8_conv_direct_residual", before) != "sm90":
            raise AssertionError(f"int8_conv_direct_residual {label}: not on the mainloop")
        call_ms = timer.ms(call)
        k2_ms = timer.ms(lambda x=x, wc=wc, args=args, bs=bs: ops.int8_conv_direct_ck(x, wc, *args, border_sums=bs))
        tile_ms = _conv_tile_ms(timer, x, wc, args, call(), **kw)
        log(f"[kernels] int8_conv_direct_residual {label} batch {b}: ms {call_ms:.4f} on the mainloop, K2 on the "
            f"same inputs without the residual {k2_ms:.4f} (ratio {call_ms / k2_ms:.2f}), the general tile on the "
            f"same inputs {tile_ms:.4f} (ratio {call_ms / tile_ms:.2f})")
        if label == "layer1 56x56 64 s8" and not (call_ms <= 1.15 * k2_ms and call_ms <= tile_ms / 2):
            log(f"[kernels] int8_conv_direct_residual {label}: MISSED the target of at most 1.15x K2 and half "
                f"the tile")
        if rep:
            results["int8_conv_direct_residual"].update(int8_conv_direct_ms=k2_ms, tile_ms=tile_ms)

    # B9: the copy kernels on the layer1 activation; the yardstick is
    # Tensor.copy_ into a preallocated tensor, the bound 2 x its bytes
    from quantized_tpu_torch.ops.copy_probe import bulk_plan, copy_plan, ring_plan
    xa = _rand_int8(gen, (b, 56, 56, 256))
    dst = torch.empty_like(xa)
    image, sms = xa.numel() // b, torch.cuda.get_device_properties(dev).multi_processor_count
    log(f"[kernels] grid_copy plan at bi 1: {copy_plan(xa.numel(), image, sms)}; ring_copy plan at S 4, D 2, "
        f"bi 1: {ring_plan(xa.numel(), image, 4, 2, False, sms)}; bulk_copy plan at 1 stream: "
        f"{bulk_plan(xa.numel(), 1, sms)}")
    for name, case, kernel, rep in (
            ("grid_copy", "", lambda: ops.grid_copy(xa, 1), True),
            ("ring_copy", "", lambda: ops.ring_copy(xa, 4, 2, 1), True),
            ("bulk_copy", "", lambda: ops.bulk_copy(xa, 1), True),
            *(("bulk_copy", f" {st} streams", lambda st=st: ops.bulk_copy(xa, st), False) for st in range(2, 7))):
        before = dict(ops.KERNELS[name].routes)
        record(name, f"({b}, 56, 56, 256) s8{case}", kernel, lambda: ops.copy_plain(xa), lambda: dst.copy_(xa),
               2 * xa.numel(), 0, rep, plain_iters=3)
        if _route_of(name, before) != "sm90":
            raise AssertionError(f"{name}{case}: not on its Hopper route")

    # B3: the fused bottlenecks at ResNet-50's block shapes, with the int16
    # shortcut leg (ds_fine = 32) as the engine passes it
    fused_cases = [
        # name, label, (h, c, cm, cout, stride), representative
        ("fused_bottleneck_s1", "layer1.1 56x56 256->64->256", (56, 256, 64, 256, 1), True),
        ("fused_bottleneck_s1", "layer3.1 14x14 1024->256->1024", (14, 1024, 256, 1024, 1), False),
        ("fused_bottleneck_s1", "layer4.1 7x7 2048->512->2048", (7, 2048, 512, 2048, 1), False),
        ("fused_bottleneck_ds", "layer1.0 s1 56x56 64->64->256", (56, 64, 64, 256, 1), False),
        ("fused_bottleneck_ds", "layer2.0 s2 56x56 256->128->512", (56, 256, 128, 512, 2), True),
        ("fused_bottleneck_ds", "layer3.0 s2 28x28 512->256->1024", (28, 512, 256, 1024, 2), False),
        ("fused_bottleneck_ds", "layer4.0 s2 14x14 1024->512->2048", (14, 1024, 512, 2048, 2), False),
        # C = 24 (no zoo block has it): the wrapper pads C, Cm and Cout to multiples of 16
        ("fused_bottleneck_s1", "C 24 28x28 24->16->24", (28, 24, 16, 24, 1), False),
        ("fused_bottleneck_ds", "C 24 s2 56x56 24->24->40", (56, 24, 24, 40, 2), False),
        ("fused_bottleneck_ds", "C 24 s1 28x28 24->16->32", (28, 24, 16, 32, 1), False),
    ]
    for name, label, (h, c, cm, cout, s), rep in fused_cases:
        ds = name == "fused_bottleneck_ds"
        x = _rand_int8(gen, (b, h, h, c))
        ws = [_rand_int8(gen, shape, low=-127) for shape in
              [(cm, c), (cm, 9 * cm), (cout, cm)] + ([(cout, c)] if ds else [])]
        vecs = []
        for k, n in [(c, cm), (9 * cm, cm), (cm, cout)] + ([(c, cout)] if ds else []):
            vecs += [((torch.rand(n, generator=gen) + 0.5) * (6e-3 / k ** 0.5)).to(dev),
                     ((torch.rand(n, generator=gen) - 0.5) * 16).to(dev)]
        if ds:
            args = (*ws, *vecs, s, -21.0, -9.0, -3.0, -21, 32.0)
            kernel, plain = ops.fused_bottleneck_ds_ck, ops.fused_bottleneck_ds_plain
        else:
            args = (*ws, *vecs, -21.0, -9.0, -3.0, -21, 0.8137192, 2.71828)
            kernel, plain = ops.fused_bottleneck_s1_ck, ops.fused_bottleneck_s1_plain
        ho = h // s
        nbytes = x.numel() + b * ho * ho * cout + sum(w.numel() for w in ws) + 4 * sum(v.numel() for v in vecs)
        nops = 2 * b * (h * h * c * cm + 9 * ho * ho * cm * cm + ho * ho * cm * cout
                        + (ho * ho * c * cout if ds else 0))
        _block_case(name, f"{label} batch {b}", "bottleneck", x, cm, cout, s, ds,
                    lambda x=x, args=args, kernel=kernel: kernel(x, *args),
                    lambda x=x, args=args, plain=plain: plain(x, *args), nbytes, nops, rep)

    # B4: the fused BasicBlocks at ResNet-18's and CIFAR ResNet-20's shapes,
    # conv1's stored zero point unlike conv2's, the int16 shortcut leg on
    basic_cases = [
        # name, label, (h, c, cm, stride), representative
        ("fused_basicblock_s1", "resnet18 layer1.1 56x56 64", (56, 64, 64, 1), True),
        ("fused_basicblock_s1", "resnet18 layer3.1 14x14 256", (14, 256, 256, 1), False),
        ("fused_basicblock_s1", "cifar20 layer1.1 32x32 16", (32, 16, 16, 1), False),
        ("fused_basicblock_ds", "resnet18 layer2.0 s2 56->28 64->128", (56, 64, 128, 2), True),
        ("fused_basicblock_ds", "resnet18 layer4.0 s2 14->7 256->512", (14, 256, 512, 2), False),
        ("fused_basicblock_ds", "cifar20 layer2.0 s2 32->16 16->32", (32, 16, 32, 2), False),
        # C = 24, padded by the wrapper as above
        ("fused_basicblock_s1", "C 24 28x28 24", (28, 24, 24, 1), False),
        ("fused_basicblock_ds", "C 24 s2 56->28 24->16", (56, 24, 16, 2), False),
        ("fused_basicblock_ds", "C 24 s1 28x28 24->24", (28, 24, 24, 1), False),
    ]
    for name, label, (h, c, cm, s), rep in basic_cases:
        ds = name == "fused_basicblock_ds"
        x = _rand_int8(gen, (b, h, h, c))
        ws = [_rand_int8(gen, shape, low=-127) for shape in
              [(cm, 9 * c), (cm, 9 * cm)] + ([(cm, c)] if ds else [])]
        vecs = []
        for k in [9 * c, 9 * cm] + ([c] if ds else []):
            vecs += [((torch.rand(cm, generator=gen) + 0.5) * (6e-3 / k ** 0.5)).to(dev),
                     ((torch.rand(cm, generator=gen) - 0.5) * 16).to(dev)]
        if ds:
            args = (*ws, *vecs, s, -21.0, -3.0, -17, -40, 32.0)
            kernel, plain = ops.fused_basicblock_ds_ck, ops.fused_basicblock_ds_plain
        else:
            args = (*ws, *vecs, -21.0, -3.0, -17, -40, 0.8137192, 2.71828)
            kernel, plain = ops.fused_basicblock_s1_ck, ops.fused_basicblock_s1_plain
        ho = h // s
        nbytes = x.numel() + b * ho * ho * cm + sum(w.numel() for w in ws) + 4 * sum(v.numel() for v in vecs)
        nops = 2 * b * ho * ho * (9 * c * cm + 9 * cm * cm + (c * cm if ds else 0))
        _block_case(name, f"{label} batch {b}", "basic", x, cm, cm, s, ds,
                    lambda x=x, args=args, kernel=kernel: kernel(x, *args),
                    lambda x=x, args=args, plain=plain: plain(x, *args), nbytes, nops, rep)

    # the stage probes of B3 (bench/fused_probe.py's k_conv1 and k_conv12) at
    # their geometry, (32, 56, 56, 256), C = 256, Cm = 64: bytes of x, the
    # output and the weights; conv1's operations, and conv2's for conv12
    from quantized_tpu_torch.probes.fused_stages import CM, SCALE
    xs = _rand_int8(gen, (b, 56, 56, 256))
    w1s, w2s = _rand_int8(gen, (CM, 256), low=-127), _rand_int8(gen, (CM, 9 * CM), low=-127)
    a_s = torch.full((CM,), SCALE, device=dev)
    for stop, name in ((1, "fused_stages_conv1"), (2, "fused_stages_conv12")):
        ops_n = 2 * b * 56 * 56 * (256 * CM + (9 * CM * CM if stop == 2 else 0))
        before = dict(ops.KERNELS[name].routes)
        record(name, f"(32, 56, 56, 256) C 256 Cm {CM}", lambda stop=stop: ops.fused_stage_ck(xs, w1s, w2s, a_s, stop),
               lambda stop=stop: ops.fused_stage_plain(xs, w1s, w2s, a_s, stop), None,
               2 * xs.numel() + w1s.numel() + (w2s.numel() if stop == 2 else 0) + 4 * CM, ops_n, True, plain_iters=3)
        if _route_of(name, before) != "sm90":
            raise AssertionError(f"{name}: not on the mainloop")

    # B5: MobileNet-v1's fused depthwise-separable pairs at their eight
    # distinct shapes, the depthwise conv's stored zero point unlike either
    # clip floor, each on the route of its plan
    dw_pw_cases = [
        # label, (input side, C, Cout, stride), representative
        ("pair 0 112x112 32->64", (112, 32, 64, 1), True),
        ("pair 1 s2 112->56 64->128", (112, 64, 128, 2), False),
        ("pair 2 56x56 128->128", (56, 128, 128, 1), False),
        ("pair 3 s2 56->28 128->256", (56, 128, 256, 2), False),
        ("pair 4 28x28 256->256", (28, 256, 256, 1), False),
        ("pair 5 s2 28->14 256->512", (28, 256, 512, 2), False),
        ("pairs 6-10 14x14 512->512", (14, 512, 512, 1), False),
        ("pair 11 s2 14->7 512->1024", (14, 512, 1024, 2), False),
        # C % 16 != 0: width 0.75's pair 0 and width 0.25's (C = 8), computed at C 32 and 16
        ("w0.75 pair 0 112x112 24->48", (112, 24, 48, 1), False),
        ("w0.25 pair 0 112x112 8->16", (112, 8, 16, 1), False),
    ]
    for label, (h, c, cout, s), rep in dw_pw_cases:
        x = _rand_int8(gen, (b, h, h, c))
        wdw, wpw = _rand_int8(gen, (c, 9), low=-127), _rand_int8(gen, (cout, c), low=-127)
        vecs = [((torch.rand(c, generator=gen) + 0.5) * (4e-2 / 3)).to(dev),
                ((torch.rand(c, generator=gen) - 0.5) * 16).to(dev),
                ((torch.rand(cout, generator=gen) + 0.5) * (6e-3 / c ** 0.5)).to(dev),
                ((torch.rand(cout, generator=gen) - 0.5) * 16).to(dev)]
        args = (wdw, wpw, *vecs, s, -21.0, -9.0, -17)
        ho = h // s
        plan = _log_dw_pw_plan(label, x, cout, s)
        before = dict(ops.KERNELS["fused_dw_pw"].routes)
        nbytes = x.numel() + b * ho * ho * cout + wdw.numel() + wpw.numel() + 4 * sum(v.numel() for v in vecs)
        record("fused_dw_pw", f"{label} batch {b}",
               lambda x=x, args=args: ops.fused_dw_pw_ck(x, *args),
               lambda x=x, args=args: ops.fused_dw_pw_plain(x, *args),
               None, nbytes, 2 * b * ho * ho * (9 * c + c * cout), rep, plain_iters=3)
        route = _route_of("fused_dw_pw", before)
        log(f"[kernels] fused_dw_pw {label}: route {route}")
        if route != plan.route or route != "sm90":
            raise AssertionError(f"fused_dw_pw {label}: took {route}, planned {plan.route}")
        if c % 16:  # the narrow pairs against the tile kernel, at this batch and at 128
            call_ms, tile_ms = _log_dw_pw_narrow(timer, label, x, args, b)
            if label.startswith("w0.75") and not call_ms <= tile_ms / 2:
                log(f"[kernels] fused_dw_pw {label}: MISSED the target of at most half the tile kernel's time")
            x = _rand_int8(gen, (THROUGHPUT_BATCH, h, h, c))
            _log_dw_pw_narrow(timer, label, x, args, THROUGHPUT_BATCH)

    # B6: AlexNet's fc head on split-half packed int4 weights, f32 and
    # requant forms; torch._int_mm (the yardstick) and K1 take the unpacked
    # int8 weights of the same product
    for label, m in [(fc, b) for fc in INT4_FC for b in BATCHES]:
        n, k = FC[label]
        rep = (label, m) == ("alexnet fc1", SERVE_BATCH)  # the f32 form of fc1 at the serving batch
        a = _rand_int8(gen, (m, k))
        w_kn = torch.randint(-7, 8, (k, n), generator=gen, dtype=torch.int8)
        w_packed = ops.pack_int4(w_kn).T.contiguous().to(dev)  # (N, K/2)
        w_nk = w_kn.T.contiguous().to(dev)
        alpha, beta = _epilogue_params(gen, n, dev)
        _log_gemm_plan("int4_matmul", label, a, w_packed, n, packed=True)
        for form, req in (("f32", None), ("s8", (0.05, 113))):
            kw = {} if req is None else dict(out_scale=req[0], out_zp=req[1])
            record("int4_matmul", f"{label} {m}x{k}x{n} {form}",
                   lambda a=a, w=w_packed, kw=kw: ops.int4_matmul_nk(a, w, alpha, beta, relu=True, **kw),
                   lambda a=a, w=w_packed, kw=kw: ops.int4_matmul_plain(a, w, alpha, beta, relu=True, **kw),
                   lambda a=a, w=w_nk: torch._int_mm(a, w.T),
                   *gemm_work(m, n, k, packed=True, s8_out=req is not None), rep and req is None, plain_iters=3)
            if req is None and rep:
                k1_ms = timer.ms(lambda a=a, w=w_nk: ops.int8_matmul_nk(a, w, alpha, beta, relu=True))
                k1_bound, k1_by = bound_ms(*gemm_work(m, n, k))
                log(f"[kernels] int8_matmul (K1) on the same product, unpacked: ms {k1_ms:.4f} "
                    f"bound_ms {k1_bound:.4f} ({k1_by})")
                results["int4_matmul"]["int8_matmul_ms"] = k1_ms
    return results


def _first_block_input(engine, x_q):
    """The stem's output, pooled in the ImageNet geometry."""
    from quantized_tpu_torch.engine.int8_resident import maxpool_3x3_s2_int8

    h = engine.stem.run_q(x_q, relu=True, out_requant=engine.stem_out_grid)
    return (maxpool_3x3_s2_int8(h) if engine.imagenet_pool else h), h


def _mobilenet_steps(engine):
    """(name, callable) of each step of an Int8MobileNet's chain: its convs,
    or its stages once fused."""
    if engine.fused_stages:
        return [(f"stage{j}", getattr(engine, f"stage{j}")) for j in range(engine.num_fused_stages)]
    return [(f"conv{i}", lambda h, conv=getattr(engine, f"conv{i}"), grid=grid:
             conv.run_q(h, relu=True, out_requant=grid)) for i, grid in enumerate(engine.requant_grids)]


def _alexnet_steps(engine):
    """(name, callable) of each layer of an Int8AlexNet: each conv with its
    pool (the max/min dual), each dense layer; fc3 emits the logits."""
    from quantized_tpu_torch.engine.int8_alexnet import _pool_dual

    g = engine.requant_grids

    def conv(i, mask):
        def step(h):
            h = getattr(engine, f"conv{i}").run_q(h, relu=True, out_requant=g[i - 1])
            return h if mask is None else _pool_dual(h, getattr(engine, mask))
        return step

    return [("conv1", conv(1, "neg1")), ("conv2", conv(2, "neg2")), ("conv3", conv(3, None)),
            ("conv4", conv(4, None)), ("conv5", conv(5, "neg5")),
            ("fc1", lambda h: engine.fc1.run_q(h.reshape(h.shape[0], -1), relu=True, out_requant=g[5])),
            ("fc2", lambda h: engine.fc2.run_q(h, relu=True, out_requant=g[6])),
            ("logits", lambda h: engine.fc3.run_q(h))]


def _stage_outputs(engine, u8):
    """Output of the stem and each stage (each MobileNet conv or fused
    stage, each AlexNet layer), and the logits."""
    from quantized_tpu_torch.engine import Int8AlexNet, Int8MobileNet
    from quantized_tpu_torch.engine.int8_resident import u8_to_stored

    with torch.inference_mode():
        if isinstance(engine, Int8AlexNet):
            h, outs = u8_to_stored(u8, engine.conv1.grid), {}
            for name, step in _alexnet_steps(engine):
                h = outs[name] = step(h)
            return outs
        if isinstance(engine, Int8MobileNet):
            h, outs = u8_to_stored(u8, engine.input_grid), {}
            for name, step in _mobilenet_steps(engine):
                h = outs[name] = step(h)
        else:
            h, stem = _first_block_input(engine, u8_to_stored(u8, engine.stem.grid))
            outs = {"stem": stem}
            for i in range(1, engine.num_stages + 1):
                h = getattr(engine, f"layer{i}")(h)
                outs[f"layer{i}"] = h
        outs["logits"] = engine.fc(h.mean(dim=(1, 2)))
    return outs


def _check_int8(got, want, what, exact: bool):
    diff = (got.cpu().to(torch.int32) - want.cpu().to(torch.int32)).abs()
    step, share = diff.max().item(), (diff > 0).float().mean().item()
    if exact and step != 0:
        raise AssertionError(f"{what}: int8 outputs differ by up to {step} steps")
    if step > 1 or share >= 0.01:
        raise AssertionError(f"{what}: {step} steps, {share:.4%} of elements differ")
    return step, share


def _check_logits(got, want, what, atol=LOGIT_ATOL):
    err = (got.cpu() - want.cpu()).abs().max().item()
    log(f"[compare] {what} logits: max abs diff {err:.6g} (tolerance {atol})")
    if not err <= atol:
        raise AssertionError(f"{what}: logits differ by {err}")


def _compare_stages(outs_a, outs_b, what):
    """Stage by stage, each engine on its own activations: int8 outputs
    equal, f32 outputs (the logits) within F32_ATOL of their magnitude."""
    for key in outs_a:
        a, b = outs_a[key].cpu(), outs_b[key].cpu()
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{what} {key}: {a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
        if a.dtype == torch.int8:
            step, _ = _check_int8(a, b, f"{what} {key}", exact=True)
            log(f"[compare] {what} {key}: int8 equal")
        else:
            err, tol = (a - b).abs().max().item(), F32_ATOL * max(1.0, a.abs().max().item())
            log(f"[compare] {what} {key}: max abs diff {err:.6g} (tolerance {tol:.3g})")
            if not err <= tol:
                raise AssertionError(f"{what} {key}: f32 outputs differ by {err}")


def _within_one_step(step):
    """A gemm or fused step against K2's: within 1 step, on under 1% of the
    elements (they round their requant in another order)."""
    return "1 step"


def _check_step(tally, kind, got, want, what):
    """One int8 step against the reference's, by its kind: "exact" bit-equal,
    "1 step" as :func:`_within_one_step` says, "bf16" only reported. The
    tally counts the exact steps and keeps the worst (step, share) of the
    others."""
    if kind == "exact":
        _check_int8(got, want, what, exact=True)
        tally["exact"] += 1
    elif kind == "1 step":
        tally["1 step"] = max(tally["1 step"], _check_int8(got, want, what, exact=False))
    else:
        diff = (got.to(torch.int32) - want.to(torch.int32)).abs()
        tally["bf16"] = max(tally["bf16"], (diff.max().item(), (diff > 0).float().mean().item()))


def _log_tally(what, tally):
    log(f"[compare] {what} int8 steps on shared inputs: {tally['exact']} bit-equal; worst within-1-step "
        f"{tally['1 step']}, worst bf16 {tally['bf16']} (step(s), differing share)")


def _compare_blocks(ref, other, u8, what, kind=_within_one_step, logit_atol=LOGIT_ATOL):
    """Every int8 block of ``other`` (and its stem) fed ``ref``'s input to
    it, checked by ``kind(step)`` (:func:`_check_step`); then the logits end
    to end within ``logit_atol``."""
    from quantized_tpu_torch.engine.int8_resident import u8_to_stored

    tally = {"exact": 0, "1 step": (0, 0.0), "bf16": (0, 0.0)}
    with torch.inference_mode():
        x = u8_to_stored(u8, ref.stem.grid)
        h, stem = _first_block_input(ref, x)
        _check_step(tally, kind(other.stem), _first_block_input(other, x)[1], stem, f"{what} stem")
        for i in range(1, ref.num_stages + 1):
            ref_stage, other_stage = getattr(ref, f"layer{i}"), getattr(other, f"layer{i}")
            for k in range(ref_stage.num_blocks):
                nxt = getattr(ref_stage, str(k))(h)
                if nxt.dtype == torch.int8:
                    step = getattr(other_stage, str(k))
                    _check_step(tally, kind(step), step(h), nxt, f"{what} layer{i}.{k}")
                h = nxt
        _log_tally(what, tally)
        _check_logits(other.run_u8(u8), ref.run_u8(u8), what, logit_atol)


def _compare_pairs(ref, other, u8, what, kind=_within_one_step, logit_atol=LOGIT_ATOL):
    """MobileNet: every step of ``other`` (a conv, or a fused pair against
    ``ref``'s two convs) fed ``ref``'s input to it, checked by ``kind(step)``
    (:func:`_check_step`); then the logits end to end within
    ``logit_atol``."""
    from quantized_tpu_torch.engine import FusedInt8DwPw
    from quantized_tpu_torch.engine.int8_resident import u8_to_stored

    tally, convs, i = {"exact": 0, "1 step": (0, 0.0), "bf16": (0, 0.0)}, _mobilenet_steps(ref), 0
    with torch.inference_mode():
        h = u8_to_stored(u8, ref.input_grid)
        for name, stage in _mobilenet_steps(other):
            span = 2 if isinstance(stage, FusedInt8DwPw) else 1
            nxt = h
            for _, conv in convs[i:i + span]:
                nxt = conv(nxt)
            if nxt.dtype == torch.int8:
                _check_step(tally, kind(getattr(other, name)), stage(h), nxt, f"{what} {name}")
            h, i = nxt, i + span
        _log_tally(what, tally)
        _check_logits(other.run_u8(u8), ref.run_u8(u8), what, logit_atol)


def _observe(model, side: int):
    """Two observer-update passes on seeded images (as the JAX package's
    MobileNet tests calibrate): a random-init MobileNet's activations shrink
    at every depthwise conv, and on grids frozen at [-4, 4] every conv past
    the fourth would emit only its clip floor."""
    gen = torch.Generator().manual_seed(5)
    model.train()
    with torch.no_grad():
        for _ in range(2):
            model(torch.randn((2, side, side, 3), generator=gen))
    return model.eval()


def _flip_gamma(model):
    """Negate every 7th BN scale of bn1, bn2 and bn5 (as the JAX package's
    AlexNet test does): those channels' folded BN factor turns negative, so
    the engine pools them with the min-pool dual."""
    with torch.no_grad():
        for bn in (model.bn1, model.bn2, model.bn5):
            bn.scale[::7] *= -1.0
    return model


def _build(key: str, backend: str, device: str, weight_bits: int = 8):
    from quantized_tpu_torch.engine import build_int8_alexnet, build_int8_mobilenet, build_int8_resident
    from quantized_tpu_torch.entry import _calibrated_model

    name, cfg, side, _ = MODELS[key]
    model = _calibrated_model(name, device="cpu", generator=torch.Generator().manual_seed(0), **cfg)
    if name == "mobilenet_quantized":
        return build_int8_mobilenet(_observe(model, side), weight_bits=weight_bits, backend=backend,
                                    device=device)
    if name == "alexnet_quantized":
        return build_int8_alexnet(_flip_gamma(model), weight_bits=weight_bits, backend=backend, device=device)
    return build_int8_resident(model, weight_bits=weight_bits, backend=backend, device=device)


def _check_launches(counts, per_forward, forwards, what):
    """Every kernel launched exactly ``per_forward`` times per forward (0 for
    a kernel not named)."""
    log(f"[{what}] launches {json.dumps(counts)}")
    for name, n in counts.items():
        want = per_forward.get(name, 0) * forwards
        if n != want:
            raise AssertionError(f"{what}: {name} launched {n} times, expected {want}")


def _serve(what, executor, requests, per_forward, classes, route="sm90"):
    """Answer the requests with the launch counts set to 0 just before and
    read just after; returns the counts. ``route``: the Hopper route every
    K2 per-tap and gather-K launch must take ("sm90+clip", the CLIP
    instances, on a clamped engine; "sm90", and so no CLIP instance, on
    any other)."""
    from quantized_tpu_torch import ops

    torch.cuda.synchronize()
    ops.reset_launches()
    answers = []
    for i, req in enumerate(requests):
        t = time.perf_counter()
        logits = executor(req)
        torch.cuda.synchronize()
        answers.append(logits)
        log(f"[{what}] request {i}: {tuple(logits.shape)} in {(time.perf_counter() - t) * 1e3:.1f} ms")
    counts = ops.launch_counts()
    _check_launches(counts, per_forward, len(requests), what)
    routes = PATH_ROUTES[what] = ops.route_counts()
    log(f"[{what}] routes {json.dumps(routes)}")
    off = {r: n for r, n in routes.get("int8_conv_direct", {}).items() if r != route}
    if off:  # every K2 per-tap launch of a serving path takes the mainloop
        raise AssertionError(f"{what}: K2 per-tap launches off the route {route}: {off}")
    for name in BLOCK_KERNELS + ("int8_conv_direct_gatherk", "fused_dw_pw"):  # B3-B5, gather-K: a Hopper route
        want = route if name == "int8_conv_direct_gatherk" else "sm90"
        if counts[name] and routes.get(name) != {want: counts[name]}:
            raise AssertionError(f"{what}: {name} launches by route {routes.get(name)}, all {counts[name]} "
                                 f"expected on the route {want}")
    for logits in answers:
        if tuple(logits.shape) != (requests[0].shape[0], classes) or not torch.isfinite(logits).all():
            raise AssertionError(f"{what}: bad logits, shape {tuple(logits.shape)}")
    log(f"[{what}] {len(requests)} requests of {requests[0].shape[0]} images answered: shape "
        f"({requests[0].shape[0]}, {classes}), finite; launches per forward "
        f"{json.dumps({k: v // len(requests) for k, v in counts.items() if v})}")
    return counts


def phase_gemm(pallas_engine, sample):
    """ResNet-50 on the "gemm" backend (im2col + K1), held against the main
    path block by block."""
    from quantized_tpu_torch import ops
    from quantized_tpu_torch.engine import IntExecutor

    engine = _build("resnet50", "gemm", "cuda")
    executor = IntExecutor(engine, ingest="u8", device="cuda", graphs=False)
    executor.warmup(sample)
    torch.cuda.synchronize()
    ops.reset_launches()
    logits = executor(sample)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    _check_launches(counts, GEMM_PLAN, 1, "resnet50 gemm")
    if tuple(logits.shape) != (sample.shape[0], 1000) or not torch.isfinite(logits).all():
        raise AssertionError("gemm path: bad logits")
    _compare_blocks(pallas_engine, engine, sample.cuda(), "resnet50 gemm vs pallas")
    return counts


def phase_model(key):
    """One model's serving paths: unfused, then fused by
    ``fuse_resident_blocks`` (``fuse_mobilenet_blocks`` for MobileNet),
    each served the same requests and held against its CPU twin; the fused
    engine also against the unfused one. ResNet-50 also runs the "gemm"
    backend. Returns the executors and the counts of each path."""
    from quantized_tpu_torch.engine import IntExecutor, fuse_mobilenet_blocks, fuse_resident_blocks

    _, _, side, classes = MODELS[key]
    fuse, compare = ((fuse_mobilenet_blocks, _compare_pairs) if key.startswith("mobilenet")
                     else (fuse_resident_blocks, _compare_blocks))
    plan, fused_plan, n_blocks = PLANS[key]
    t0 = time.perf_counter()
    engine = _build(key, "pallas", "cuda")
    executor = IntExecutor(engine, ingest="u8", device="cuda", graphs=False)
    log(f"[{key}] int8-resident engine built on the GPU in {time.perf_counter() - t0:.1f} s")
    requests = _requests(side)
    sample = requests[0][:2]
    executor.warmup(sample)
    counts = {f"{key} serve": _serve(f"{key} serve", executor, requests, plan, classes)}

    # the same engine on the CPU, from the same seed, on 2 of the images
    cpu_engine = _build(key, "pallas", "cpu")
    _compare_stages(_stage_outputs(engine, sample.cuda()), _stage_outputs(cpu_engine, sample),
                    f"{key} gpu vs cpu")
    if key == "resnet50":
        counts["resnet50 gemm"] = phase_gemm(engine, sample)

    fused = copy.deepcopy(engine)
    n_fused = fuse(fused)
    if n_fused != n_blocks:
        raise AssertionError(f"{key}: {fuse.__name__} fused {n_fused}, expected {n_blocks}")
    fused_executor = IntExecutor(fused, ingest="u8", device="cuda", graphs=False)
    fused_executor.warmup(sample)
    counts[f"{key} fused"] = _serve(f"{key} fused", fused_executor, requests, fused_plan, classes)
    cpu_fused = copy.deepcopy(cpu_engine)
    fuse(cpu_fused)
    _compare_stages(_stage_outputs(fused, sample.cuda()), _stage_outputs(cpu_fused, sample),
                    f"{key} fused gpu vs fused cpu")
    compare(engine, fused, sample.cuda(), f"{key} fused vs unfused")
    return {"unfused": executor, "fused": fused_executor}, counts


def _requests(side):
    gen = torch.Generator().manual_seed(7)
    return [torch.randint(0, 256, (SERVE_BATCH, side, side, 3), generator=gen, dtype=torch.uint8)
            for _ in range(SERVE_REQUESTS)]


def phase_alexnet():
    """AlexNet's two serving paths, int8 and int4 weights, each built on the
    GPU, served the same requests, held against its CPU twin stage by stage,
    with every layer's count of distinct values printed (none may be
    constant). Returns the executors and the counts of each path."""
    from quantized_tpu_torch.engine import IntExecutor

    requests = _requests(224)
    sample = requests[0][:2]
    executors, counts = {}, {}
    for bits, what in ((8, "alexnet serve"), (4, "alexnet int4 serve")):
        t0 = time.perf_counter()
        engine = _build("alexnet", "pallas", "cuda", weight_bits=bits)
        masks = {m: int(getattr(engine, m).sum()) for m in ("neg1", "neg2", "neg5")}
        log(f"[{what}] engine built on the GPU in {time.perf_counter() - t0:.1f} s; min-pool channels "
            f"(negative BN factor) {json.dumps(masks)}")
        if not all(masks.values()):
            raise AssertionError(f"{what}: the min-pool dual is not engaged")
        executor = IntExecutor(engine, ingest="u8", device="cuda", graphs=False)
        executor.warmup(sample)
        counts[what] = _serve(what, executor, requests, ALEXNET_PLANS[bits], 1000)
        outs = _stage_outputs(engine, sample.cuda())
        distinct = {k: len(torch.unique(v)) for k, v in outs.items()}
        log(f"[{what}] distinct values per layer on 2 images: {json.dumps(distinct)}")
        if min(distinct.values()) < 2:
            raise AssertionError(f"{what}: a layer's output is constant")
        _compare_stages(outs, _stage_outputs(_build("alexnet", "pallas", "cpu", weight_bits=bits), sample),
                        f"{what} gpu vs cpu")
        executors["int8" if bits == 8 else "int4"] = executor
    return executors, counts


def phase_resnet50_int4():
    """ResNet-50 with int4 weights: built on the GPU (fusing it fuses
    nothing), served the same requests as the int8 paths, held against its
    CPU twin stage by stage. Returns the executor and its path's counts."""
    from quantized_tpu_torch.engine import IntExecutor, fuse_resident_blocks

    what = "resnet50 int4 serve"
    t0 = time.perf_counter()
    engine = _build("resnet50", "pallas", "cuda", weight_bits=4)
    log(f"[{what}] engine built on the GPU in {time.perf_counter() - t0:.1f} s")
    n_fused = fuse_resident_blocks(copy.deepcopy(engine))
    if n_fused != 0:
        raise AssertionError(f"{what}: fuse_resident_blocks fused {n_fused} int4 blocks")
    executor = IntExecutor(engine, ingest="u8", device="cuda", graphs=False)
    requests = _requests(224)
    sample = requests[0][:2]
    executor.warmup(sample)
    counts = {what: _serve(what, executor, requests, RESNET50_INT4_PLAN, 1000)}
    _compare_stages(_stage_outputs(engine, sample.cuda()),
                    _stage_outputs(_build("resnet50", "pallas", "cpu", weight_bits=4), sample), f"{what} gpu vs cpu")
    return executor, counts


def _rangebn_model():
    """The RangeBN ResNet-50 (ImageNet, depth 50, full width) from seed 0:
    two train-mode passes on seeded images set the RangeBN statistics and
    every observer, then the RangeBN input observers are narrowed to
    RANGEBN_NARROW of their range, so the clamp binds (as the JAX package's
    clamp test, ``tests/test_engine.py:371``, narrows them). On the CPU."""
    from quantized_tpu_torch.entry import _calibrated_model
    from quantized_tpu_torch.models.layers import RangeBN

    name, cfg, side, _ = MODELS["resnet50 rangebn"]
    model = _observe(_calibrated_model(name, device="cpu", generator=torch.Generator().manual_seed(0), **cfg), side)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, RangeBN):
                m.quantize_input.running_min.mul_(RANGEBN_NARROW)
                m.quantize_input.running_max.mul_(RANGEBN_NARROW)
    return model


def _per_forward_routes(what, routes, per_forward, forwards):
    if routes != {k: {r: n * forwards for r, n in v.items()} for k, v in per_forward.items()}:
        raise AssertionError(f"{what}: routes {routes}, expected {per_forward} per forward")


def phase_rangebn():
    """The RangeBN ResNet-50 (``resnet_quantized``): ``build_int8_resident(...,
    backend="pallas")`` served through ``IntExecutor``, every conv on a CLIP
    instance (52 K2 per-tap, 1 gather-K, the fc on K1), held against its CPU
    twin stage by stage, the clamp shown load-bearing (the logits move when
    it is removed) and no block fused; then the same engine on "gemm" (K1's
    clamped requant and f32 forms) against "pallas" within 1 step,
    ``convert_to_int(backend="pallas")`` (K2's clamped f32 form) against its
    CPU twin, and the strict engine on a batch of RANGEBN_STRICT_BATCH
    against its CPU twin. Returns the executor, the paths' counts and the
    ``convert_to_int`` and strict engines (for the graphs phase)."""
    from quantized_tpu_torch import ops
    from quantized_tpu_torch.engine import IntExecutor, build_int8_resident, convert_to_int, fuse_resident_blocks
    from quantized_tpu_torch.engine.int_layers import IntConv2d
    from quantized_tpu_torch.engine.strict import convert_to_int_strict

    key = "resnet50 rangebn"
    side, classes = MODELS[key][2:]
    t0 = time.perf_counter()
    model = _rangebn_model()
    log(f"[{key}] calibrated (two train-mode passes on the CPU, RangeBN observers at {RANGEBN_NARROW}) in "
        f"{time.perf_counter() - t0:.1f} s")
    engine = build_int8_resident(copy.deepcopy(model), backend="pallas", device="cuda")
    convs = [m for m in engine.modules() if isinstance(m, IntConv2d)]
    if not convs or any(m.y_clip is None for m in convs):
        raise AssertionError(f"{key}: a conv carries no clamp")
    n_fused = fuse_resident_blocks(copy.deepcopy(engine))
    if n_fused != 0:
        raise AssertionError(f"{key}: fuse_resident_blocks fused {n_fused} clamped blocks")
    log(f"[{key}] {len(convs)} convs (the stem's s2d and raw forms among them), every one clamped; "
        f"fuse_resident_blocks fuses {n_fused} blocks")
    executor = IntExecutor(engine, ingest="u8", device="cuda", graphs=False)
    requests = _requests(side)
    sample = requests[0][:2]
    executor.warmup(sample)
    what = f"{key} serve"
    counts = {what: _serve(what, executor, requests, PLANS["resnet50"][0], classes, route="sm90+clip")}
    _per_forward_routes(what, PATH_ROUTES[what], RANGEBN_ROUTES, len(requests))
    cpu_engine = build_int8_resident(copy.deepcopy(model), backend="pallas", device="cpu")
    _compare_stages(_stage_outputs(engine, sample.cuda()), _stage_outputs(cpu_engine, sample), f"{key} gpu vs cpu")
    stripped = copy.deepcopy(engine)
    for m in stripped.modules():
        if isinstance(m, IntConv2d):
            m.y_clip = None
    with torch.inference_mode():
        kept, gone = engine.run_u8(sample.cuda()), stripped.run_u8(sample.cuda())
    moved = (kept - gone).abs().max().item()
    log(f"[{key}] logits with the clamps removed move by up to {moved:.4g} (logits up to "
        f"{kept.abs().max().item():.4g})")
    if not moved > 10 * F32_ATOL * max(1.0, kept.abs().max().item()):
        raise AssertionError(f"{key}: removing the clamps moved the logits by {moved} only")
    del stripped, cpu_engine

    what = f"{key} gemm"
    gemm = build_int8_resident(copy.deepcopy(model), backend="gemm", device="cuda")
    with torch.inference_mode():
        counts[what], _ = _path_counts(what, lambda: gemm.run_u8(sample.cuda()))
    routes = PATH_ROUTES[what] = ops.route_counts()
    _check_launches(counts[what], GEMM_PLAN, 1, what)
    _per_forward_routes(what, routes, RANGEBN_GEMM_ROUTES, 1)
    _compare_blocks(engine, gemm, sample.cuda(), f"{what} vs pallas")
    del gemm

    gen = torch.Generator().manual_seed(13)
    x = torch.randn((2, side, side, 3), generator=gen)
    what = f"{key} convert_to_int"
    cvt = convert_to_int(copy.deepcopy(model), backend="pallas", device="cuda")
    with torch.inference_mode():
        counts[what], got = _path_counts(what, lambda: cvt(x.cuda()))
        routes = PATH_ROUTES[what] = ops.route_counts()
        want = convert_to_int(copy.deepcopy(model), backend="pallas", device="cpu")(x)
    _check_launches(counts[what], PLANS["resnet50"][0], 1, what)
    _per_forward_routes(what, routes, RANGEBN_ROUTES, 1)
    _compare_stages({"logits": got}, {"logits": want}, f"{what} gpu vs cpu")

    what = f"{key} strict"
    xs = torch.randn((RANGEBN_STRICT_BATCH, side, side, 3), generator=gen)
    strict = convert_to_int_strict(copy.deepcopy(model).cuda())  # converted where it lies, served on the card
    t1 = time.perf_counter()
    with torch.inference_mode():
        counts[what], got = _path_counts(what, lambda: strict(xs.cuda()))
        log(f"[{what}] batch {RANGEBN_STRICT_BATCH} on the GPU in {time.perf_counter() - t1:.2f} s (plain "
            f"PyTorch, exact int32 products)")
        want = convert_to_int_strict(copy.deepcopy(model), device="cpu")(xs[:2])
    fc_step = strict.fc.act_scale
    err = (got[:2].cpu() - want).abs().max().item()
    log(f"[{what}] logits {tuple(got.shape)}, finite {bool(torch.isfinite(got).all())}; the first 2 against the "
        f"CPU twin: max abs diff {err:.4g} (tolerance 2 fc steps, {2 * fc_step:.4g}), argmax equal "
        f"{bool((got[:2].cpu().argmax(-1) == want.argmax(-1)).all())}")
    if (tuple(got.shape) != (RANGEBN_STRICT_BATCH, classes) or not torch.isfinite(got).all() or not err < 2 * fc_step
            or not (got[:2].cpu().argmax(-1) == want.argmax(-1)).all()):
        raise AssertionError(f"{what}: the GPU strict engine and its CPU twin disagree ({err})")
    return executor, counts, {"convert_to_int": cvt, "strict": strict}


def _path_counts(what, run):
    """Launch counts of ``run()``, set to 0 just before and read just after."""
    from quantized_tpu_torch import ops

    torch.cuda.synchronize()
    ops.reset_launches()
    result = run()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    log(f"[{what}] launches {json.dumps({k: v for k, v in counts.items() if v})}")
    return counts, result


def _require_launched(counts, names, what):
    for name in names:
        if counts[name] <= 0:
            raise AssertionError(f"{what}: {name} was not launched")


def phase_conv_sweep():
    """The port's per-shape conv sweep (``probes/sweep_conv``) over ResNet-50's
    24 conv shapes at batch 32 on K2, B7 and im2col + K1: B7 refuses exactly
    the stride-2 shapes, every other cell is timed."""
    from quantized_tpu_torch import ops
    from quantized_tpu_torch.probes import sweep_conv

    counts, times = _path_counts("conv sweep", lambda: sweep_conv.run_sweep(
        SERVE_BATCH, SWEEP_MODES, target_secs=SWEEP_TARGET_SECS, reps=2, probe_loops=4,
        out=lambda line: log(f"[conv sweep] {line}")))
    for name, _, _, _, _, stride, _ in sweep_conv.SHAPES:
        for mode in SWEEP_MODES:
            if math.isnan(times[mode][name]) != (mode == "flat" and stride != 1):
                raise AssertionError(f"conv sweep: {mode} at {name} took {times[mode][name]}")
    _require_launched(counts, ("int8_conv_flat", "int8_conv_direct", "int8_conv_direct_gatherk",
                               "int8_matmul_requant"), "conv sweep")
    routes = PATH_ROUTES["conv sweep"] = ops.route_counts()
    log(f"[conv sweep] routes {json.dumps(routes)}")
    for name in ("int8_conv_direct", "int8_conv_flat"):
        if routes[name].get("tile", 0) or not routes[name].get("sm90", 0):
            raise AssertionError(f"conv sweep: {name} left the mainloop: {routes[name]}")
    sweep_conv.run_sweep(SERVE_BATCH, ("intmm",), target_secs=SWEEP_TARGET_SECS, reps=2, probe_loops=4,
                         shapes=[row for row in sweep_conv.SHAPES if (row[4], row[5]) == (1, 1)],
                         out=lambda line: log(f"[conv sweep] {line}"))
    return counts, times


def phase_conv_ops():
    """B8 through the JAX-signature op entry, ``int8_conv_direct(...,
    residual=, res_grid=)`` on HWIO weights, at ResNet-18's layer1 conv2 +
    identity (batch 32), s8 and f32 out: 2 launches, both on the mainloop,
    equal to the plain version."""
    from quantized_tpu_torch import ops

    gen = torch.Generator().manual_seed(4321)
    dev = torch.device("cuda")
    x, r = _rand_int8(gen, (SERVE_BATCH, 56, 56, 64)), _rand_int8(gen, (SERVE_BATCH, 56, 56, 64))
    w = _rand_int8(gen, (3, 3, 64, 64), low=-127)
    alpha, beta = _epilogue_params(gen, 64, dev)
    kw = dict(residual=r, res_grid=(0.03, 117))

    def run():
        return [ops.int8_conv_direct(x, w, alpha, beta, 1, 1, -5, True, req, **kw) for req in ((0.06, 105), None)]

    counts, outs = _path_counts("conv ops", run)
    _check_launches(counts, {"int8_conv_direct_residual": 2}, 1, "conv ops")
    routes = PATH_ROUTES["conv ops"] = ops.route_counts()
    if routes.get("int8_conv_direct_residual") != {"sm90": 2}:
        raise AssertionError(f"conv ops: B8 launches by route {routes.get('int8_conv_direct_residual')}")
    w_ck = ops.pack_conv_weight(w)
    for got, req in zip(outs, ((0.06, 105), None)):
        want = ops.int8_conv_direct_plain(x, w_ck, (3, 3), alpha, beta, 1, 1, -5, True, req, **kw)
        err = (got.float() - want.float()).abs().max().item()
        if err > (0 if req else F32_ATOL):
            raise AssertionError(f"conv ops: the residual conv differs from its plain version by {err}")
    log("[conv ops] int8_conv_direct(residual=, res_grid=) equals its plain version, s8 and f32")

    # a grouped conv of 2 groups (plain PyTorch: the JAX package leaves it to
    # XLA, so no kernel is owed) against its CPU twin, s8 and f32 out
    xg, wg = _rand_int8(gen, (2, 56, 56, 64)), _rand_int8(gen, (3, 3, 32, 64), low=-127)
    ag, bg = _epilogue_params(gen, 64, dev)
    for req in ((0.05, 113), None):
        args = (1, 1, -5, True, req)
        got = ops.int8_conv_xla(xg, wg, ag, bg, *args, groups=2)
        want = ops.int8_conv_xla(xg.cpu(), wg.cpu(), ag.cpu(), bg.cpu(), *args, groups=2)
        if got.shape != want.shape or not torch.equal(got.cpu(), want):
            raise AssertionError(f"conv ops: the grouped conv on the GPU differs from its CPU twin ({req})")
    log("[conv ops] int8_conv_xla(groups=2) on the GPU equals its CPU twin, s8 and f32")
    return counts


def phase_copy_probe():
    """The copy probe (``probes/dma_ring``): every variant of the TPU DMA
    studies exact against its plain version, then timed as a chain, on the
    (32, 56, 56, 256) layer1 activation."""
    from quantized_tpu_torch import ops
    from quantized_tpu_torch.probes import dma_ring

    counts, times = _path_counts("copy probe", lambda: dma_ring.run_probe(
        SERVE_BATCH, target_secs=COPY_TARGET_SECS, reps=2, out=lambda line: log(f"[copy probe] {line}")))
    _require_launched(counts, ("grid_copy", "ring_copy", "bulk_copy"), "copy probe")
    routes = PATH_ROUTES["copy probe"] = ops.route_counts()
    log(f"[copy probe] routes {json.dumps(routes)}")
    for name in ("grid_copy", "ring_copy", "bulk_copy"):
        if routes.get(name) != {"sm90": counts[name]}:
            raise AssertionError(f"copy probe: {name} launches by route {routes.get(name)}")
    return counts, times


def phase_fused_stages():
    """The stage split of B3 (``probes/fused_stages``): copy, conv1, conv12
    and the full identity block on one (32, 56, 56, 256) input, each equal
    to its plain version, then timed; the stage probes on the mainloop."""
    from quantized_tpu_torch import ops
    from quantized_tpu_torch.probes import fused_stages

    counts, times = _path_counts("fused stages", lambda: fused_stages.run_probe(
        SERVE_BATCH, out=lambda line: log(f"[fused stages] {line}")))
    _require_launched(counts, ("grid_copy", "fused_stages_conv1", "fused_stages_conv12", "fused_bottleneck_s1"),
                      "fused stages")
    routes = PATH_ROUTES["fused stages"] = ops.route_counts()
    for name in ("grid_copy", "fused_stages_conv1", "fused_stages_conv12", "fused_bottleneck_s1"):
        if set(routes.get(name, {})) != {"sm90"}:
            raise AssertionError(f"fused stages: {name} routes {routes.get(name)}")
    return counts, times


def _time_forward(executor, dev_batch, iters=10):
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        executor(dev_batch)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _profile(executor, dev_batch, ms, what, n_prof=3, unit="forward"):
    """Device time by kernel over ``n_prof`` calls of ``executor(dev_batch)``:
    logs the per-call kernel ms, idle share against ``ms``, our kernels'
    and the other kernels' ms and launches; returns (kernel ms, idle share,
    launches) per call, or None where the profiler saw no device time."""
    batch = dev_batch.shape[0]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            executor(dev_batch)
        torch.cuda.synchronize()
    rows = sorted(((evt.self_device_time_total / n_prof, evt.count // n_prof, evt.key)
                   for evt in prof.key_averages()
                   if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0),
                  reverse=True)
    if not rows:
        log(f"[profile] {what}: torch.profiler recorded no device kernels here: breakdown not measured")
        return None
    total = sum(r[0] for r in rows) / 1e3
    ours = [r for r in rows if any(k in r[2] for k in OUR_KERNELS)]
    ours_ms = sum(r[0] for r in ours) / 1e3
    log(f"[profile] {what}, per batch-{batch} {unit}: kernels {total:.3f} ms of {ms:.3f} ms "
        f"(idle share {max(0.0, 1 - total / ms):.3f}); hand-written kernels {ours_ms:.3f} ms in "
        f"{sum(r[1] for r in ours)} launches, other kernels (glue) {total - ours_ms:.3f} ms in "
        f"{sum(r[1] for r in rows) - sum(r[1] for r in ours)} launches")
    for us, count, key in rows[:12]:
        log(f"[profile] {what} {us / 1e3:9.3f} ms {count:4d}x {key[:100]}")
    return total, max(0.0, 1 - total / ms), sum(r[1] for r in rows), rows


def _depthwise_ms(key, engine, dev_batch, timer):
    """Device time of an unfused MobileNet's depthwise convs (on their
    backend: the plain grouped path on "pallas") on their inputs of one
    batch-128 forward."""
    from quantized_tpu_torch.engine.int8_resident import u8_to_stored

    with torch.inference_mode():
        h, calls = u8_to_stored(dev_batch, engine.input_grid), []
        for i, grid in enumerate(engine.requant_grids):
            conv = getattr(engine, f"conv{i}")
            if conv.groups > 1:
                calls.append((conv, h, grid))
            h = conv.run_q(h, relu=True, out_requant=grid)

        def run():
            for conv, x, grid in calls:
                conv.run_q(x, relu=True, out_requant=grid)

        ms = timer.ms(run, iters=5, warmup=1)
    backends = sorted({conv.backend for conv, _, _ in calls})
    log(f"[throughput] {key} unfused: its {len(calls)} depthwise convs on {'/'.join(backends)} take {ms:.3f} ms "
        f"of device time per batch-{THROUGHPUT_BATCH} forward")


def phase_throughput(key, executors, card, timer, batch=THROUGHPUT_BATCH):
    """Uint8 224x224 forwards of each engine of one model at one batch, timed
    in turns (a b b a ...)."""
    gen = torch.Generator().manual_seed(11)
    host = torch.randint(0, 256, (batch, 224, 224, 3), generator=gen, dtype=torch.uint8)
    dev = host.cuda()
    for ex in executors.values():
        ex.warmup(dev)
    order = list(executors) + list(reversed(executors))
    times = {name: [] for name in executors}
    for name in order:
        times[name].append(_time_forward(executors[name], dev))
    for name, ex in executors.items():
        ms = sum(times[name]) / len(times[name])
        iters = 10
        t = time.perf_counter()
        for _ in range(iters):
            ex(host)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t) / iters * 1e3
        torch.cuda.reset_peak_memory_stats()
        ex(dev)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**20
        log(f"[throughput] {key} {name}: batch {batch} uint8 224x224, input on the device: "
            f"{ms:.3f} ms/batch ({', '.join(f'{v:.3f}' for v in times[name])}), "
            f"{batch / ms * 1e3:.1f} img/s; from host memory (pageable, host clock): "
            f"{host_ms:.3f} ms/batch, {batch / host_ms * 1e3:.1f} img/s; peak memory {peak:.0f} MiB; "
            f"card {card}")
        _profile(ex, dev, ms, f"{key} {name} batch {batch}")
    if key.startswith("mobilenet"):
        _depthwise_ms(key, executors["unfused"].model, dev, timer)


AUTOTUNE_BATCH = THROUGHPUT_BATCH  # bench.py:21
BF16_LOGIT_ATOL = 0.35  # a bf16 engine's logits against the int8 one's (tests/test_autotune_bf16.py:47)
AUTOTUNE_MODELS = ("resnet50", "mobilenet")


def _conv_forms(engine):
    """{module name: backend} of every conv, the stem and the fc, and the
    kind of every other forward step (a fused block or pair)."""
    from quantized_tpu_torch.engine.int8_resident import Int8SpaceToDepthStem
    from quantized_tpu_torch.engine.int_layers import IntConv2d, IntLinear

    forms = {}
    for name, m in engine.named_modules():
        if isinstance(m, Int8SpaceToDepthStem):
            forms[name] = m.backend
        elif isinstance(m, (IntConv2d, IntLinear)) and not name.startswith("stem."):
            forms[name] = m.backend
        elif type(m).__name__.startswith("Fused"):
            forms[name] = type(m).__name__
    return forms


def _same_as_untuned(conv) -> bool:
    """A conv whose tuned form computes what the untuned "pallas" engine's
    does, bit for bit: K2, or the exact grouped path of a depthwise conv."""
    return conv.backend == "pallas" or (conv.groups != 1 and conv.backend in ("gemm", "xla"))


def _step_convs(step):
    from quantized_tpu_torch.engine.int_layers import IntConv2d

    return [m for m in step.modules() if isinstance(m, IntConv2d)]


def _tuned_kind(step):
    """How a step of the tuned engine is held against the untuned one's
    (every conv on "pallas", nothing fused): bit-equal where every conv of
    the step kept K2's function, "bf16" (reported) where a bf16 form won,
    else within 1 step (gemm or a fused kernel)."""
    from quantized_tpu_torch.engine.int8_resident import Int8SpaceToDepthStem

    if isinstance(step, Int8SpaceToDepthStem):  # K2 on either form: the same taps, exact
        form = step.backend.removeprefix("raw-")
        return "bf16" if form.startswith("bf16") else "exact" if form == "pallas" else "1 step"
    convs = _step_convs(step)
    if any(c.backend.startswith("bf16") for c in convs):
        return "bf16"
    if not type(step).__name__.startswith("Fused") and all(_same_as_untuned(c) for c in convs):
        return "exact"
    return "1 step"


def _compare_tuned(key, untuned, tuned, u8):
    """The tuned engine against the untuned one step by step
    (:func:`_tuned_kind`), then the logits: within BF16_LOGIT_ATOL where a
    bf16 form won anywhere, else LOGIT_ATOL."""
    any_bf16 = any(str(f).startswith(("bf16", "raw-bf16")) for f in _conv_forms(tuned).values())
    compare = _compare_pairs if key.startswith("mobilenet") else _compare_blocks
    compare(untuned, tuned, u8, f"{key} autotuned", _tuned_kind, BF16_LOGIT_ATOL if any_bf16 else LOGIT_ATOL)


def _check_hopper_routes(key, engine, u8):
    """Launch counts and routes of one tuned forward: every launch of every
    kernel on its Hopper route."""
    from quantized_tpu_torch import ops

    counts, _ = _path_counts(f"{key} autotuned", lambda: engine.run_u8(u8))
    routes = PATH_ROUTES[f"{key} autotuned"] = ops.route_counts()
    log(f"[{key} autotuned] routes {json.dumps(routes)}")
    for name, n in counts.items():
        if n and routes.get(name) != {"sm90": n}:
            raise AssertionError(f"{key} autotuned: {name} launched {n} times, by route {routes.get(name)}")
    return counts


def _check_cache_roundtrip(key, tuned, u8, cache):
    """A fresh engine with the written cache applied: the same forms and
    bit-equal logits, without measuring."""
    from quantized_tpu_torch.engine import apply_cached_backends

    fresh = _build(key, "pallas", "cuda")
    if not apply_cached_backends(fresh, u8, cache_path=cache, tune_extended=True):
        raise AssertionError(f"{key}: the cache did not cover every signature")
    if _conv_forms(fresh) != _conv_forms(tuned):
        raise AssertionError(f"{key}: the cache gave other forms than the tuner picked")
    with torch.inference_mode():
        same = torch.equal(fresh.run_u8(u8), tuned.run_u8(u8))
    if not same:
        raise AssertionError(f"{key}: the cached engine's logits differ from the tuned engine's")
    log(f"[autotune] {key}: apply_cached_backends gives the same {len(_conv_forms(fresh))} forms and "
        f"bit-equal logits")


def _bf16_engine(key, untuned, u8, sample, timer):
    """An engine built with every conv on "bf16": logits against the int8
    engine's within BF16_LOGIT_ATOL, the forward's time, and for MobileNet
    the depthwise convs' time beside the plain grouped path's."""
    from quantized_tpu_torch.engine import model_throughput

    engine = _build(key, "bf16", "cuda")
    with torch.inference_mode():
        err = (engine.run_u8(sample) - untuned.run_u8(sample)).abs().max().item()
    ips = model_throughput(engine, u8, target_secs=0.2, probe_loops=2)
    log(f"[autotune] {key} every conv on bf16: logits max abs diff {err:.6g} against the int8 engine "
        f"(tolerance {BF16_LOGIT_ATOL}); batch {u8.shape[0]}: {u8.shape[0] / ips * 1e3:.3f} ms, {ips:.1f} img/s")
    if not err <= BF16_LOGIT_ATOL:
        raise AssertionError(f"{key} every conv on bf16: logits differ by {err}")
    if key.startswith("mobilenet"):
        _depthwise_ms(f"{key} bf16", engine, u8, timer)


def phase_autotune(card, timer):
    """ResNet-50 and MobileNet-v1 w1.0 at batch 128 through the autotuner:
    every race on and measured afresh into a temporary cache, the tuned
    engine against the untuned one, the cache applied to a fresh engine, the
    tuned forward's routes, then the tuned, fused and unfused forwards (and
    the float ResNet-50, TF32 off) timed in turns. Returns the counts and the
    tuned ResNet-50 (served by the serve batcher phase)."""
    import tempfile

    from quantized_tpu_torch.engine import (
        autotune_resident,
        fuse_mobilenet_blocks,
        fuse_resident_blocks,
        model_throughput,
    )
    from quantized_tpu_torch.data.preprocess import IMAGENET_MEAN, IMAGENET_STD
    from quantized_tpu_torch.models import get_model

    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(11)
    u8 = torch.randint(0, 256, (AUTOTUNE_BATCH, 224, 224, 3), generator=gen, dtype=torch.uint8).cuda()
    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        for key in AUTOTUNE_MODELS:
            untuned = _build(key, "pallas", "cuda")
            tuned = copy.deepcopy(untuned)
            cache = str(Path(tmp) / f"{key}.json")
            t = time.perf_counter()
            table = autotune_resident(tuned, u8, cache_path=cache, tune_extended=True, tune_fused=True)
            tally = {}
            for verdict in table.values():
                tally[verdict] = tally.get(verdict, 0) + 1
            log(f"[autotune] {key}: {len(table)} signatures raced in {time.perf_counter() - t:.1f} s, verdicts "
                f"{json.dumps(tally)}; forms {json.dumps(_conv_forms(tuned))}")
            _compare_tuned(key, untuned, tuned, u8)
            _check_cache_roundtrip(key, tuned, u8, cache)
            counts[f"{key} autotuned"] = _check_hopper_routes(key, tuned, u8)
            _bf16_engine(key, untuned, u8, u8[:8], timer)
            if key.startswith("mobilenet"):
                _depthwise_ms(f"{key} plain grouped path", untuned, u8, timer)

            fused = copy.deepcopy(untuned)
            (fuse_mobilenet_blocks if key.startswith("mobilenet") else fuse_resident_blocks)(fused)
            engines = {"autotuned": (tuned, u8), "fused": (fused, u8), "unfused": (untuned, u8)}
            if key == "resnet50":
                name, cfg, _, _ = MODELS[key]
                float_model = get_model("resnet")(generator=torch.Generator().manual_seed(0), **cfg).eval().cuda()
                x = (u8.float() / 255.0 - torch.tensor(IMAGENET_MEAN, device="cuda")) / torch.tensor(
                    IMAGENET_STD, device="cuda")
                engines["float (fp32, TF32 off)"] = (float_model, x)
            ips = {name: [] for name in engines}
            for name in list(engines) + list(reversed(engines)):
                model, x = engines[name]
                ips[name].append(model_throughput(model, x, target_secs=0.25, probe_loops=2))
            for name, runs in ips.items():
                mean = sum(runs) / len(runs)
                log(f"[autotune] {key} {name}: batch {AUTOTUNE_BATCH} uint8 224x224 on the device, "
                    f"{AUTOTUNE_BATCH / mean * 1e3:.3f} ms/batch, {mean:.1f} img/s "
                    f"({', '.join(f'{v:.1f}' for v in runs)}); card {card}")
            for name in ("autotuned", "float (fp32, TF32 off)"):
                if name in engines:
                    model, x = engines[name]
                    forward = model.run_u8 if x.dtype == torch.uint8 else model
                    with torch.inference_mode():
                        _profile(forward, x, AUTOTUNE_BATCH / (sum(ips[name]) / len(ips[name])) * 1e3,
                                 f"{key} {name} batch {AUTOTUNE_BATCH}")
            if key == "resnet50":
                ratio = (sum(ips["autotuned"]) / sum(ips["float (fp32, TF32 off)"]))
                log(f"[autotune] resnet50 tuned / float img/s: {ratio:.3f}; card {card}")
            if key == "resnet50":
                kept = tuned
            del untuned, tuned, fused, engines
            torch.cuda.empty_cache()
    log(f"[autotune] phase took {time.perf_counter() - t_phase:.1f} s")
    return counts, kept


# ----------------------------------------------------------------- CUDA graphs, the batcher, the CLI

GRAPH_BATCH = 8  # the "graphs" phase captures each engine at this batch
GRAPH_TIMING_BATCHES = (1, 8)  # AlexNet, graph against eager, where PERF.md saw the host bound
HOPPER_ROUTES = ("sm90", "sm90+clip")
SERVE_BUCKETS = (1, 8, 32, THROUGHPUT_BATCH)  # the CLI's --serve buckets at -b 128
SERVE_DEPTHS = (1, 4)
SERVE_STREAM = 320  # seeded uint8 requests, in bursts of 1-128
SERVE_PASSES = 24  # the backlog: the stream submitted this many times over in each timed run, bursts 2 ms apart
SERVE_PACED_BURSTS = 64  # the paced stream: bursts of 1-32 requests ...
SERVE_PACED_GAP_S = 0.015  # ... this far apart, wider than a batch-32 forward: buckets 1, 8 and 32 serve
SERVE_TURNS = ("graph", "eager", "eager", "graph")
SERVE_HTTP_REQUESTS = 3


def _captured_routes_ok(what, stats, allowed=HOPPER_ROUTES):
    """Every launch of the captured forward on a Hopper route: each
    launched kernel's launches, all counted by route, on ``allowed``."""
    launches, routes = stats["launches"], stats["routes"]
    for name, n in launches.items():
        by_route = routes.get(name, {})
        if sum(by_route.values()) != n or set(by_route) - set(allowed):
            raise AssertionError(f"{what}: {name} captured {n} launches, by route {by_route}")
    return launches


def _graph_check(what, model, x, ingest, card):
    """Capture ``model``'s forward at ``x``'s shape; the replay (twice) bit-
    equal to the eager forward, every captured launch on a Hopper route.
    Returns the graph and eager executors."""
    from quantized_tpu_torch.engine import IntExecutor

    eager = IntExecutor(model, ingest=ingest, device="cuda", graphs=False)
    graph = IntExecutor(model, ingest=ingest, device="cuda", graphs=True)
    want = eager(x)
    got, again = graph(x), graph(x)
    torch.cuda.synchronize()
    if not (torch.equal(got, want) and torch.equal(again, want)):
        raise AssertionError(f"[graphs] {what}: the replay differs from the eager forward by "
                             f"{(got - want).abs().max().item()}")
    stats = graph.graph_stats()[tuple(x.shape)]
    launches = _captured_routes_ok(f"[graphs] {what}", stats)
    log(f"[graphs] {what}: batch {x.shape[0]} captured in {stats['seconds'] * 1e3:.1f} ms (its pool "
        f"{stats['pool_bytes'] / 2**20:.1f} MiB reserved), {sum(launches.values())} kernel launches a replay "
        f"{json.dumps(stats['routes'])}; {stats['replays']} replays bit-equal to the eager forward; card {card}")
    return graph, eager


def phase_graphs(executors, rangebn_extra, card):
    """Each engine this run built, captured at batch GRAPH_BATCH and held bit-
    equal to its eager forward; then AlexNet int8 and int4 at batches 1 and
    8 timed graph against eager (CUDA events over 10 calls from device
    inputs, and a profile: device time and idle share)."""
    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(23)
    engines = [(f"{key} {kind}", ex.model, MODELS[key][2]) for key in ("resnet50", "resnet18", "cifar20")
               for kind, ex in executors[key].items()]
    engines += [(f"{key} fused", executors[key]["fused"].model, 224) for key in ("mobilenet", "mobilenet w0.75")]
    engines += [(f"alexnet {kind}", ex.model, 224) for kind, ex in executors["alexnet"].items()]
    for what, model, side in engines:
        u8 = torch.randint(0, 256, (GRAPH_BATCH, side, side, 3), generator=gen, dtype=torch.uint8)
        _graph_check(what, model, u8.cuda(), "u8", card)
    x = torch.randn((GRAPH_BATCH, 224, 224, 3), generator=gen).cuda()
    for kind, model in rangebn_extra.items():  # f32 ingest: no uint8 path in the module surgery
        _graph_check(f"resnet50 rangebn {kind}", model, x, "f32", card)
    for kind in ("int8", "int4"):
        model = executors["alexnet"][kind].model
        for batch in GRAPH_TIMING_BATCHES:
            u8 = torch.randint(0, 256, (batch, 224, 224, 3), generator=gen, dtype=torch.uint8).cuda()
            graph, eager = _graph_check(f"alexnet {kind} batch {batch}", model, u8, "u8", card)
            runs = {"graph": graph, "eager": eager}
            times = {name: [] for name in runs}
            for name in ["graph", "eager", "eager", "graph"]:
                times[name].append(_time_forward(runs[name], u8))
            for name, ex in runs.items():
                ms = sum(times[name]) / len(times[name])
                log(f"[graphs] alexnet {kind} batch {batch} {name}: {ms:.4f} ms a forward "
                    f"({', '.join(f'{v:.4f}' for v in times[name])}), input on the device; card {card}")
                _profile(ex, u8, ms, f"alexnet {kind} {name} batch {batch}")
    log(f"[graphs] phase took {time.perf_counter() - t_phase:.1f} s")


def _request_stream():
    """SERVE_STREAM seeded uint8 224x224 images, the backlog's burst sizes
    (1-128, covering the images once) and the paced stream's
    (SERVE_PACED_BURSTS bursts of 1-32)."""
    import numpy as np

    rng = np.random.default_rng(17)
    imgs = rng.integers(0, 256, (SERVE_STREAM, 224, 224, 3), dtype=np.uint8)
    bursts, left = [], SERVE_STREAM
    while left:
        bursts.append(min(left, int(rng.integers(1, THROUGHPUT_BATCH + 1))))
        left -= bursts[-1]
    paced = [int(n) for n in rng.integers(1, 33, SERVE_PACED_BURSTS)]
    return imgs, bursts, paced


def _run_stream(batcher, imgs, bursts, gap_s, passes=1):
    """Submit the bursts ``gap_s`` apart (on a fixed schedule), ``passes``
    times over, request j being image j modulo their count; then wait for
    every answer. Returns the answers and the wall seconds from the first
    submit to the last answer."""
    import numpy as np

    t0 = time.perf_counter()
    futures = []
    for k, n in enumerate(bursts * passes):
        delay = t0 + k * gap_s - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        futures.extend(batcher.submit(imgs[j % len(imgs)]) for j in range(len(futures), len(futures) + n))
    answers = np.stack([f.result(timeout=120) for f in futures])
    return answers, time.perf_counter() - t0


def _http_predict(port, img):
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}/predict", data=img.tobytes(), method="POST",
                                 headers={"X-Shape": ",".join(map(str, img.shape)), "X-Dtype": "u8"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def _serve_graphs_ok(what, executor, batches, card):
    """One graph per bucket, every captured launch on its Hopper route, and
    one replay for each served batch (the warmup's call replays once).
    Returns the captured launches and the batches each bucket served."""
    graph_stats = executor.graph_stats()
    if set(graph_stats) != {(b, 224, 224, 3) for b in SERVE_BUCKETS}:
        raise AssertionError(f"[serve batcher] {what}: graphs {sorted(graph_stats)}")
    served = {}
    for shape, gs in sorted(graph_stats.items()):
        launches = _captured_routes_ok(f"[serve batcher] {what} bucket {shape[0]}", gs, ("sm90",))
        served[shape[0]] = gs["replays"] - 1
        log(f"[serve batcher] {what} bucket {shape[0]}: captured in {gs['seconds'] * 1e3:.1f} ms, its pool "
            f"{gs['pool_bytes'] / 2**20:.1f} MiB reserved, {sum(launches.values())} launches a replay on sm90, "
            f"{gs['replays'] - 1} replays serving; card {card}")
    if sum(served.values()) != batches:
        raise AssertionError(f"[serve batcher] {what}: {served} replays for {batches} batches")
    return launches, served


def phase_serve_batcher(tuned, card):
    """The tuned ResNet-50 behind ``ContinuousBatcher`` (``serve``'s
    executor, ``make_executor``: u8 ingest, buckets SERVE_BUCKETS) at
    pipeline depths 1 and 4 under two streams: the backlog (SERVE_STREAM
    seeded requests in bursts of 1-128 2 ms apart, SERVE_PASSES times over)
    and the paced stream (bursts of 1-32, SERVE_PACED_GAP_S apart). Each
    cell runs an executor that replays one CUDA graph per bucket and one
    that runs eagerly in turns (SERVE_TURNS), each run with a fresh
    executor and batcher and the launch counts set to 0 before it and read
    after: every answer against an eager batch-1 forward of its image
    (bit-equal, or within LOGIT_ATOL where a bf16 conv form serves), the
    captured forwards on Hopper routes, ``stats()`` and img/s printed. Then,
    at depth 4 with graphs, one pass journaled (a request log fsyncs every
    request, so it is not timed) and replayed into a fresh batcher (the same
    answers), and three /predict requests through the HTTP endpoint (the
    eager top-5)."""
    import tempfile

    import numpy as np

    from quantized_tpu_torch import ops
    from quantized_tpu_torch.engine import IntExecutor
    from quantized_tpu_torch.engine.batching import ContinuousBatcher, replay_request_log
    from quantized_tpu_torch.engine.server import _start_http, make_executor

    t_phase = time.perf_counter()
    forms = _conv_forms(tuned)
    exact = not any(str(f).startswith(("bf16", "raw-bf16")) for f in forms.values())
    imgs, bursts, paced = _request_stream()
    reference = IntExecutor(tuned, ingest="u8", device="cuda", graphs=False)
    want = np.concatenate([reference(imgs[i: i + 1]).cpu().numpy() for i in range(len(imgs))])
    log(f"[serve batcher] tuned ResNet-50 ({sum(str(f).startswith('Fused') for f in forms.values())} fused "
        f"blocks, bf16 forms: {not exact}); {len(imgs)} requests; backlog bursts {bursts} 2 ms apart, "
        f"{SERVE_PASSES} passes a run; paced bursts {paced} {SERVE_PACED_GAP_S * 1e3:.0f} ms apart")

    def check(answers, what):
        err = float(np.abs(answers - want[np.arange(len(answers)) % len(want)]).max())
        if (exact and err != 0.0) or not err <= LOGIT_ATOL:
            raise AssertionError(f"[serve batcher] {what}: answers differ from eager batch-1 forwards by {err}")
        return err

    def batcher_for(executor, depth, journal=None):
        return ContinuousBatcher(executor, (224, 224, 3), SERVE_BUCKETS, dtype=np.uint8, pipeline_depth=depth,
                                 request_log=journal)

    streams = {"backlog": (bursts, 0.002, SERVE_PASSES), "paced": (paced, SERVE_PACED_GAP_S, 1)}
    for depth in SERVE_DEPTHS:
        for stream, (stream_bursts, gap_s, passes) in streams.items():
            runs = {kind: [] for kind in SERVE_TURNS}
            for turn, kind in enumerate(SERVE_TURNS):
                what = f"depth {depth} {stream} {kind} (turn {turn + 1})"
                torch.cuda.synchronize()
                ops.reset_launches()
                executor = make_executor(tuned, ingest="u8", graphs=kind == "graph", pipeline_depth=depth)
                batcher = batcher_for(executor, depth)
                t = time.perf_counter()
                batcher.warmup()
                warm_s = time.perf_counter() - t
                batcher.start()
                answers, secs = _run_stream(batcher, imgs, stream_bursts, gap_s, passes)
                batcher.stop()
                counts = ops.launch_counts()
                err = check(answers, what)
                st = batcher.stats()
                runs[kind].append((st["requests"] / secs, st["latency_p50_ms"], st["latency_p95_ms"],
                                   st["latency_p99_ms"]))
                log(f"[serve batcher] {what}: {st['requests']} requests in {secs:.3f} s, "
                    f"{st['requests'] / secs:.1f} img/s; latency p50 {st['latency_p50_ms']:.3f} p95 "
                    f"{st['latency_p95_ms']:.3f} p99 {st['latency_p99_ms']:.3f} ms; {st['batches']} batches, "
                    f"occupancy {st['occupancy']:.3f}; stage means (ms/batch) drain {st['stage_drain_ms']:.3f} "
                    f"assemble {st['stage_assemble_ms']:.3f} dispatch {st['stage_dispatch_ms']:.3f} resolve "
                    f"{st['stage_resolve_ms']:.3f}; answers against eager batch-1 forwards max abs diff {err:.3g}; "
                    f"warmup {warm_s:.2f} s; pinned slots {executor.pinned_bytes() / 2**20:.1f} MiB; card {card}")
                if st["requests"] != len(answers) or st["timed_out"]:
                    raise AssertionError(f"[serve batcher] {what}: stats {st}")
                if kind == "graph":
                    launches, served = _serve_graphs_ok(what, executor, st["batches"], card)
                    _require_launched(counts, list(launches), f"serve batcher {what}")
                    if stream == "paced" and not sum(n for b, n in served.items() if b < THROUGHPUT_BATCH):
                        raise AssertionError(f"[serve batcher] {what}: no small bucket served {served}")
                del executor, batcher
            spread = {kind: ", ".join(f"{r[0]:.1f} img/s p50 {r[1]:.3f} p99 {r[3]:.3f} ms" for r in rs)
                      for kind, rs in runs.items()}
            mean = {kind: sum(r[0] for r in rs) / len(rs) for kind, rs in runs.items()}
            log(f"[serve batcher] depth {depth} {stream}, turns {'/'.join(SERVE_TURNS)}: graph {spread['graph']}; "
                f"eager {spread['eager']}; graph / eager img/s {mean['graph'] / mean['eager']:.3f}; card {card}")

    what = f"depth {max(SERVE_DEPTHS)} graph, journaled"
    executor = make_executor(tuned, ingest="u8", pipeline_depth=max(SERVE_DEPTHS))
    with tempfile.TemporaryDirectory() as tmp:
        journal = str(Path(tmp) / "requests")
        batcher = batcher_for(executor, max(SERVE_DEPTHS), journal).warmup().start()
        answers, _ = _run_stream(batcher, imgs, bursts, 0.002)
        check(answers, what)
        httpd = _start_http(batcher, 0)
        try:
            for i in range(SERVE_HTTP_REQUESTS):
                got = _http_predict(httpd.server_address[1], imgs[i])
                top5 = [int(c) for c in np.argsort(-want[i])[:5]]
                if got["top5"] != top5:
                    raise AssertionError(f"[serve batcher] /predict top-5 {got['top5']} != eager {top5}")
                log(f"[serve batcher] /predict {i} on 127.0.0.1: top-5 {got['top5']}, the eager top-5")
        finally:
            httpd.shutdown()
        batcher.stop()
        fresh = batcher_for(executor, max(SERVE_DEPTHS)).start()
        futures = replay_request_log(journal, fresh)
        replayed = np.stack([futures[rid].result(timeout=120) for rid in sorted(futures)])
        fresh.stop()
    if len(futures) != len(imgs) + SERVE_HTTP_REQUESTS or not np.array_equal(replayed[:len(imgs)], answers):
        raise AssertionError(f"[serve batcher] the replayed journal ({len(futures)} requests) differs from the "
                             f"original answers")
    _serve_graphs_ok(what, executor, batcher.stats()["batches"] + fresh.stats()["batches"], card)
    log(f"[serve batcher] {what}: the journal of {len(futures)} requests (the /predict ones included) replayed "
        f"into a fresh batcher gives the same answers")
    log(f"[serve batcher] phase took {time.perf_counter() - t_phase:.1f} s")


# ----------------------------------------------------------------- the mesh

MESH_PARTS = (2, 4)  # model degrees whose shards run in turn on the card
MESH_SHARD_BATCH = 32
MESH_ITERS = 10  # timed forwards a turn, at batch THROUGHPUT_BATCH
MESH_RANK_TIMEOUT_S = 600
MESH_ENGINES = ("pallas", "autotuned")


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _per_forward(engine, u8):
    """Launches and routes of one eager single-device forward (the first
    forms the kernels' operands, the second is counted)."""
    from quantized_tpu_torch import ops
    from quantized_tpu_torch.engine import IntExecutor

    ex = IntExecutor(copy.deepcopy(engine), ingest="u8", device="cuda", graphs=False)
    with torch.inference_mode():
        ex(u8)
        torch.cuda.synchronize()
        ops.reset_launches()
        ex(u8)
        torch.cuda.synchronize()
    return {k: v for k, v in ops.launch_counts().items() if v}, ops.route_counts()


def _mesh_ranks(engines, u8, card):
    """``probes/mesh_ranks`` on every GPU (torchrun's variables, NCCL): the
    collectives, ``IntExecutor(mesh=)`` with the collectives captured in its
    graphs against the single-device executor, and ``serve_multihost``.
    Returns each rank's record."""
    import tempfile

    imgs, bursts, _ = _request_stream()
    world = torch.cuda.device_count()
    job = {"device": "cuda", "model_parallel": None, "engines": engines, "u8": u8.cpu(),
           "requests": torch.from_numpy(imgs), "buckets": SERVE_BUCKETS, "bursts": bursts, "iters": MESH_ITERS,
           "serve_engine": "autotuned"}
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(job, Path(tmp) / "job.pt")
        env = {**os.environ, "MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port()),
               "WORLD_SIZE": str(world)}
        procs = [subprocess.Popen([sys.executable, "-m", "quantized_tpu_torch.probes.mesh_ranks", tmp], cwd=ROOT,
                                  env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for r in range(world)]
        try:
            outs = [p.communicate(timeout=MESH_RANK_TIMEOUT_S)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        results = []
        for r, (p, out) in enumerate(zip(procs, outs)):
            path = Path(tmp) / f"rank{r}.json"
            res = json.loads(path.read_text()) if path.exists() else {"error": "no record"}
            if p.returncode != 0 or "error" in res:
                raise AssertionError(f"[mesh] rank {r} exited {p.returncode}: {res.get('error')}\n{out[-4000:]}")
            results.append(res)
    return results


def _record_calls(engine, x):
    """Every ``IntConv2d.run_q`` and ``IntLinear.run_q`` call of one eager
    forward of ``engine``: (name, layer, args, kwargs, output)."""
    from quantized_tpu_torch.engine.int_layers import IntConv2d, IntLinear

    calls = []
    for name, layer in engine.named_modules():
        if isinstance(layer, (IntConv2d, IntLinear)):
            def record(*args, _layer=layer, _name=name, _run=layer.run_q, **kwargs):
                out = _run(*args, **kwargs)
                calls.append((_name, _layer, args, kwargs, out))
                return out

            layer.run_q = record
    with torch.inference_mode():
        engine.run_u8(x)
    for _, layer, _, _, _ in calls:
        del layer.run_q
    return calls


def _shards_in_turn(engine, x):
    """At each model degree of MESH_PARTS, every sharded conv and dense
    layer of the mesh executor's engine (the explicit-TP layer4 among them:
    ``apply_explicit_tp`` runs the same shards in the same forms) run shard
    by shard on the card through their kernels, on the inputs of one
    forward; the shards' outputs concatenated along channels must equal the
    whole layer's, bit for bit. Each shard's launches by kernel and route
    are printed; a shard off the Hopper routes is printed as such. Then the
    explicit-TP fc head: each rank's K block (``head_shard``) multiplied on
    the card, the int32 partials summed as the reduce-scatter sums them,
    each rank's epilogue on its N block, against the whole fc (K1)."""
    from quantized_tpu_torch import ops
    from quantized_tpu_torch.engine.int_layers import IntConv2d
    from quantized_tpu_torch.ops.int8_matmul import acc_epilogue
    from quantized_tpu_torch.parallel.tp_engine import head_shard, int_partial, shard_copies

    calls = _record_calls(engine, x)
    off_hopper = {}
    for parts in MESH_PARTS:
        for name, layer, args, kwargs, whole in calls:
            cout = layer.alpha.shape[0]
            if cout % parts:
                log(f"[mesh] mp {parts} {name}: Cout {cout} does not split, whole on every rank")
                continue
            outs, shard_routes = [], []
            for shard in shard_copies(layer, parts):
                launches0, routes0 = ops.launch_counts(), ops.route_counts()
                with torch.inference_mode():
                    outs.append(shard.run_q(*args, **kwargs))
                launched = {k: n - launches0.get(k, 0) for k, n in ops.launch_counts().items()
                            if n > launches0.get(k, 0)}
                routes = {k: {r: n - routes0.get(k, {}).get(r, 0) for r, n in rs.items()
                              if n > routes0.get(k, {}).get(r, 0)} for k, rs in ops.route_counts().items()}
                shard_routes.append({k: routes.get(k) or {"(no route)": n} for k, n in launched.items()})
            torch.cuda.synchronize()
            got = torch.cat(outs, dim=-1)
            if got.shape != whole.shape or not torch.equal(got.view(torch.int8), whole.view(torch.int8)):
                raise AssertionError(f"[mesh] mp {parts} {name}: the shards differ from the whole layer")
            if not all(shard_routes):
                raise AssertionError(f"[mesh] mp {parts} {name}: a shard launched no kernel of the port")
            general = sorted({f"{k}:{r}" for sr in shard_routes for k, rs in sr.items() for r in rs
                              if r not in HOPPER_ROUTES})
            if general:
                off_hopper[(parts, name)] = general
            stage4 = " (explicit-TP layer4)" if name.startswith("layer4.") and isinstance(layer, IntConv2d) else ""
            same = all(r == shard_routes[0] for r in shard_routes)
            routes_text = (f"each shard {json.dumps(shard_routes[0])}" if same else
                           "; ".join(f"shard {i} {json.dumps(r)}" for i, r in enumerate(shard_routes)))
            log(f"[mesh] mp {parts} {name}{stage4}: Cout {cout} -> {cout // parts} a shard, {parts} shards "
                f"bit-equal to the whole layer; routes: {routes_text}"
                + (f"; off the Hopper route: {', '.join(general)}" if general else ""))
        fc_call = next(c for c in calls if c[0] == "fc")
        _, fc, (x_q,), _, whole = fc_call
        partials, shares = [], [head_shard(fc, i, parts) for i in range(parts)]
        for share in shares:
            xb = x_q[:, share["k_block"][0]:share["k_block"][1]]
            xb = torch.nn.functional.pad(xb, (0, share["pad_k"]))
            partials.append(int_partial(xb, share["w_nk"]))
        total = torch.stack(partials).sum(0).chunk(parts, dim=1)
        logits = torch.cat([acc_epilogue(total[i], sh["alpha"], sh["beta"], fc.relu) for i, sh in enumerate(shares)],
                           dim=1)[:, :shares[0]["n"]]
        if not torch.equal(logits, whole):
            raise AssertionError(f"[mesh] mp {parts} explicit-TP head differs from the whole fc by "
                                 f"{float((logits - whole).abs().max())}")
        k = shares[0]["w_nk"].shape
        log(f"[mesh] mp {parts} explicit-TP fc head: {parts} K blocks of {k[1]} (N padded to {k[0]}), the int32 "
            f"partial on {'torch._int_mm' if x_q.shape[0] >= 17 and k[1] % 8 == 0 else 'the exact product'} "
            f"(JAX's lax.dot_general, outside any kernel), summed as the reduce-scatter sums, the epilogue on each "
            f"N block: bit-equal to the whole fc (K1)")
    return off_hopper


def phase_mesh(tuned, card):
    """The mesh serving path: ``probes/mesh_ranks`` on every GPU over NCCL
    (the float-BN ResNet-50 at full width on "pallas" and its autotuned
    form; ``IntExecutor(mesh=)`` bit-equal to the single-device executor,
    its launches per forward by kernel and route equal to the single-device
    forward's, its collectives per forward printed, its graphs capturing the
    collectives; ``serve_multihost`` over the tuned engine at buckets 1, 8,
    32 and 128), the forward ms at batch 128 beside the single-device
    executor's and the served burst's latencies with the card; then the
    shards in turn at model degrees 2 and 4 (``_shards_in_turn``). Returns
    the mesh path's launches per forward (the "pallas" engine on rank 0)."""
    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(23)
    u8 = torch.randint(0, 256, (THROUGHPUT_BATCH, 224, 224, 3), generator=gen, dtype=torch.uint8).cuda()
    engines = {"pallas": _build("resnet50", "pallas", "cuda"), "autotuned": tuned}
    single = {name: _per_forward(eng, u8) for name, eng in engines.items()}
    ranks = _mesh_ranks(engines, u8, card)
    _require_launched(single["pallas"][0], ["int8_conv_direct", "int8_conv_direct_gatherk", "int8_matmul"],
                      "mesh pallas")
    for res in ranks:
        if res["backend"] != "nccl":
            raise AssertionError(f"[mesh] rank {res['rank']} ran {res['backend']}, not NCCL")
        log(f"[mesh] rank {res['rank']}/{res['world']} on {res['device']}, mesh {json.dumps(res['mesh'])}, "
            f"{res['backend']}: collectives {json.dumps(res['collectives'])}; {res['seconds']:.1f} s")
        for name in MESH_ENGINES:
            e = res["engines"][name]
            launches, routes = single[name]
            if e["launches_per_forward"] != launches or e["routes_per_forward"] != routes:
                raise AssertionError(f"[mesh] {name}: mesh launches {e['launches_per_forward']} routes "
                                     f"{e['routes_per_forward']}, single-device {launches} {routes}")
            stats = e["graphs"][str((THROUGHPUT_BATCH, 224, 224, 3))]
            _captured_routes_ok(f"mesh {name}", stats)
            single_ms, mesh_ms = e["ms"]["single"], e["ms"]["mesh"]
            log(f"[mesh] {name}: logits at batch {e['batch']} bit-equal to the single-device executor's (graph "
                f"and eager); launches a forward {json.dumps(e['launches_per_forward'])}, by route "
                f"{json.dumps(e['routes_per_forward'])}, the single-device forward's; collectives a forward "
                f"{json.dumps(e['collectives_per_forward'])} ({e['sharded'][0]} convs and {e['sharded'][1]} dense "
                f"layers sharded), captured in the graph; forward ms at batch {e['batch']}, graphs, turns "
                f"single/mesh/mesh/single: single {', '.join(f'{v:.3f}' for v in single_ms)}, mesh "
                f"{', '.join(f'{v:.3f}' for v in mesh_ms)}, mesh / single {sum(mesh_ms) / sum(single_ms):.3f}; "
                f"card {card}")
        sv = res["serve"]
        if sv["buckets_captured"] != list(SERVE_BUCKETS):
            raise AssertionError(f"[mesh] serve_multihost captured {sv['buckets_captured']}")
        log(f"[mesh] serve_multihost (autotuned, buckets {SERVE_BUCKETS}, one graph each): {sv['requests']} "
            f"requests in {sv['batches']} batches, {sv['seconds']:.3f} s, {sv['requests'] / sv['seconds']:.1f} img/s, "
            f"latency p50 {sv['latency_p50_ms']:.3f} p99 {sv['latency_p99_ms']:.3f} ms, occupancy "
            f"{sv['occupancy']:.3f}; every answer bit-equal to a batch-1 forward; card {card}")
    off_hopper = _shards_in_turn(engines["pallas"], u8[:MESH_SHARD_BATCH])
    log(f"[mesh] shards in turn: {len(off_hopper)} (degree, layer) pairs with a shard off the Hopper route: "
        f"{json.dumps({f'{p} {n}': r for (p, n), r in off_hopper.items()})}")
    log(f"[mesh] phase took {time.perf_counter() - t_phase:.1f} s")
    return ranks[0]["engines"]["pallas"]["launches_per_forward"]


def phase_cli(card):
    """``quantized_tpu_torch.cli.main.main`` in-process on the calibrated
    ResNet-50 (``resnet_quantized_float_bn``, depth 50, ImageNet geometry,
    the synthetic stand-in's 512 validation images), ``--calibrate 2
    --convert-int --resident -b 128``: once with ``-e`` (top-1 and top-5
    printed), once with ``--serve --serve-steps 20 --serve-u8
    --serve-pipeline 4``; both must return 0."""
    import contextlib
    import io
    import tempfile

    from quantized_tpu_torch.cli.main import main as cli_main

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        common = ["--model", "resnet_quantized_float_bn", "--dataset", "imagenet", "--model_config",
                  "{'depth': 50}", "--calibrate", "2", "--convert-int", "--resident", "-b", str(THROUGHPUT_BATCH),
                  "--results_dir", tmp]
        for what, extra in (("eval", ["-e"]),
                            ("serve", ["--serve", "--serve-steps", "20", "--serve-u8", "--serve-pipeline", "4"])):
            out = io.StringIO()
            t = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = cli_main(common + ["--save", what] + extra)
            printed = out.getvalue().strip().splitlines()
            log(f"[cli] {what}: rc {rc} in {time.perf_counter() - t:.1f} s; printed {printed[-1:] or '(nothing)'}; "
                f"card {card}")
            if rc != 0:
                raise AssertionError(f"[cli] {what} returned {rc}")
            if what == "eval" and not (printed and "top1" in printed[-1] and "top5" in printed[-1]):
                raise AssertionError(f"[cli] eval printed no top1/top5: {printed}")
    log(f"[cli] phase took {time.perf_counter() - t_phase:.1f} s")

# the "train" phase: QAT on the card, then the trained models converted and served
TRAIN_STEPS = 6  # the flagship's checked SGD steps, as JAX's flagship test takes them
TRAIN_FLAGSHIP_BATCH = 64
TRAIN_BATCH = 128  # the timed variants
TRAIN_REGIME = {0: {"optimizer": "SGD", "lr": 0.01, "momentum": 0.9}}
# label: (registered model, compute dtype, variant of probes/train_step), ResNet-50 at TRAIN_BATCH
TRAIN_VARIANTS = {
    "float-BN f32": ("resnet_quantized_float_bn", "f32", "full"),
    "float-BN bf16": ("resnet_quantized_float_bn", "bf16", "full"),
    "flagship": ("resnet_quantized", "f32", "full"),
    "flagship nobiprec": ("resnet_quantized", "f32", "nobiprec"),
    "flagship nogradq": ("resnet_quantized", "f32", "nogradq"),
}
# one SGD step of CIFAR ResNet-20 at batch TRAIN_PARITY_BATCH on the card against its CPU twin, from the same
# weights: model -> (loss rtol, update rtol of the norm of all parameters' updates, per-tensor rtol against the
# larger of the tensor's magnitude and the largest step), each about twice the larger of two distances that
# tests/torch_trainer_spread.py (case "chip") measures for this very step on the CPU: JAX's own Trainer jitted
# against eager, and the CPU port against JAX (the loss bound at least 1e-5). The float ``resnet`` 9e-8, 1.4e-3, 5.4e-4 (BN biases are sums with
# cancellation; the port against JAX 2.8e-7, 8.0e-3, 2.3e-3); ``resnet_quantized_float_bn`` 4.5e-4, 0.26, 0.086 (a
# fake-quant boundary moved by one ulp of a conv sum rounds to the other step; the port against JAX 1.4e-4, 0.26,
# 0.046)
TRAIN_PARITY_BATCH = 32
TRAIN_PARITY_REGIME = {0: {"optimizer": "SGD", "lr": 0.05, "momentum": 0.9, "weight_decay": 1e-4}}
TRAIN_PARITY_TOL = {"resnet": (1e-5, 0.02, 5e-3), "resnet_quantized_float_bn": (1e-3, 0.5, 0.15)}
TRAIN_STATS = ("mean", "var", "running_mean", "running_var", "running_min", "running_max")
TRAIN_CLI_TIMEOUT_S = 300
LIBRARY_PRODUCTS = ("xmma", "cudnn", "implicit_gemm", "wgrad", "dgrad", "fprop", "gemm", "cutlass", "sm90_", "sm80_")


def _no_kernel_launched(what):
    """The training path launches none of the port's hand-written kernels
    (the counts were set to 0 just before it)."""
    from quantized_tpu_torch import ops

    torch.cuda.synchronize()
    launched = {k: n for k, n in ops.launch_counts().items() if n}
    if launched:
        raise AssertionError(f"{what}: hand-written kernels launched in training: {launched}")


def _train_flagship(card):
    """``resnet_quantized`` (the flagship: 8-bit gradients, bi-precision),
    ImageNet ResNet-50, TRAIN_STEPS SGD steps at batch TRAIN_FLAGSHIP_BATCH
    on the synthetic ImageNet stand-in through ``Trainer`` on the card, then
    the checks of JAX's ``test_grad_quant_biprec_trainer_step_flagship``.
    Returns the trained model (on the card)."""
    from quantized_tpu_torch import ops
    from quantized_tpu_torch.data import get_dataset, get_transform
    from quantized_tpu_torch.models import get_model
    from quantized_tpu_torch.models import layers as L
    from quantized_tpu_torch.training import Trainer

    what = "train flagship"
    data = get_dataset("imagenet", "train", get_transform("imagenet", augment=False))
    batches = [b for _, b in zip(range(TRAIN_STEPS), data.batches(TRAIN_FLAGSHIP_BATCH, drop_remainder=True))]
    model = get_model("resnet_quantized")(dataset="imagenet", depth=50, generator=torch.Generator().manual_seed(0))
    qconvs = [m for m in model.modules() if isinstance(m, L.QConv2d)]
    rbns = [m for m in model.modules() if isinstance(m, L.RangeBN)]
    if not (qconvs and rbns and all(c.num_bits_grad == 8 and c.biprecision for c in qconvs)
            and model.fc.num_bits_grad == 8 and model.fc.biprecision and all(b.num_bits_grad == 8 for b in rbns)):
        raise AssertionError(f"{what}: the flagship constants are not wired into every layer")
    p_before = {k: v.detach().clone() for k, v in model.named_parameters()}
    ema_before = model.conv1.quantize_input.running_max.clone()
    bn_before = rbns[0].running_mean.clone()
    streams = [m.grad_quant_rng for m in model.modules() if hasattr(m, "grad_quant_rng")]
    counts_before = [st.count for st in streams]
    trainer = Trainer(model, regime=TRAIN_REGIME, print_freq=10**6, device="cuda")
    torch.cuda.synchronize()
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    m0 = trainer.train_epoch(batches, 0)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    _no_kernel_launched(what)
    peak = torch.cuda.max_memory_allocated() / 2**20
    moved = {k: (p.detach().cpu() - p_before[k]).abs().max().item() for k, p in model.named_parameters()}
    bad = [k for k, d in moved.items() if not (math.isfinite(d) and d > 0)]
    if bad or not all(torch.isfinite(p).all() for p in model.parameters()):
        raise AssertionError(f"{what}: parameters that did not move or are not finite: {bad[:8]}")
    if torch.equal(model.conv1.quantize_input.running_max.cpu(), ema_before) or torch.equal(
            rbns[0].running_mean.cpu(), bn_before):
        raise AssertionError(f"{what}: the observers' EMA or RangeBN's running statistics did not move")
    if not all(st.count == c + TRAIN_STEPS for st, c in zip(streams, counts_before)):
        raise AssertionError(f"{what}: a grad-quant stream did not advance once per step")
    t = time.perf_counter()
    m1 = trainer.train_epoch(batches, 1)
    secs1 = time.perf_counter() - t
    log(f"[{what}] ResNet-50 (resnet_quantized, ImageNet), batch {TRAIN_FLAGSHIP_BATCH}, {TRAIN_STEPS} steps of SGD "
        f"lr 0.01 momentum 0.9 on the card: loss {m0['loss']:.4f}, then {m1['loss']:.4f} over a second pass of the "
        f"same batches; {len(moved)} parameters all moved and finite (smallest max step {min(moved.values()):.3g}); "
        f"conv1's observer max {ema_before.item():.4g} -> {model.conv1.quantize_input.running_max.item():.4g}; "
        f"{len(streams)} grad-quant streams each advanced by {TRAIN_STEPS}; host wall {secs / TRAIN_STEPS * 1e3:.1f} / "
        f"{secs1 / TRAIN_STEPS * 1e3:.1f} ms a step (the batch copied in and the loss read each step); peak memory "
        f"{peak:.0f} MiB; no hand-written kernel launched; card {card}")
    if not (math.isfinite(m0["loss"]) and math.isfinite(m1["loss"]) and m1["loss"] < m0["loss"]):
        raise AssertionError(f"{what}: the loss did not fall over the second pass: {m0['loss']} -> {m1['loss']}")
    return model


def _train_variants(card, timer):
    """ResNet-50 train steps at TRAIN_BATCH through ``probes/train_step``:
    the float-BN model in f32 and bf16 and the flagship in its three
    variants, each with its device ms, its ms between CUDA events (host
    launches in), img/s, peak memory, and the profiler's kernel ms, idle
    share and launches per step. Returns the float-BN f32 model (trained by
    its timed steps)."""
    from quantized_tpu_torch import ops
    from quantized_tpu_torch.probes.train_step import build, make_step, step_times

    kept, numbers = None, {}
    for label, (name, dtype, variant) in TRAIN_VARIANTS.items():
        what = f"train {label}"
        model, x, y = build(TRAIN_BATCH, name, 50, dtype, "imagenet", variant)
        step = make_step(model, x, y)
        torch.cuda.synchronize()
        ops.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        ms, event_ms = step_times(step, timer)
        peak = torch.cuda.max_memory_allocated() / 2**20
        loss = float(step())
        _no_kernel_launched(what)
        prof = _profile(lambda _: step(), x, event_ms, f"{what} batch {TRAIN_BATCH}", n_prof=2, unit="step")
        numbers[label] = (ms, event_ms, peak, prof)
        if prof:  # the library's convs and products against the elementwise passes and reductions around them
            lib = sum(us for us, _, key in prof[3] if any(k in key for k in LIBRARY_PRODUCTS)) / 1e3
            log(f"[{what}] convs and products (cuDNN, cuBLAS) {lib:.2f} ms, elementwise passes and reductions "
                f"{prof[0] - lib:.2f} ms of the step's {prof[0]:.2f} kernel ms")
        log(f"[{what}] ResNet-50 ({name}, {dtype}, {variant}) batch {TRAIN_BATCH} fwd+bwd+SGD: {ms:.2f} ms device "
            f"({TRAIN_BATCH / ms * 1e3:.1f} img/s), {event_ms:.2f} ms between events with the host's launches "
            f"({TRAIN_BATCH / event_ms * 1e3:.1f} img/s); peak memory {peak:.0f} MiB; "
            + (f"kernels {prof[0]:.2f} ms, idle share {prof[1]:.3f}, {prof[2]} launches a step; " if prof else "")
            + f"loss {loss:.4f}; card {card}")
        if not math.isfinite(loss):
            raise AssertionError(f"{what}: non-finite loss {loss}")
        if label == "float-BN f32":
            kept = model
        del model, x, y, step
        torch.cuda.empty_cache()
    full, nobi, nogq = (numbers[k][1] for k in ("flagship", "flagship nobiprec", "flagship nogradq"))
    f32, bf16 = numbers["float-BN f32"][1], numbers["float-BN bf16"][1]
    log(f"[train] between events: bi-precision's second product {full - nobi:.2f} ms of the flagship's {full:.2f} "
        f"({(full - nobi) / full:.3f}); gradient quantization {nobi - nogq:.2f} ms ({(nobi - nogq) / full:.3f}); "
        f"bf16 / f32 float-BN {bf16 / f32:.3f}; card {card}")
    return kept


def _train_parity():
    """One SGD step of CIFAR ResNet-20 (the float ``resnet``, then
    ``resnet_quantized_float_bn``) at batch TRAIN_PARITY_BATCH through
    ``Trainer`` on the card and on the CPU from the same weights: the loss
    and every parameter and buffer after it, held to TRAIN_PARITY_TOL."""
    from quantized_tpu_torch.models import get_model
    from quantized_tpu_torch.training import Trainer

    gen = torch.Generator().manual_seed(3)
    batch = [(torch.randn((TRAIN_PARITY_BATCH, 32, 32, 3), generator=gen).numpy(),
              torch.randint(0, 10, (TRAIN_PARITY_BATCH,), generator=gen).numpy())]
    for name, (loss_tol, update_tol, tensor_tol) in TRAIN_PARITY_TOL.items():
        cpu_model = get_model(name)(dataset="cifar10", depth=20, generator=torch.Generator().manual_seed(0))
        gpu_model = copy.deepcopy(cpu_model)
        before = {k: v.clone() for k, v in cpu_model.state_dict().items()}
        want = Trainer(cpu_model, regime=TRAIN_PARITY_REGIME, print_freq=10**6, device="cpu").train_epoch(batch, 0)
        got = Trainer(gpu_model, regime=TRAIN_PARITY_REGIME, print_freq=10**6, device="cuda").train_epoch(batch, 0)
        cpu_after = cpu_model.state_dict()
        gpu_after = {k: v.cpu() for k, v in gpu_model.state_dict().items()}
        params = [k for k in cpu_after if not k.endswith(TRAIN_STATS)]
        step = max((cpu_after[k] - before[k]).abs().max().item() for k in params)
        du = torch.cat([(gpu_after[k] - cpu_after[k]).ravel() for k in params]).norm().item()
        u = torch.cat([(cpu_after[k] - before[k]).ravel() for k in params]).norm().item()
        worst = max(((gpu_after[k] - v).abs().max().item() / max(v.abs().max().item(), step), k)
                    for k, v in cpu_after.items())
        loss_err = abs(got["loss"] - want["loss"]) / abs(want["loss"])
        log(f"[train parity] {name} CIFAR ResNet-20, one SGD step at batch {TRAIN_PARITY_BATCH}, card against CPU: "
            f"loss {got['loss']:.6f} / {want['loss']:.6f} (relative {loss_err:.3g}, tolerance {loss_tol}); the "
            f"update {du / u:.3g} of its norm (tolerance {update_tol}); worst tensor {worst[1]} {worst[0]:.3g} of "
            f"its scale (tolerance {tensor_tol})")
        if not (loss_err <= loss_tol and du <= update_tol * u and worst[0] <= tensor_tol):
            raise AssertionError(f"train parity {name}: the card's step left the CPU's beyond "
                                 f"{TRAIN_PARITY_TOL[name]}")


def _train_convert_serve(float_bn, flagship):
    """Each trained ResNet-50 in eval mode through ``build_int8_resident(...,
    backend="pallas")``, served by ``IntExecutor`` (3 requests of 32, the
    counts set to 0 just before and read just after), every K1 and K2
    launch on its Hopper route ("sm90+clip" on the flagship's clamped
    convs), stage by stage against the same engine built on the CPU."""
    from quantized_tpu_torch.engine import IntExecutor, build_int8_resident

    requests = _requests(224)
    sample = requests[0][:2]
    counts = {}
    float_routes = {k: {"sm90": n} for k, n in PLANS["resnet50"][0].items()}
    for what, model, route, routes in (("train float-bn serve", float_bn, "sm90", float_routes),
                                       ("train flagship serve", flagship, "sm90+clip", RANGEBN_ROUTES)):
        host = copy.deepcopy(model).eval().cpu()
        engine = build_int8_resident(copy.deepcopy(host), backend="pallas", device="cuda")
        executor = IntExecutor(engine, ingest="u8", device="cuda", graphs=False)
        executor.warmup(sample)
        counts[what] = _serve(what, executor, requests, PLANS["resnet50"][0], 1000, route=route)
        _per_forward_routes(what, PATH_ROUTES[what], routes, len(requests))
        cpu_engine = build_int8_resident(host, backend="pallas", device="cpu")
        _compare_stages(_stage_outputs(engine, sample.cuda()), _stage_outputs(cpu_engine, sample),
                        f"{what} gpu vs cpu")
        del engine, executor, cpu_engine
    return counts


def _train_cli(card):
    """``python -m quantized_tpu_torch.cli.main --model mnist --dataset mnist
    -b 32 --epochs 1`` on the card, three processes at once: one plain run
    and two ``--deterministic --seed 7`` runs, each exiting 0 with its
    ``results.csv`` and checkpoint, the two deterministic files equal."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        base = [sys.executable, "-m", "quantized_tpu_torch.cli.main", "--model", "mnist", "--dataset", "mnist",
                "-b", "32", "--epochs", "1", "--results_dir", tmp]
        runs = {"plain": ["--save", "plain"], "det_a": ["--save", "det_a", "--deterministic", "--seed", "7"],
                "det_b": ["--save", "det_b", "--deterministic", "--seed", "7"]}
        t = time.perf_counter()
        procs = {name: subprocess.Popen(base + extra, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True) for name, extra in runs.items()}
        try:
            outs = {name: p.communicate(timeout=TRAIN_CLI_TIMEOUT_S) for name, p in procs.items()}
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        csvs = {}
        for name, p in procs.items():
            run = Path(tmp) / name
            tail = outs[name][1].strip().splitlines()[-1:] or ["(nothing)"]
            log(f"[train cli] {name}: rc {p.returncode}; {tail[0][:160]}")
            if p.returncode != 0 or not (run / "results.csv").exists() or not (run / "checkpoint.pt").exists():
                files = sorted(os.listdir(run)) if run.exists() else None
                raise AssertionError(f"[train cli] {name}: rc {p.returncode}, files {files}:\n{outs[name][1][-2000:]}")
            if "device: cuda" not in (run / "log.txt").read_text():
                raise AssertionError(f"[train cli] {name} did not run on the card")
            csvs[name] = (run / "results.csv").read_text()
        if csvs["det_a"] != csvs["det_b"]:
            raise AssertionError(f"[train cli] --deterministic runs differ:\n{csvs['det_a']}\n{csvs['det_b']}")
        log(f"[train cli] mnist one epoch, three processes in {time.perf_counter() - t:.1f} s on {card}; the "
            f"deterministic results.csv equal: {csvs['det_a'].splitlines()[-1]}")


def phase_train(card, timer):
    """QAT on the card (see the module docstring, phase 11). Returns the
    serve paths' counts."""
    t_phase = time.perf_counter()
    flagship = _train_flagship(card)
    float_bn = _train_variants(card, timer)
    _train_parity()
    counts = _train_convert_serve(float_bn, flagship)
    del float_bn, flagship
    torch.cuda.empty_cache()
    _train_cli(card)
    log(f"[train] phase took {time.perf_counter() - t_phase:.1f} s")
    return counts


def main() -> int:
    require_environment()
    from quantized_tpu_torch import ops
    from quantized_tpu_torch.utils.timing import Timer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, card = phase_device()
    log(f"[predictions] {PREDICTIONS}")
    phase_build()
    timer = Timer("cuda")
    kernel_numbers = phase_kernels(timer)
    executors, path_counts = {}, {}
    path_counts["conv sweep"], _ = phase_conv_sweep()
    path_counts["conv ops"] = phase_conv_ops()
    path_counts["copy probe"], _ = phase_copy_probe()
    path_counts["fused stages"], _ = phase_fused_stages()
    for key in ("resnet50", "resnet18", "cifar20", "mobilenet", "mobilenet w0.75"):
        executors[key], counts = phase_model(key)
        path_counts.update(counts)
    executors["alexnet"], counts = phase_alexnet()
    path_counts.update(counts)
    executors["resnet50"]["int4"], counts = phase_resnet50_int4()
    path_counts.update(counts)
    executors["resnet50"]["rangebn"], counts, rangebn_extra = phase_rangebn()
    path_counts.update(counts)
    for key in ("resnet50", "resnet18", "mobilenet", "mobilenet w0.75"):
        phase_throughput(key, executors[key], card, timer)
    for batch in ALEXNET_BATCHES:
        phase_throughput("alexnet", executors["alexnet"], card, timer, batch=batch)
    phase_graphs(executors, rangebn_extra, card)
    del executors, rangebn_extra
    torch.cuda.empty_cache()
    counts, tuned = phase_autotune(card, timer)
    path_counts.update(counts)
    phase_serve_batcher(tuned, card)
    mesh_launches = phase_mesh(tuned, card)
    del tuned
    torch.cuda.empty_cache()
    phase_cli(card)
    path_counts.update(phase_train(card, timer))

    kernels = []
    for kname, (source, replaces) in KERNEL_INFO.items():
        numbers = kernel_numbers[kname]
        path = KERNEL_PATH.get(kname, "resnet50 serve")
        kernels.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": path_counts[path][kname], "max_abs_err": numbers["max_abs_err"], "ms": numbers["ms"],
            "plain_ms": numbers["plain_ms"], "bound_ms": numbers["bound_ms"],
            "bound_by": numbers["bound_by"], "library_ms": numbers["library_ms"],
            "event_ms": numbers["event_ms"], "path": path, "case": numbers["case"],
            "launches_autotuned": {key: path_counts[f"{key} autotuned"][kname] for key in AUTOTUNE_MODELS},
            "launches_rangebn": path_counts["resnet50 rangebn serve"][kname],
            "launches_mesh": mesh_launches.get(kname, 0),
        })
        if "clip" in numbers:  # the CLIP instances beside the unclamped ones on the same inputs
            kernels[-1]["clip"] = numbers["clip"]
        if kname in PATH_ROUTES.get(path, {}):  # K2 and B7: their launches on the path by route
            kernels[-1]["routes"] = PATH_ROUTES[path][kname]
        # B6: K1 unpacked; B7 and B8: K2 on the same inputs; B8: the general tile on the same inputs
        for extra in ("int8_matmul_ms", "int8_conv_direct_ms", "tile_ms"):
            if extra in numbers:
                kernels[-1][extra] = numbers[extra]
        if kernels[-1]["launches"] <= 0:
            raise AssertionError(f"{kname} was not launched on its path")
    if set(ops.KERNELS) != set(KERNEL_INFO):
        raise AssertionError(f"kernels {sorted(ops.KERNELS)} are not the ones this script reports")
    log(f"[done] whole run {time.perf_counter() - T_START:.1f} s after the imports")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
