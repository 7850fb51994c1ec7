"""int8 GEMM with the fused dequant/requant epilogue (kernel K1).

Integer contract (as in the JAX package): activations are logical uint8
``u`` on [0, 255] with integer zero-point ``zp``, stored as int8 ``a = u -
128``; weights are symmetric int8 with per-output-channel scales. The real
product folds into one per-column affine of the int32 accumulator:

    y_c = acc_c * alpha_c + beta_c
    alpha_c = s_a * s_wc
    beta_c  = alpha_c * (128 - zp) * colsum_c + bias_c

Public functions keep the JAX layouts: ``b`` is (K, N). The kernel wants the
weights K-major, (N, K); :class:`~quantized_tpu_torch.engine.int_layers.IntLinear`
stores that copy once, at build time, and calls the ``*_nk`` wrappers.

A wrapper given CPU tensors runs the plain PyTorch version; given CUDA
tensors it launches the CUDA kernel (``csrc/int8_gemm.cu``) or raises, with
the launch plan of :func:`gemm_plan` and the route of :func:`gemm_route`,
which the C entry refuses where its shape and bases take the other one, and
counts the launch by that route.

:func:`int8_matmul_xla` is the JAX package's XLA form of the same product
(no kernel of its own: the fc autotuner races it against K1).
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from quantized_tpu_torch.ops import _cuda

GEMM_PLAN_ARGS = ["int"] * 6  # the C entries' trailing arguments: the route (1: "sm90"), GemmPlan.args()
_MATMUL = _cuda.CudaKernel(
    "int8_matmul", "int8_gemm.cu", "qt_int8_matmul",
    ["ptr"] * 5 + ["int"] * 4 + GEMM_PLAN_ARGS,
)
_MATMUL_REQUANT = _cuda.CudaKernel(
    "int8_matmul_requant", "int8_gemm.cu", "qt_int8_matmul_requant",
    ["ptr"] * 5 + ["int"] * 3 + ["float"] * 3 + GEMM_PLAN_ARGS,
)

# The launch plan of the Hopper GEMM (csrc/gemm_sm90.cuh), shared by K1 and
# B6; the constants mirror the header's.
GEMM_BK = 128  # K bytes per ring stage
GEMM_WROWS = 64  # weight rows per block
GEMM_TILES = (8, 16, 32, 64, 128)  # batch rows per block: wgmma's N
GEMM_MAX_SPLIT = 8  # blocks of one cluster, the portable limit
GEMM_MAX_STAGES = 8
GEMM_RING_BUDGET = 110 * 1024  # ring bytes per block where two blocks share an SM
GEMM_INFLIGHT_STAGES = 1024  # ring slots in flight across the card: 8 MB of weight tiles
GEMM_OUT_PITCH = 80
SMEM_LIMIT = 232448  # opt-in shared memory of one block on the H100
H100_SMS = 132


class GemmPlan(NamedTuple):
    tile: int  # batch rows per block (wgmma's N), a multiple of 8
    split: int  # blocks along K, one cluster
    steps: int  # K stages of GEMM_BK bytes per split
    stages: int  # ring slots in flight per block
    smem: int  # dynamic shared memory per block, bytes
    blocks: int  # the grid: split x ceil(N/64) x ceil(M/tile)
    tma_shape: bool  # the shape suits TMA (16-byte row pitches); the C entry also needs
    # 16-byte-aligned bases, and runs the general tile where either fails

    def args(self) -> List[int]:
        """The C entry's plan arguments."""
        return [self.tile, self.split, self.steps, self.stages, self.smem]

    def k_ranges(self, kspan: int) -> List[Tuple[int, int]]:
        """The K bytes [begin, end) of each split (for B6: of the packed half)."""
        step = self.steps * GEMM_BK
        return [(s * step, min((s + 1) * step, kspan)) for s in range(self.split)]


def gemm_smem_bytes(tile: int, packed: bool, split: int, stages: int) -> int:
    """``smem_bytes`` of gemm_sm90.cuh: 1024 bytes of alignment slack, the
    ring (reused for the split's partial sums and the staged s8 tile), and one
    8-byte mbarrier per slot."""
    stage = GEMM_WROWS * GEMM_BK + tile * GEMM_BK * (2 if packed else 1)
    red = 128 * (tile // 2) * 4 if split > 1 else 0
    return 1024 + max(stages * stage, red, tile * GEMM_OUT_PITCH) + 8 * stages


@functools.lru_cache(maxsize=4096)  # a wrapper plans every call; the engines repeat a few shapes
def gemm_plan(m: int, n: int, k: int, packed: bool = False, sms: int = H100_SMS) -> GemmPlan:
    """The launch plan of an (m, k) x (n, k)^T product (``packed``: k is A's
    width and the weights hold ceil(k/2) packed bytes a row).

    - tile: the smallest of 8, 16, 32, 64, 128 that holds the batch rows
      (128 past 64, over several row tiles);
    - split: K cut into runs of whole 128-byte stages, none empty, as many
      (up to 8) as it takes for the blocks to reach half the SMs: at the fc
      heads that is 64 to 128 blocks of one wave;
    - stages: up to 8 ring slots per block, at most GEMM_INFLIGHT_STAGES
      across the blocks that run at once (past that, the ring slots in
      flight slow the weight stream down), within the block's share of
      shared memory (all of it where every block has an SM, else
      GEMM_RING_BUDGET), at least 3 and at most the split's stages.

    ``python -m quantized_tpu_torch.probes.gemm_sweep --plans`` times these
    rules against every other plan at AlexNet's and the ResNet fc's products."""
    kspan = (k + 1) // 2 if packed else k
    tile = next((t for t in GEMM_TILES if t >= m), GEMM_TILES[-1])
    nk = -(-kspan // GEMM_BK)
    tiles = -(-n // GEMM_WROWS) * -(-m // tile)
    split = max(1, min(GEMM_MAX_SPLIT, nk, -(-(sms // 2) // tiles)))
    steps = -(-nk // split)
    split = -(-nk // steps)
    blocks = split * tiles
    stage = GEMM_WROWS * GEMM_BK + tile * GEMM_BK * (2 if packed else 1)
    ring = SMEM_LIMIT - 2048 if blocks <= sms else GEMM_RING_BUDGET  # 2048: alignment slack, mbarriers
    fits = min(GEMM_INFLIGHT_STAGES // min(blocks, 2 * sms), ring // stage)
    stages = min(steps, GEMM_MAX_STAGES, max(3, fits))
    tma_shape = kspan % 16 == 0 and (not packed or k == 2 * kspan)
    return GemmPlan(tile, split, steps, stages, gemm_smem_bytes(tile, packed, split, stages), blocks, tma_shape)


def gemm_route(plan: GemmPlan, a: torch.Tensor, w: torch.Tensor) -> str:
    """The route of a launch (``qt90::tma_ok``, which the C entry checks it
    against): the Hopper GEMM ("sm90") where the shape suits TMA and both
    operands start on 16 bytes, else the general tile."""
    return "sm90" if plan.tma_shape and a.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0 else "tile"


def f32(v: float) -> float:
    """The float32 value of a Python scalar, as ``jnp.float32(v)`` makes it."""
    return float(np.float32(v))


def matmul_epilogue_params(
    act_scale: float,
    act_zero_point: int,
    weight_scale: torch.Tensor,  # (N,) f32 per-channel (or scalar broadcast)
    weight_colsum: torch.Tensor,  # (N,) int32: sum_k w[k, c]
    bias: Optional[torch.Tensor] = None,  # (N,) f32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Precompute (alpha, beta) for the fused epilogue, in float32 and in the
    JAX package's order of operations."""
    ws = torch.broadcast_to(torch.as_tensor(weight_scale, dtype=torch.float32), weight_colsum.shape)
    alpha = torch.tensor(f32(act_scale), dtype=torch.float32) * ws
    beta = alpha * torch.tensor(f32(128 - act_zero_point), dtype=torch.float32) * weight_colsum.to(torch.float32)
    if bias is not None:
        beta = beta + torch.as_tensor(bias, dtype=torch.float32)
    return alpha, beta


def requant_scalars(out_scale: float, out_zp: int, relu: bool) -> Tuple[float, float, float]:
    """(inv, zps, lo) of the requant epilogue: ``inv = f32(1/s)``, ``zps =
    zp - 128``, ``lo`` = the clip floor (zps when ReLU is folded in)."""
    inv = f32(1.0 / out_scale)
    zps = f32(out_zp - 128)
    lo = zps if relu else -128.0
    return inv, zps, lo


def exact_int_matmul(a: torch.Tensor, w_nk: torch.Tensor) -> torch.Tensor:
    """int32 ``a @ w_nk.T`` for int8 operands, exactly: int32 on the CPU;
    float64 on a GPU, which has no integer matmul (|acc| <= 128*127*K stays
    far below 2**53, so every partial sum is exact)."""
    if a.is_cuda:
        return (a.to(torch.float64) @ w_nk.to(torch.float64).T).to(torch.int32)
    return a.to(torch.int32) @ w_nk.to(torch.int32).T


def acc_epilogue(acc: torch.Tensor, alpha, beta, relu: bool = False,
                 out_requant: Optional[Tuple[float, int]] = None) -> torch.Tensor:
    """The fused epilogue of an int32 accumulator, in the JAX kernels' order:
    f32 ``relu?(acc * alpha + beta)``, or, on ``out_requant=(s, zp)``, s8
    ``clip(round(acc * (alpha * inv) + (beta * inv + zp - 128)), lo, 127)``
    with 1/s folded into alpha and beta, the -128 shift into the zero point
    and ReLU into the clip floor ``lo``."""
    if out_requant is None:
        y = acc.to(torch.float32) * alpha + beta
        return torch.clamp_min(y, 0.0) if relu else y
    inv, zps, lo = requant_scalars(out_requant[0], out_requant[1], relu)
    q = torch.round(acc.to(torch.float32) * (alpha * inv) + (beta * inv + zps))
    return torch.clamp(q, lo, 127.0).to(torch.int8)


def int8_matmul_plain(a, w_nk, alpha, beta, relu: bool = False) -> torch.Tensor:
    """Plain version of K1's f32 form: ``relu?(A @ W^T * alpha + beta)``."""
    return acc_epilogue(exact_int_matmul(a, w_nk), alpha, beta, relu)


def int8_matmul_requant_plain(a, w_nk, alpha, beta, out_scale: float, out_zp: int,
                              relu: bool = True) -> torch.Tensor:
    """Plain version of K1's requant form (``_requant_kernel``'s order)."""
    return acc_epilogue(exact_int_matmul(a, w_nk), alpha, beta, relu, (out_scale, out_zp))


def _check(a, w_nk, alpha, beta):
    if a.ndim != 2 or w_nk.ndim != 2 or a.shape[1] != w_nk.shape[1]:
        raise ValueError(f"shapes {tuple(a.shape)} x {tuple(w_nk.shape)}^T do not multiply")
    n = w_nk.shape[0]
    if alpha.shape != (n,) or beta.shape != (n,):
        raise ValueError(f"alpha/beta must have shape ({n},)")
    _cuda.check_dtype(a, torch.int8, "a")
    _cuda.check_dtype(w_nk, torch.int8, "w")
    _cuda.check_dtype(alpha, torch.float32, "alpha")
    _cuda.check_dtype(beta, torch.float32, "beta")


def int8_matmul_nk(a, w_nk, alpha, beta, relu: bool = False) -> torch.Tensor:
    """f32 ``relu?(A @ W^T * alpha + beta)``; A (M, K) s8, W (N, K) s8."""
    _check(a, w_nk, alpha, beta)
    if a.device.type == "cpu":
        return int8_matmul_plain(a, w_nk, alpha, beta, relu)
    dev = _cuda.require_cuda_tensors(a, w_nk, alpha, beta)
    (m, k), n = a.shape, w_nk.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    plan = gemm_plan(m, n, k, sms=_cuda.sm_count(dev))
    route = gemm_route(plan, a, w_nk)
    _MATMUL(dev, a.data_ptr(), w_nk.data_ptr(), alpha.data_ptr(), beta.data_ptr(), out.data_ptr(),
            m, n, k, int(relu), int(route == "sm90"), *plan.args(), route=route)
    return out


def int8_matmul_requant_nk(a, w_nk, alpha, beta, out_scale: float, out_zp: int,
                           relu: bool = True) -> torch.Tensor:
    """s8 output on the (out_scale, out_zp) grid (stored u - 128)."""
    _check(a, w_nk, alpha, beta)
    if a.device.type == "cpu":
        return int8_matmul_requant_plain(a, w_nk, alpha, beta, out_scale, out_zp, relu)
    dev = _cuda.require_cuda_tensors(a, w_nk, alpha, beta)
    (m, k), n = a.shape, w_nk.shape[0]
    inv, zps, lo = requant_scalars(out_scale, out_zp, relu)
    out = torch.empty((m, n), dtype=torch.int8, device=dev)
    plan = gemm_plan(m, n, k, sms=_cuda.sm_count(dev))
    route = gemm_route(plan, a, w_nk)
    _MATMUL_REQUANT(dev, a.data_ptr(), w_nk.data_ptr(), alpha.data_ptr(), beta.data_ptr(),
                    out.data_ptr(), m, n, k, inv, zps, lo, int(route == "sm90"), *plan.args(), route=route)
    return out


def int8_matmul(a, b, alpha, beta, relu: bool = False) -> torch.Tensor:
    """JAX-layout entry: ``b`` is (K, N)."""
    return int8_matmul_nk(a, b.T.contiguous(), alpha, beta, relu)


def int8_matmul_requant(a, b, alpha, beta, out_scale: float, out_zp: int,
                        relu: bool = True) -> torch.Tensor:
    """JAX-layout entry: ``b`` is (K, N)."""
    return int8_matmul_requant_nk(a, b.T.contiguous(), alpha, beta, out_scale, out_zp, relu)


INT_MM_MIN_M = 17  # torch._int_mm refuses M <= 16 on the GPU


def int8_matmul_xla_nk(a, w_nk, alpha, beta, relu: bool = False) -> torch.Tensor:
    """The JAX package's ``int8_matmul_xla``: the exact int32 product and the
    f32 epilogue ``relu?(acc * alpha + beta)``, no kernel of the port. On the
    GPU the product is ``torch._int_mm`` where it takes the shape (M > 16, K
    and N multiples of 8), else the exact float64 product of
    :func:`exact_int_matmul`; on the CPU the int32 product."""
    _check(a, w_nk, alpha, beta)
    (m, k), n = a.shape, w_nk.shape[0]
    if a.is_cuda and m >= INT_MM_MIN_M and k % 8 == 0 and n % 8 == 0:
        acc = torch._int_mm(a.contiguous(), w_nk.T)
    else:
        acc = exact_int_matmul(a, w_nk)
    return acc_epilogue(acc, alpha, beta, relu)


def int8_matmul_xla(a, b, alpha, beta, relu: bool = False) -> torch.Tensor:
    """JAX-layout entry of :func:`int8_matmul_xla_nk`: ``b`` is (K, N)."""
    return int8_matmul_xla_nk(a, b.T, alpha, beta, relu)
