"""The fused blocks (B3, B4) and the stage probes at widths that are not
multiples of 16, on the CPU.

The Hopper mainloop takes whole 16-channel slices, so on a GPU the wrappers
widen C, Cm and Cout with zero weights and constants
(``pad_block_operands``), run the kernel and slice the output. Here the
same helper runs, then the *plain* block on the padded operands, sliced: it
must equal the plain block on the originals and the JAX package's Pallas
kernels (``fused_bottleneck_ds`` / ``_s1``, ``fused_basicblock_ds`` /
``_s1``) run in interpret mode as the JAX suite runs them, bit for bit on
int8. The cases: C = 24 with Cm 16 and 24, Cout 32 and 40 (B3), stride 1
and 2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quantized_tpu.ops import fused_block as jfb
from quantized_tpu_torch import ops
from quantized_tpu_torch.engine.int_layers import S16_FINE
from quantized_tpu_torch.ops.fused_block import BLOCK_OPERANDS, pad_block_operands

B3_SCALARS = dict(lo1=-21.0, lo2=-9.0, shift=-3.0, zp2_stored=-21)
B4_SCALARS = dict(lo1=-21.0, shift=-3.0, zp1_stored=-17, zp2_stored=-40)
IDENTITY = dict(id_k=0.8137192, id_c=2.71828)


def _t(a):
    return torch.from_numpy(np.array(a))


def _nk(w):
    return _t(w).T.contiguous()


def _vec(rng, k, length, spread):
    """An epilogue pair (a, b) scaled so the requants land inside the int8 range."""
    return ((rng.uniform(0.5, 1.5, length) * spread / np.sqrt(k)).astype(np.float32),
            rng.uniform(-8, 8, length).astype(np.float32))


def _bottleneck(rng, c, cm, cout, ds, n=2, h=8):
    """x, weights in the JAX layouts, and the epilogue vectors in the wrappers' order."""
    x = rng.integers(-128, 128, (n, h, h, c)).astype(np.int8)
    w = [rng.integers(-127, 128, (c, cm)).astype(np.int8), rng.integers(-127, 128, (3, 3, cm, cm)).astype(np.int8),
         rng.integers(-127, 128, (cm, cout)).astype(np.int8)]
    v = [*_vec(rng, c, cm, 4e-3), *_vec(rng, 9 * cm, cm, 6e-3), *_vec(rng, cm, cout, 6e-3)]
    if ds:
        w.append(rng.integers(-127, 128, (c, cout)).astype(np.int8))
        v += [*_vec(rng, c, cout, 6e-3)]
    return x, w, v


def _basic(rng, c, cm, ds, n=2, h=8):
    x = rng.integers(-128, 128, (n, h, h, c)).astype(np.int8)
    w = [rng.integers(-127, 128, (3, 3, c, cm)).astype(np.int8),
         rng.integers(-127, 128, (3, 3, cm, cm)).astype(np.int8)]
    v = [*_vec(rng, 9 * c, cm, 4e-3), *_vec(rng, 9 * cm, cm, 6e-3)]
    if ds:
        w.append(rng.integers(-127, 128, (c, cm)).astype(np.int8))
        v += [*_vec(rng, c, cm, 6e-3)]
    return x, w, v


def _padded_plain(form, plain, x, operands, width, *args, **kw):
    """The padding helper, then the plain block on the padded operands, sliced to ``width`` channels."""
    xp, padded = pad_block_operands(form, x, *operands)
    assert xp.shape[-1] % 16 == 0 and all(t.shape[0] % 16 == 0 for t in padded)
    out = plain(xp, *padded, *args, **kw)
    assert out.shape[-1] % 16 == 0
    return out[..., :width]


def _assert_equal(got: torch.Tensor, want, what):
    want = np.asarray(want)
    assert got.dtype == torch.int8 and tuple(got.shape) == want.shape, what
    diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
    assert diff.max() == 0, f"{what}: {int(diff.max())} steps on {(diff > 0).mean():.4%} of elements"
    assert len(np.unique(want)) > 50 and (want == 127).mean() < 0.05, what  # not degenerate


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("cout", [32, 40])
@pytest.mark.parametrize("cm", [16, 24])
def test_padded_bottleneck_ds_equals_plain_and_jax(rng, cm, cout, stride):
    x, w, v = _bottleneck(rng, 24, cm, cout, ds=True)
    operands = (_nk(w[0]), ops.pack_conv_weight(_t(w[1])), _nk(w[2]), _nk(w[3]), *map(_t, v))
    args = (stride,)
    kw = dict(B3_SCALARS, ds_fine=S16_FINE)
    want = ops.fused_bottleneck_ds_plain(_t(x), *operands, *args, **kw)
    got = _padded_plain("bottleneck_ds", ops.fused_bottleneck_ds_plain, _t(x), operands, cout, *args, **kw)
    _assert_equal(got, want.numpy(), f"padded vs plain {(cm, cout, stride)}")
    jax_out = jfb.fused_bottleneck_ds(jnp.asarray(x), *map(jnp.asarray, w), *map(jnp.asarray, v), stride=stride,
                                      **kw, interpret=True)
    _assert_equal(got, jax_out, f"padded vs JAX {(cm, cout, stride)}")


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("cm", [16, 24])
def test_padded_basicblock_ds_equals_plain_and_jax(rng, cm, stride):
    x, w, v = _basic(rng, 24, cm, ds=True)
    operands = (ops.pack_conv_weight(_t(w[0])), ops.pack_conv_weight(_t(w[1])), _nk(w[2]), *map(_t, v))
    kw = dict(B4_SCALARS, ds_fine=S16_FINE)
    want = ops.fused_basicblock_ds_plain(_t(x), *operands, stride, **kw)
    got = _padded_plain("basic_ds", ops.fused_basicblock_ds_plain, _t(x), operands, cm, stride, **kw)
    _assert_equal(got, want.numpy(), f"padded vs plain {(cm, stride)}")
    jax_out = jfb.fused_basicblock_ds(jnp.asarray(x), *map(jnp.asarray, w), *map(jnp.asarray, v), stride=stride,
                                      **kw, interpret=True)
    _assert_equal(got, jax_out, f"padded vs JAX {(cm, stride)}")


@pytest.mark.parametrize("cm", [16, 24])
def test_padded_bottleneck_s1_equals_plain_and_jax(rng, cm):
    """The identity block: x's new channels reach only output channels that
    are sliced away (id_k, id_c act channel by channel)."""
    x, w, v = _bottleneck(rng, 24, cm, 24, ds=False)
    operands = (_nk(w[0]), ops.pack_conv_weight(_t(w[1])), _nk(w[2]), *map(_t, v))
    kw = dict(B3_SCALARS, **IDENTITY)
    want = ops.fused_bottleneck_s1_plain(_t(x), *operands, **kw)
    got = _padded_plain("bottleneck_s1", ops.fused_bottleneck_s1_plain, _t(x), operands, 24, **kw)
    _assert_equal(got, want.numpy(), f"padded vs plain {cm}")
    jax_out = jfb.fused_bottleneck_s1(jnp.asarray(x), *map(jnp.asarray, w), *map(jnp.asarray, v), **kw,
                                      interpret=True)
    _assert_equal(got, jax_out, f"padded vs JAX {cm}")


def test_padded_basicblock_s1_equals_plain_and_jax(rng):
    x, w, v = _basic(rng, 24, 24, ds=False)
    operands = (ops.pack_conv_weight(_t(w[0])), ops.pack_conv_weight(_t(w[1])), *map(_t, v))
    kw = dict(B4_SCALARS, **IDENTITY)
    want = ops.fused_basicblock_s1_plain(_t(x), *operands, **kw)
    got = _padded_plain("basic_s1", ops.fused_basicblock_s1_plain, _t(x), operands, 24, **kw)
    _assert_equal(got, want.numpy(), "padded vs plain")
    jax_out = jfb.fused_basicblock_s1(jnp.asarray(x), *map(jnp.asarray, w), *map(jnp.asarray, v), **kw,
                                      interpret=True)
    _assert_equal(got, jax_out, "padded vs JAX")


@pytest.mark.parametrize("stop", [1, 2])
@pytest.mark.parametrize("c,cm", [(24, 24), (48, 24), (40, 8)])
def test_padded_stage_probe_equals_plain(rng, c, cm, stop):
    """The stage probes tile Cm channels across C: padded, C becomes C/Cm
    tiles of the padded Cm, and each tile's first Cm channels are the real ones."""
    x = _t(rng.integers(-128, 128, (2, 8, 8, c)).astype(np.int8))
    w1 = _t(rng.integers(-127, 128, (cm, c)).astype(np.int8))
    w2 = _t(rng.integers(-127, 128, (cm, 9 * cm)).astype(np.int8))
    a = torch.full((cm,), 0.02)
    want = ops.fused_stage_plain(x, w1, w2, a, stop)
    xp, (w1p, w2p, ap) = pad_block_operands("stage", x, w1, w2, a)
    cmp = w1p.shape[0]
    assert xp.shape[-1] == c // cm * cmp and cmp % 16 == 0
    out = ops.fused_stage_plain(xp, w1p, w2p, ap, stop)
    got = out.reshape(2, 8, 8, c // cm, cmp)[..., :cm].reshape(2, 8, 8, c)
    assert torch.equal(got, want)
    assert len(torch.unique(want)) > 50


@pytest.mark.parametrize("form", sorted(BLOCK_OPERANDS))
def test_padding_keeps_the_operands_and_pads_inside_each_tap(rng, form):
    """Every operand keeps its values in its leading rows and, per tap, its
    leading input channels; everything added is 0; widths already multiples
    of 16 come back as the same tensors."""
    widths = dict(c=24, cm=8 if form == "stage" else 40, cout=36)
    x = _t(rng.integers(-128, 128, (1, 4, 4, widths["c"])).astype(np.int8))
    operands = []
    for spec in BLOCK_OPERANDS[form]:
        if isinstance(spec, str):
            operands.append(torch.from_numpy(rng.uniform(1, 2, widths[spec]).astype(np.float32)))
        else:
            rows, cin, taps = spec
            operands.append(_t(rng.integers(1, 128, (widths[rows], taps * widths[cin])).astype(np.int8)))
    xp, padded = pad_block_operands(form, x, *operands)
    assert torch.equal(xp[..., :24], x) and not xp[..., 24:].any()
    for t, p, spec in zip(operands, padded, BLOCK_OPERANDS[form]):
        if isinstance(spec, str):
            assert p.shape[0] % 16 == 0 and torch.equal(p[:t.shape[0]], t) and not p[t.shape[0]:].any()
            continue
        rows, cin, taps = spec
        q = p.reshape(p.shape[0], taps, -1)
        r, k = widths[rows], widths[cin]
        assert q.shape[0] % 16 == 0 and q.shape[2] % 16 == 0
        assert torch.equal(q[:r, :, :k], t.reshape(r, taps, k))
        assert int((q != 0).sum()) == t.numel()  # the values are non-zero: nothing else is
    x16 = _t(rng.integers(-128, 128, (1, 4, 4, 32)).astype(np.int8))
    w16 = _t(rng.integers(-127, 128, (16, 32)).astype(np.int8))
    same = pad_block_operands("stage", x16, w16, _t(np.zeros((16, 144), np.int8)), torch.zeros(16))
    assert same[0] is x16 and same[1][0] is w16
