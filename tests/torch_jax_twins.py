"""JAX models of the registry built without running their initializers,
for the port's tests, and the flat state the weight bridge takes.

``nnx.eval_shape`` builds the module abstractly (no initializer is
compiled, which costs seconds per model on the CPU); the parameters are then
drawn with numpy from a seed: conv kernels normal with the He (fan out)
variance, dense weights and biases uniform on +-1/sqrt(fan in), BN at
identity statistics (scale 1, bias 0, mean 0, var 1), every observer range
frozen at [-4, 4] as ``__graft_entry__._calibrated_model`` freezes it, and
the RNG streams from ``jax.random.key(seed)``. The model is in eval mode."""

import jax
import jax.numpy as jnp
import numpy as np
from flax import nnx

from quantized_tpu.models import get_model


def _draw(path, shape, rng):
    name = path[-1]
    if name == "kernel":  # HWIO
        return rng.standard_normal(shape) * np.sqrt(2.0 / (shape[0] * shape[1] * shape[3]))
    if name in ("weight", "bias") and path[-2] in ("fc", "fc1", "fc2", "fc3"):
        bound = 1.0 / np.sqrt(shape[-1] if name == "weight" else shape[0])
        return rng.uniform(-bound, bound, shape)
    fill = {"scale": 1.0, "bias": 0.0, "mean": 0.0, "var": 1.0, "running_min": -4.0, "running_max": 4.0}
    return np.full(shape, fill[name])


def jax_model(name: str, seed: int = 0, **cfg):
    """``get_model(name)(**cfg)`` with parameters drawn from ``seed``."""
    model = nnx.eval_shape(lambda: get_model(name)(rngs=nnx.Rngs(seed), **cfg))
    rng = np.random.default_rng(seed)
    for path, var in nnx.to_flat_state(nnx.state(model)):
        if isinstance(var, nnx.RngKey):
            var.set_value(jax.random.key(seed))
        elif isinstance(var, nnx.RngCount):
            var.set_value(jnp.zeros((), jnp.uint32))
        else:
            var.set_value(jnp.asarray(_draw(tuple(map(str, path)), var.get_value().shape, rng), jnp.float32))
    model.eval()
    return model


def flat_state(module) -> dict:
    """The JAX model's parameters and statistics keyed by their nnx paths."""
    return {
        ".".join(map(str, k)): np.asarray(v.get_value())
        for k, v in nnx.to_flat_state(nnx.state(module))
        if isinstance(v, (nnx.Param, nnx.BatchStat))
    }
