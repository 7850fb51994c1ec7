"""Entry points of the port (counterparts of ``_calibrated_model`` and
``dryrun_multichip`` in the JAX repository's ``__graft_entry__.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from quantized_tpu_torch._device import DeviceLike, resolve_device
from quantized_tpu_torch.models import get_model
from quantized_tpu_torch.models.layers import QuantMeasure


def _calibrated_model(name: str, device: DeviceLike = "cuda",
                      generator: Optional[torch.Generator] = None, **cfg) -> torch.nn.Module:
    """Build a model from ``generator`` (default seed 0) with every observer
    frozen at [-4, 4], in eval mode, on ``device``."""
    dev = resolve_device(device)
    model = get_model(name)(generator=generator, **cfg)
    for m in model.modules():
        if isinstance(m, QuantMeasure):
            m.running_min.fill_(-4.0)
            m.running_max.fill_(4.0)
    return model.eval().to(dev)


def dryrun_multichip(n_devices: int, device: DeviceLike = "cuda", side: int = 224) -> str:
    """The counterpart of ``dryrun_multichip`` in the JAX repository's
    ``__graft_entry__.py``, called on every rank of a process group of
    ``n_devices`` ranks (one device each; ``device`` names this rank's kind):

    - two DP+TP training steps of the float-BN CIFAR ResNet-20 through
      ``Trainer(mesh=)`` on the default mesh (SGD at lr 0.1 on a zero batch
      of ``max(n_devices, 8)``, JAX's step);
    - the flagship int8-resident ResNet-50 (ImageNet geometry, calibrated
      observers) forwarded by ``IntExecutor(mesh=)`` over a (data, model)
      mesh of model degree 4, 2 or 1, whichever divides the world first;
    - the same engine with the explicit TP forms (``apply_explicit_tp``),
      its collectives counted;
    - one ``serve_multihost`` step: three requests a rank at 64x64 in
      buckets of 2.

    ``side`` is the side of the forwards' images (224, as JAX's). Returns
    the summary line, which it also prints."""
    import numpy as np
    import torch.distributed as dist

    from quantized_tpu_torch.engine import IntExecutor, build_int8_resident
    from quantized_tpu_torch.engine.multihost import serve_multihost
    from quantized_tpu_torch.parallel import collectives as C
    from quantized_tpu_torch.parallel import create_mesh
    from quantized_tpu_torch.parallel.tp_engine import apply_explicit_tp
    from quantized_tpu_torch.training import Trainer

    dev = resolve_device(device)
    if not dist.is_initialized() or dist.get_world_size() != n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) runs on every rank of a group of {n_devices}")
    mesh = create_mesh(num_devices=n_devices, device=dev)
    model = get_model("resnet_quantized_float_bn")(dataset="cifar10", depth=20,
                                                   generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model, regime={0: {"optimizer": "SGD", "lr": 0.1}}, mesh=mesh, print_freq=10**6, device=dev)
    batch = max(n_devices, 8)
    zeros = (np.zeros((batch, 32, 32, 3), np.float32), np.zeros((batch,), np.int64))
    loss0 = trainer.train_epoch([zeros], 0)["loss"]
    loss1 = trainer.train_epoch([zeros], 0)["loss"]  # the mutated state round-trips

    tp = next(t for t in (4, 2, 1) if n_devices % t == 0)
    mesh2 = create_mesh(num_devices=n_devices, model_parallel=tp, device=dev)

    def flagship():
        return build_int8_resident(_calibrated_model("resnet_quantized_float_bn", device=dev, dataset="imagenet",
                                                     depth=50), device=dev)

    x = torch.zeros((batch, side, side, 3), device=dev)
    logits = IntExecutor(flagship(), mesh=mesh2, device=dev, graphs=False)(x)
    engine = flagship()
    wrapped = apply_explicit_tp(engine, mesh2)
    C.reset_collectives()
    with torch.inference_mode():
        tp_logits = engine(x)
    counts = C.collective_counts()
    batcher = serve_multihost(flagship(), mesh2, batch_sizes=(2,), input_shape=(64, 64, 3), graphs=False)
    try:
        served = [f.result(timeout=600).shape for f in [batcher.submit(np.zeros((64, 64, 3), np.float32))
                                                      for _ in range(3)]]
    finally:
        batcher.stop()
    line = (f"dryrun_multichip({n_devices}): mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))} "
            f"loss0={loss0:.4f} loss1={loss1:.4f} flagship=resnet50-imagenet int8-resident @{side}x{side} "
            f"mesh_logits={tuple(logits.shape)} explicit_tp(convs={wrapped}, "
            f"all_gather={sum(counts.get('all_gather', {}).values())}, "
            f"reduce_scatter={sum(counts.get('reduce_scatter', {}).values())}) tp_logits={tuple(tp_logits.shape)} "
            f"multihost_batcher_served={len(served)}x{served[0]}")
    print(line)
    return line
