"""Mesh, sharding and collectives: the distribution layer (counterpart of
``quantized_tpu/parallel``), on ``torch.distributed``.

A 2-D mesh ``(data, model)`` of ranks, one device each: batch-sharded
activations (DP), out-channel and fc-column sharded weights (TP), and the
collectives placed explicitly (``tp_engine``), as JAX's ``shard_map`` path
places them; PyTorch has no GSPMD to insert them. NCCL between GPUs, gloo
for ranks on the CPU; ``distributed.initialize_multihost`` joins the
processes.
"""

from quantized_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, create_mesh, local_mesh
from quantized_tpu_torch.parallel.sharding import (
    activation_spec,
    int_engine_partition_spec,
    param_partition_spec,
    shard_int_engine_state,
    shard_model_state,
)
