"""Multi-process runtime (counterpart of ``quantized_tpu/parallel/distributed.py``).

Every process is one rank of one device. ``initialize_multihost`` brings up
the process group, NCCL between GPUs (``cuda:LOCAL_RANK``) unless the caller
asks for the CPU (gloo); ``heartbeat_barrier`` is a barrier under a watchdog
that ends the process rather than let it hang on a dead peer.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Optional

import torch
import torch.distributed as dist

from quantized_tpu_torch._device import DeviceLike, resolve_device
from quantized_tpu_torch.parallel.mesh import BACKENDS

logger = logging.getLogger(__name__)


def initialize_multihost(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, device: DeviceLike = "cuda") -> bool:
    """Join the process group; the arguments first, else torchrun's
    ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and
    ``LOCAL_RANK``. ``coordinator_address`` is ``host:port`` of rank 0.
    Returns True when a group of several processes came up, False for a
    single process (no group is made then, as JAX makes none). On a CUDA
    device the rank's GPU, ``cuda:LOCAL_RANK``, becomes the current one."""
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    num_processes = num_processes or int(env.get("WORLD_SIZE", "0") or 0)
    if process_id is None:
        process_id = int(env.get("RANK", "0") or 0)
    if not coordinator_address or num_processes <= 1:
        return False
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(env.get("LOCAL_RANK", process_id % torch.cuda.device_count()))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    dist.init_process_group(BACKENDS[dev.type], init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    logger.info("multihost up: rank %d/%d on %s (%s)", process_id, num_processes, dev, dist.get_backend())
    return True


def heartbeat_barrier(timeout_s: float = 60.0, tag: str = "heartbeat") -> None:
    """A barrier of every rank under a watchdog: if it has not completed
    within ``timeout_s`` the process exits (code 42) rather than hang on a
    dead peer. A single process (no group) passes at once."""
    done = threading.Event()

    def watchdog():
        if not done.wait(timeout_s):
            logger.error("heartbeat_barrier(%s) timed out after %.0fs: aborting", tag, timeout_s)
            os._exit(42)

    threading.Thread(target=watchdog, daemon=True, name=f"qtpu-{tag}").start()
    try:
        if dist.is_initialized():
            dist.barrier()
    finally:
        done.set()


def local_batch_slice(global_batch: int) -> slice:
    """This rank's slice of a globally ordered batch."""
    count = dist.get_world_size() if dist.is_initialized() else 1
    index = dist.get_rank() if dist.is_initialized() else 0
    per = global_batch // count
    return slice(index * per, (index + 1) * per)
