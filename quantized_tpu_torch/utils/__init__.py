"""Utilities of the port: adaptive timing, meters, logging and results,
checkpoints, host-side construction, tracing and the span recorder
(``utils.profiling``)."""

from quantized_tpu_torch.utils.checkpoint import (
    export_reference_checkpoint,
    load_checkpoint,
    save_checkpoint,
    wait_for_checkpoints,
)
from quantized_tpu_torch.utils.logging_utils import ResultsLog, setup_logging
from quantized_tpu_torch.utils.meters import AverageMeter, accuracy
from quantized_tpu_torch.utils.profiling import trace
from quantized_tpu_torch.utils.timing import chain_time, per_iter_time
