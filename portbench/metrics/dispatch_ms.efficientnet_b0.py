"""EfficientNet-B0 offline: mean host ms of one ``IntExecutor.dispatch`` call."""

from portbench.readings import dispatch_ms as read  # noqa: F401
