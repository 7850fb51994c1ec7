"""EfficientNet-B0 offline: device ms a batch in the profiled slice."""

from portbench.readings import forward_device_ms as read  # noqa: F401
