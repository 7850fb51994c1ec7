"""EfficientNet-B0 offline: percent of the profiled slice in which the device ran nothing."""

from portbench.readings import idle_pct as read  # noqa: F401
