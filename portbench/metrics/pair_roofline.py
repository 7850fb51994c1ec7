"""MobileNet-v1's depthwise/pointwise pairs, fused or not: their roofline
share (``portbench.readings.unit_roofline``)."""

from portbench.readings import unit_roofline as read  # noqa: F401
