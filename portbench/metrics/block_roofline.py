"""ResNet-50's residual blocks, in whatever form the tuner gave them: their
roofline share (``portbench.readings.unit_roofline``)."""

from portbench.readings import unit_roofline as read  # noqa: F401
