"""EfficientNet-B0 offline: the window's int8 operations a second, in percent of the card's peak."""

from portbench.readings import mfu as read  # noqa: F401
