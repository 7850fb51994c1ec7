"""MobileNet-v1 offline: images whose logits reached host memory in the window, over its seconds."""

from portbench.readings import img_per_s as read  # noqa: F401
