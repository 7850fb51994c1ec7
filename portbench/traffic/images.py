"""Seeded uint8 224x224-style RGB images, made on the device: a smooth
random field (a coarse grid of random colours upsampled bilinearly) with
fine noise over it, so that neighbouring pixels correlate as in photos
and every value from 0 to 255 occurs. The same seed and stream give the
same images."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.common import generator

CALIB, POOL = 2, 3  # streams of a run's seed
CHUNK = 128


def make(n: int, side: int, seed: int, stream: int, device) -> torch.Tensor:
    """(n, side, side, 3) uint8 NHWC images on ``device``."""
    g = generator(seed, stream, device)
    coarse = max(2, side // 16)
    out = torch.empty((n, side, side, 3), dtype=torch.uint8, device=device)
    for i in range(0, n, CHUNK):
        m = min(CHUNK, n - i)
        low = torch.rand((m, 3, coarse, coarse), generator=g, device=device)
        img = 0.8 * F.interpolate(low, size=(side, side), mode="bilinear", align_corners=False)
        img = img + 0.2 * torch.rand((m, 3, side, side), generator=g, device=device)
        out[i:i + m] = torch.round(img * 255.0).clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1)
    return out
