"""The comparison that decides ``correct``.

For each compared image the gap between the program's logits and the
reference's, in units of the spread (standard deviation over the classes)
of the reference's logits for that image:

- ``logit_gap_max``: the widest gap of any logit of any compared image;
- ``logit_gap_mean``: the mean gap over every logit of every image.

A non-finite logit, or no image to compare, reads infinite. Each number
has a limit in the configuration's file, set from the readings of sound
runs of the program and of the control (the program's int4-weight path).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def numbers(prog: Optional[np.ndarray], ref: Optional[np.ndarray]) -> Dict[str, float]:
    if prog is None or ref is None or len(prog) == 0:
        return {"logit_gap_max": float("inf"), "logit_gap_mean": float("inf")}
    prog, ref = prog.astype(np.float64), ref.astype(np.float64)
    if prog.shape != ref.shape or not np.isfinite(prog).all():
        return {"logit_gap_max": float("inf"), "logit_gap_mean": float("inf")}
    rel = np.abs(prog - ref) / np.maximum(ref.std(axis=1, keepdims=True), 1e-12)
    return {"logit_gap_max": float(rel.max()), "logit_gap_mean": float(rel.mean())}
