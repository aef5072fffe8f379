"""Background step: frames must already carry a valid alpha matte.

The JAX package mattes frames without a valid alpha with RMBG-1.4
(``actionmesh_tpu/preprocessing/background.py``); RMBG is not ported yet,
so here such frames are an error rather than a silent pass-through.
"""

from __future__ import annotations

import numpy as np

from actionmesh_tpu_torch.preprocessing.image import is_valid_alpha


def check_alpha(frames: list[np.ndarray]) -> list[np.ndarray]:
    """Return ``frames`` if every one carries a valid alpha, else raise."""
    bad = [
        i for i, f in enumerate(frames)
        if f.shape[-1] != 4 or not is_valid_alpha(f[..., 3])
    ]
    if bad:
        raise RuntimeError(
            f"Frames {bad} lack a valid alpha matte and RMBG background "
            "removal is not ported yet: provide RGBA frames."
        )
    return frames
