"""Carry the reference's state into the port.

The JAX package's sketches and index sets, handed over as numpy arrays
(``GaussianSketch.mat``; ``CountSketch``/``OSNAPSketch`` ``hashes``,
``signs`` and ``s``), become the port's objects on a chosen device, so both
packages run on the same randomness. Nothing here imports the reference: the
caller does the JAX → numpy step (``np.asarray``).
"""

from __future__ import annotations

import numpy as np
import torch

from .core.sketching import CountSketch, GaussianSketch, OSNAPSketch
from .device import DeviceLike, resolve_device

__all__ = ["to_tensor", "indices", "sketch_from_arrays"]


def to_tensor(x, device: DeviceLike = None, dtype=None) -> torch.Tensor:
    """A fresh tensor on ``device`` holding the numpy array ``x``."""
    arr = np.array(x, copy=True)
    t = torch.from_numpy(arr)
    return t.to(device=resolve_device(device), dtype=dtype or t.dtype)


def indices(x, device: DeviceLike = None) -> torch.Tensor:
    """An index set as an int32 tensor."""
    return to_tensor(np.asarray(x), device, torch.int32)


def sketch_from_arrays(kind: str, arrays: dict, device: DeviceLike = None):
    """The port's sketch of family ``kind`` from the reference's arrays.

    ``arrays`` holds ``{"mat": (s, m)}`` for ``gaussian``, and
    ``{"hashes": (m,) or (p, m), "signs": same, "s": int}`` for
    ``countsketch`` / ``osnap``.
    """
    if kind == "gaussian":
        return GaussianSketch(to_tensor(arrays["mat"], device, torch.float32))
    hashes = to_tensor(arrays["hashes"], device, torch.int32)
    signs = to_tensor(arrays["signs"], device, torch.float32)
    s = int(arrays["s"])
    if kind == "countsketch":
        return CountSketch(hashes=hashes, signs=signs, s=s)
    if kind == "osnap":
        return OSNAPSketch(hashes=hashes, signs=signs, s=s, p=hashes.shape[0])
    raise ValueError(f"unknown or unported sketch kind {kind!r}")
