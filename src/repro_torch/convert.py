"""Carry the reference's state into the port.

The JAX package's sketches and index sets, handed over as numpy arrays,
become the port's objects on a chosen device, so both packages run on the
same randomness. Nothing here imports the reference: the caller does the
JAX → numpy step (``np.asarray``). A bfloat16 array (numpy's ``ml_dtypes``
bfloat16, which torch cannot wrap) arrives as a torch bfloat16 tensor.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.sketching import (
    ComposedSketch,
    CountSketch,
    GaussianSketch,
    OSNAPSketch,
    RowSampling,
    SRHTSketch,
)
from .device import DeviceLike, resolve_device

__all__ = ["to_tensor", "indices", "sketch_arrays", "sketch_from_arrays", "sketch_pair",
           "spsvd_sketches"]

# family name of a reference sketch class -> (kind, fields to carry)
_FIELDS = {
    "GaussianSketch": ("gaussian", ("mat",)),
    "CountSketch": ("countsketch", ("hashes", "signs", "s")),
    "OSNAPSketch": ("osnap", ("hashes", "signs", "s")),
    "SRHTSketch": ("srht", ("signs", "row_idx", "m", "m_pad")),
    "RowSampling": ("rowsampling", ("idx", "scale", "m")),
}


def to_tensor(x, device: DeviceLike = None, dtype=None) -> torch.Tensor:
    """A fresh tensor on ``device`` holding the numpy array ``x``, in its own
    dtype unless ``dtype`` is given."""
    arr = np.array(x, copy=True)
    if arr.dtype.name == "bfloat16":  # exact: bfloat16 is a subset of float32
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=resolve_device(device), dtype=dtype or t.dtype)


def indices(x, device: DeviceLike = None) -> torch.Tensor:
    """An index set, or a batch of them (B, c), as an int32 tensor."""
    return to_tensor(np.asarray(x), device, torch.int32)


def sketch_arrays(S) -> tuple:
    """``(kind, arrays)`` of a reference sketch object, read by its class
    name and attributes (``np.asarray`` of each), for :func:`sketch_from_arrays`."""
    name = type(S).__name__
    if name == "ComposedSketch":
        return "composed", {"inner": sketch_arrays(S.inner), "outer": sketch_arrays(S.outer)}
    kind, fields = _FIELDS[name]
    return kind, {f: np.asarray(getattr(S, f)) for f in fields}


def sketch_from_arrays(kind: str, arrays: dict, device: DeviceLike = None):
    """The port's sketch of family ``kind`` from the reference's arrays.

    ``arrays`` holds, by ``kind``:

    * ``gaussian``: ``{"mat": (s, m)}``, kept in its own dtype;
    * ``countsketch`` / ``osnap``: ``{"hashes": (m,) or (p, m), "signs": same, "s": int}``;
    * ``srht``: ``{"signs": (m_pad,), "row_idx": (s,), "m": int, "m_pad": int}``;
    * ``rowsampling`` (the reference's ``uniform``/``leverage`` draws):
      ``{"idx": (s,), "scale": (s,), "m": int}``;
    * ``composed``: ``{"inner": (kind, arrays), "outer": (kind, arrays)}``.
    """
    if kind == "gaussian":
        return GaussianSketch(to_tensor(arrays["mat"], device))
    if kind == "srht":
        return SRHTSketch(signs=to_tensor(arrays["signs"], device),
                          row_idx=to_tensor(arrays["row_idx"], device, torch.int64),
                          m=int(arrays["m"]), m_pad=int(arrays["m_pad"]))
    if kind == "rowsampling":
        return RowSampling(idx=to_tensor(arrays["idx"], device, torch.int64),
                           scale=to_tensor(arrays["scale"], device), m=int(arrays["m"]))
    if kind == "composed":
        return ComposedSketch(inner=sketch_from_arrays(*arrays["inner"], device=device),
                              outer=sketch_from_arrays(*arrays["outer"], device=device))
    if kind not in ("countsketch", "osnap"):
        raise ValueError(f"unknown sketch kind {kind!r}")
    hashes = to_tensor(arrays["hashes"], device, torch.int32)
    signs = to_tensor(arrays["signs"], device, torch.float32)
    s = int(arrays["s"])
    if kind == "countsketch":
        return CountSketch(hashes=hashes, signs=signs, s=s)
    return OSNAPSketch(hashes=hashes, signs=signs, s=s, p=hashes.shape[0])


def sketch_pair(pair, device: DeviceLike = None) -> tuple:
    """The port's copy of a tuple of reference sketches, e.g. the RowSampling
    pair of the reference's ``leverage_sampling_sketches``."""
    return tuple(sketch_from_arrays(*sketch_arrays(S), device=device) for S in pair)


def spsvd_sketches(sk, device: DeviceLike = None):
    """The port's :class:`~repro_torch.core.svd.SPSVDSketches` from a
    reference SP-SVD state's ``ctx`` (its Ω and S_R already padded to whole
    panels; the port's ``pad_cols`` leaves them as they are)."""
    from .core.svd import SPSVDSketches

    return SPSVDSketches(**{f.name: sketch_from_arrays(*sketch_arrays(getattr(sk, f.name)),
                                                       device=device)
                            for f in dataclasses.fields(SPSVDSketches)})
