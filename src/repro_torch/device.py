"""Device policy shared by every entry point of the port."""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the card: it resolves to ``cuda`` and raises when no CUDA
    device is present, so a run never carries on quietly on the CPU. Pass
    ``device="cpu"`` to run on the CPU on purpose (the tests do).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the port on the CPU"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


def generator(seed: int, device: Optional[torch.device]) -> torch.Generator:
    """A seeded ``torch.Generator`` on ``device`` (the port's ``jax.random`` key);
    on ``meta``, where none exists, a CPU one (draws there make shapes only)."""
    meta = device is not None and torch.device(device).type == "meta"
    g = torch.Generator(device="cpu" if meta else device)
    g.manual_seed(int(seed))
    return g


def fold_in(seed: int, *data: int) -> int:
    """A seed derived from ``seed`` and the integers ``data`` (the port's
    ``jax.random.fold_in``): numpy's ``SeedSequence`` hash, so distinct
    tuples give independent streams and equal ones the same stream."""
    return int(np.random.SeedSequence([int(seed), *map(int, data)]).generate_state(1, np.uint64)[0])
