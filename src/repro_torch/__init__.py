"""PyTorch/CUDA port of the fast-GMR reproduction (``src/repro`` is the JAX reference).

The port mirrors the reference's module paths and public names. Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``; with no device given
and no CUDA they raise (see :func:`repro_torch.device.resolve_device`).
"""

from .device import resolve_device

__all__ = ["resolve_device"]
