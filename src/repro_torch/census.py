"""The hooks a census needs from the kernel layer, kept apart from the
census itself (:mod:`repro_torch.launch.hlo_census`) so that the kernels
import nothing of the launch layer: the stack of census modes entered,
:func:`active`, :func:`paused`, :func:`kernel_launch` (a wrapper's record
of one launch) and :func:`nbytes`."""

from __future__ import annotations

import contextlib
import functools

import torch

__all__ = ["active", "kernel_launch", "nbytes", "paused"]

ACTIVE: list = []  # the census modes entered, innermost last


def active():
    """The innermost census entered, or ``None``."""
    return ACTIVE[-1] if ACTIVE else None


@contextlib.contextmanager
def paused():
    """Within it, the active census counts nothing."""
    c = active()
    if c is None:
        yield
        return
    c._paused += 1
    try:
        yield
    finally:
        c._paused -= 1


def nbytes(t: torch.Tensor) -> int:
    """The bytes of the elements ``t`` addresses: a dim of stride 0 (an
    expanded tensor) is read once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size() if t.numel() else 0


def kernel_launch(bound):
    """Decorate a kernel wrapper with its census record: under a census the
    wrapper runs with the census paused, then ``bound(result, *args,
    **kwargs)`` gives ``(name, flops, bytes)`` of the launch (``None`` where
    it launched nothing), recorded with the result as its outputs. Outside
    a census the wrapper runs as it is."""

    def decorate(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not ACTIVE:
                return fn(*args, **kwargs)
            c = ACTIVE[-1]
            with paused():
                out = fn(*args, **kwargs)
            rec = bound(out, *args, **kwargs)
            if rec is not None:
                c.kernel(*rec, outputs=out)
            return out

        return wrapper

    return decorate
