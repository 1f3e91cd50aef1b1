"""Column-sliceable sketch families: Gaussian, CountSketch and OSNAP.

Counterpart of ``repro/core/sketching.py`` (paper §2.3) for the three
families the streaming engine slides over a stream. Every sketch ``S``
(s × m) offers

* ``apply(A)``    — ``S @ A``   (A is (m, n); a shorter A uses ``S[:, :rows]``)
* ``apply_t(A)``  — ``A @ S.T`` (A is (n, m))
* ``materialize()`` — dense ``S``
* ``cols(offset, size)`` — the window ``S[:, offset:offset+size]``
* ``pad_cols(total)`` — ``S`` extended with zero-scaled columns, so windows
  past the true source dimension contribute nothing (the exact ragged-tail
  contract of :mod:`repro_torch.stream.engine`).

On a CUDA tensor, CountSketch and OSNAP apply through the hand-written
kernel 1 (:func:`repro_torch.kernels.ops.countsketch_apply`); on the CPU
through its plain version. The Gaussian apply is a plain matrix product.
Randomness comes from an explicit ``torch.Generator``; parity tests hand
the reference's sketches over through :mod:`repro_torch.convert` instead.
SRHT, row sampling and composed sketches are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..kernels import ops

__all__ = ["GaussianSketch", "CountSketch", "OSNAPSketch", "draw_sketch", "SKETCH_KINDS"]

SKETCH_KINDS = ("gaussian", "countsketch", "osnap")


def _window(length: int, offset: int, size: int) -> None:
    if offset < 0 or size < 0 or offset + size > length:
        raise ValueError(f"window [{offset}, {offset + size}) outside source dim {length}")


@dataclasses.dataclass(frozen=True)
class GaussianSketch:
    """Dense ``S ∈ R^{s×m}`` with iid N(0, 1/s) entries."""

    mat: torch.Tensor  # (s, m)

    @staticmethod
    def draw(gen: torch.Generator, s: int, m: int, dtype=torch.float32) -> "GaussianSketch":
        mat = torch.randn((s, m), generator=gen, device=gen.device, dtype=dtype)
        return GaussianSketch(mat * (1.0 / math.sqrt(s)))

    @property
    def s(self) -> int:
        return self.mat.shape[0]

    @property
    def m(self) -> int:
        return self.mat.shape[1]

    def apply(self, A: torch.Tensor) -> torch.Tensor:
        return self.mat[:, : A.shape[0]] @ A

    def apply_t(self, A: torch.Tensor) -> torch.Tensor:
        return A @ self.mat[:, : A.shape[-1]].T

    def materialize(self) -> torch.Tensor:
        return self.mat

    def cols(self, offset: int, size: int) -> "GaussianSketch":
        _window(self.m, offset, size)
        return GaussianSketch(self.mat[:, offset : offset + size])

    def pad_cols(self, total: int) -> "GaussianSketch":
        if total <= self.m:
            return self
        pad = self.mat.new_zeros((self.s, total - self.m))
        return GaussianSketch(torch.cat([self.mat, pad], dim=1))


@dataclasses.dataclass(frozen=True, eq=False)
class CountSketch:
    """One ±1 entry per column at a uniform position (Clarkson & Woodruff 2013).

    The bucket order the kernel walks (rows grouped by bucket, ascending) is
    built once per sketch object at first use and kept with it.
    """

    hashes: torch.Tensor  # (m,) int32 in [0, s)
    signs: torch.Tensor  # (m,) float32, ±1 (0 in padded columns)
    s: int
    _order: list = dataclasses.field(default_factory=list, repr=False, compare=False)

    @staticmethod
    def draw(gen: torch.Generator, s: int, m: int, dtype=torch.float32) -> "CountSketch":
        dev = gen.device
        hashes = torch.randint(0, s, (m,), generator=gen, device=dev, dtype=torch.int32)
        signs = torch.randint(0, 2, (m,), generator=gen, device=dev).to(dtype) * 2 - 1
        return CountSketch(hashes=hashes, signs=signs, s=s)

    @property
    def m(self) -> int:
        return self.hashes.shape[0]

    def order(self) -> tuple:
        if not self._order:
            self._order.append(ops.bucket_order(self.hashes, self.s))
        return self._order[0]

    def _rows(self, rows: int) -> "CountSketch":
        return self if rows == self.m else self.cols(0, rows)

    def apply(self, A: torch.Tensor) -> torch.Tensor:
        sk = self._rows(A.shape[0])
        order = sk.order() if A.is_cuda else None
        return ops.countsketch_apply(sk.hashes, sk.signs, A, self.s, order=order)

    def apply_t(self, A: torch.Tensor) -> torch.Tensor:
        sk = self._rows(A.shape[-1])
        order = sk.order() if A.is_cuda else None
        return ops.countsketch_apply(sk.hashes, sk.signs, A.T, self.s, order=order,
                                     transpose_out=True)

    def materialize(self) -> torch.Tensor:
        S = self.signs.new_zeros((self.s, self.m))
        S[self.hashes.long(), torch.arange(self.m, device=S.device)] = self.signs
        return S

    def cols(self, offset: int, size: int) -> "CountSketch":
        _window(self.m, offset, size)
        return CountSketch(
            hashes=self.hashes[offset : offset + size],
            signs=self.signs[offset : offset + size],
            s=self.s,
        )

    def pad_cols(self, total: int) -> "CountSketch":
        if total <= self.m:
            return self
        pad = total - self.m
        return CountSketch(
            hashes=torch.cat([self.hashes, self.hashes.new_zeros(pad)]),
            signs=torch.cat([self.signs, self.signs.new_zeros(pad)]),
            s=self.s,
        )


@dataclasses.dataclass(frozen=True, eq=False)
class OSNAPSketch:
    """``p`` entries of ±1/√p per column (Nelson & Nguyen 2013), applied as
    the sum of ``p`` CountSketches, in order."""

    hashes: torch.Tensor  # (p, m) int32
    signs: torch.Tensor  # (p, m) float32
    s: int
    p: int
    _parts: list = dataclasses.field(default_factory=list, repr=False, compare=False)

    @staticmethod
    def draw(gen: torch.Generator, s: int, m: int, p: int = 2, dtype=torch.float32) -> "OSNAPSketch":
        dev = gen.device
        hashes = torch.randint(0, s, (p, m), generator=gen, device=dev, dtype=torch.int32)
        signs = torch.randint(0, 2, (p, m), generator=gen, device=dev).to(dtype) * 2 - 1
        return OSNAPSketch(hashes=hashes, signs=signs * (1.0 / math.sqrt(p)), s=s, p=p)

    @property
    def m(self) -> int:
        return self.hashes.shape[1]

    def parts(self) -> list:
        if not self._parts:
            self._parts.extend(
                CountSketch(hashes=self.hashes[i], signs=self.signs[i], s=self.s)
                for i in range(self.p)
            )
        return self._parts

    def apply(self, A: torch.Tensor) -> torch.Tensor:
        parts = self.parts()
        out = parts[0].apply(A)
        for part in parts[1:]:
            out = out + part.apply(A)
        return out

    def apply_t(self, A: torch.Tensor) -> torch.Tensor:
        parts = self.parts()
        out = parts[0].apply_t(A)
        for part in parts[1:]:
            out = out + part.apply_t(A)
        return out

    def materialize(self) -> torch.Tensor:
        S = self.signs.new_zeros((self.s, self.m))
        cols = torch.arange(self.m, device=S.device)
        for i in range(self.p):
            S.index_put_((self.hashes[i].long(), cols), self.signs[i], accumulate=True)
        return S

    def cols(self, offset: int, size: int) -> "OSNAPSketch":
        _window(self.m, offset, size)
        return OSNAPSketch(
            hashes=self.hashes[:, offset : offset + size],
            signs=self.signs[:, offset : offset + size],
            s=self.s,
            p=self.p,
        )

    def pad_cols(self, total: int) -> "OSNAPSketch":
        if total <= self.m:
            return self
        pad = total - self.m
        return OSNAPSketch(
            hashes=torch.cat([self.hashes, self.hashes.new_zeros((self.p, pad))], dim=1),
            signs=torch.cat([self.signs, self.signs.new_zeros((self.p, pad))], dim=1),
            s=self.s,
            p=self.p,
        )


def draw_sketch(gen: torch.Generator, kind: str, s: int, m: int, *, p: int = 2,
                dtype=torch.float32):
    """Draw an ``(s, m)`` sketch of the requested family on ``gen.device``."""
    if kind == "gaussian":
        return GaussianSketch.draw(gen, s, m, dtype)
    if kind == "countsketch":
        return CountSketch.draw(gen, s, m, dtype)
    if kind == "osnap":
        return OSNAPSketch.draw(gen, s, m, p=p, dtype=dtype)
    raise ValueError(f"unknown or unported sketch kind {kind!r}; expected one of {SKETCH_KINDS}")
