"""Sketch families of paper §2.3 (counterpart of ``repro/core/sketching.py``).

Gaussian, CountSketch and OSNAP are column-sliceable (the streaming engine
slides them over a stream); SRHT (with :func:`fwht`), row sampling and
composed sketches serve one-shot CUR. Every sketch ``S`` (s × m) offers

* ``apply(A)``    — ``S @ A``   (A is (m, n); a shorter A uses ``S[:, :rows]``)
* ``apply_t(A)``  — ``A @ S.T`` (A is (n, m))
* ``materialize()`` — dense ``S``
* ``cols(offset, size)`` — the window ``S[:, offset:offset+size]``
* ``pad_cols(total)`` — ``S`` extended with zero-scaled columns, so windows
  past the true source dimension contribute nothing (the exact ragged-tail
  contract of :mod:`repro_torch.stream.engine`). SRHT has neither.

On a CUDA tensor, CountSketch and OSNAP apply through the hand-written
kernel 1 (:func:`repro_torch.kernels.ops.countsketch_apply`); on the CPU
through its plain version. The Gaussian apply is a plain matrix product;
SRHT, row sampling and composition are plain torch (the reference has no
Pallas kernel for them). Randomness comes from an explicit
``torch.Generator``; parity tests hand the reference's sketches over
through :mod:`repro_torch.convert` instead.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..kernels import ops

__all__ = [
    "GaussianSketch",
    "SRHTSketch",
    "CountSketch",
    "OSNAPSketch",
    "RowSampling",
    "ComposedSketch",
    "draw_sketch",
    "fwht",
    "SKETCH_KINDS",
]

SKETCH_KINDS = ("gaussian", "srht", "countsketch", "osnap", "uniform", "leverage",
                "osnap+gaussian")


def _scaled(dtype: torch.dtype) -> torch.dtype:
    """The dtype of a ``dtype`` array scaled by ``1/√k``: the reference scales
    by a numpy float64 scalar, which jnp treats as a strong type, so a dtype
    narrower than float32 comes out float32."""
    return torch.promote_types(dtype, torch.float32)


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
        return GaussianSketch(mat.to(_scaled(dtype)) * (1.0 / math.sqrt(s)))

    @property
    def s(self) -> int:
        return self.mat.shape[0]

    @property
    def m(self) -> int:
        return self.mat.shape[1]

    def apply(self, A: torch.Tensor) -> torch.Tensor:
        S = self.mat[:, : A.shape[0]]
        dt = torch.promote_types(S.dtype, A.dtype)  # a mixed pair computes as jnp promotes it
        return S.to(dt) @ A.to(dt)

    def apply_t(self, A: torch.Tensor) -> torch.Tensor:
        S = self.mat[:, : A.shape[-1]]
        dt = torch.promote_types(S.dtype, A.dtype)
        return A.to(dt) @ S.T.to(dt)

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


def fwht(x: torch.Tensor) -> torch.Tensor:
    """Unnormalised fast Walsh–Hadamard transform along dim 0 (a power of two)."""
    m = x.shape[0]
    if m & (m - 1):
        raise ValueError(f"FWHT needs a power-of-two leading dim, got {m}")
    tail = x.shape[1:]
    h = 1
    while h < m:
        x = x.reshape(m // (2 * h), 2, h, *tail)
        a, b = x[:, 0], x[:, 1]
        x = torch.stack([a + b, a - b], dim=1).reshape(m, *tail)
        h *= 2
    return x


@dataclasses.dataclass(frozen=True)
class SRHTSketch:
    """``S = sqrt(m/s)·P·(H/√m)·D`` (Tropp 2011); the source dim is padded
    to the next power of two ``m_pad`` with zero rows."""

    signs: torch.Tensor  # (m_pad,) ±1
    row_idx: torch.Tensor  # (s,) sampled rows of the transformed matrix
    m: int
    m_pad: int

    @staticmethod
    def draw(gen: torch.Generator, s: int, m: int, dtype=torch.float32) -> "SRHTSketch":
        m_pad = 1 << math.ceil(math.log2(max(m, 2)))
        dev = gen.device
        signs = torch.randint(0, 2, (m_pad,), generator=gen, device=dev).to(dtype) * 2 - 1
        row_idx = torch.randint(0, m_pad, (s,), generator=gen, device=dev)
        return SRHTSketch(signs=signs, row_idx=row_idx, m=m, m_pad=m_pad)

    @property
    def s(self) -> int:
        return self.row_idx.shape[0]

    def apply(self, A: torch.Tensor) -> torch.Tensor:
        m = A.shape[0]
        x = A * self.signs[:m].reshape((m,) + (1,) * (A.dim() - 1))
        if self.m_pad > m:
            x = torch.cat([x, x.new_zeros((self.m_pad - m, *A.shape[1:]))], dim=0)
        x = fwht(x)
        x = x.to(_scaled(x.dtype)) * (1.0 / math.sqrt(self.s))
        return x[self.row_idx.long()]

    def apply_t(self, A: torch.Tensor) -> torch.Tensor:
        return self.apply(A.T).T

    def materialize(self) -> torch.Tensor:
        return self.apply(torch.eye(self.m, dtype=self.signs.dtype, device=self.signs.device))

    def cols(self, *_):
        raise NotImplementedError("SRHT is not column-sliceable; use CountSketch/OSNAP for streaming")

    pad_cols = cols


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

    def _signed_sum(self, A: torch.Tensor, rows: int, **kw) -> torch.Tensor:
        """Kernel 1 (fp32 sums of ±1-signed rows; the signs are exact in
        fp32), returned in the dtype the reference's segment sum gives."""
        sk = self._rows(rows)
        order = sk.order() if A.is_cuda else None
        out = ops.countsketch_apply(sk.hashes, sk.signs.float(), A, self.s, order=order, **kw)
        return out.to(torch.promote_types(self.signs.dtype, A.dtype))

    def apply(self, A: torch.Tensor) -> torch.Tensor:
        return self._signed_sum(A, A.shape[0])

    def apply_t(self, A: torch.Tensor) -> torch.Tensor:
        return self._signed_sum(A.T, A.shape[-1], transpose_out=True)

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
        return OSNAPSketch(hashes=hashes, signs=signs.to(_scaled(dtype)) * (1.0 / math.sqrt(p)),
                           s=s, p=p)

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


@dataclasses.dataclass(frozen=True)
class RowSampling:
    """Sample-and-rescale sketch: row ``i`` w.p. ``p_i``, scaled ``1/√(s·p_i)``."""

    idx: torch.Tensor  # (s,)
    scale: torch.Tensor  # (s,)
    m: int

    @staticmethod
    def draw(gen: torch.Generator, s: int, m: int, probs=None, dtype=torch.float32) -> "RowSampling":
        if probs is None:
            probs = torch.full((m,), 1.0 / m, dtype=dtype, device=gen.device)
        else:  # jnp promotes with the sum's dtype (a 0-d array is not weakly typed)
            dt = torch.promote_types(dtype, probs.dtype)
            probs = probs.to(dtype).to(dt) / torch.sum(probs).to(dt)
        # jax.random.choice(replace=True, p=probs): the same distribution, not the same bits
        idx = torch.multinomial(probs.float(), s, replacement=True, generator=gen)
        scale = 1.0 / torch.sqrt(s * probs[idx])
        return RowSampling(idx=idx, scale=scale, m=m)

    @property
    def s(self) -> int:
        return self.idx.shape[0]

    def apply(self, A: torch.Tensor) -> torch.Tensor:
        rows = A[self.idx.long()]
        return rows * self.scale.reshape((self.s,) + (1,) * (A.dim() - 1))

    def apply_t(self, A: torch.Tensor) -> torch.Tensor:
        return A[:, self.idx.long()] * self.scale[None, :]

    def materialize(self) -> torch.Tensor:
        S = self.scale.new_zeros((self.s, self.m))
        S[torch.arange(self.s, device=S.device), self.idx.long()] = self.scale
        return S

    def cols(self, offset: int, size: int) -> "RowSampling":
        """The window ``S[:, offset:offset+size]``: in-window samples re-based,
        the others zero-scaled (they contribute nothing)."""
        _window(self.m, offset, size)
        rel = self.idx - offset
        inside = (rel >= 0) & (rel < size)
        return RowSampling(idx=torch.clamp(rel, 0, size - 1),
                           scale=torch.where(inside, self.scale, torch.zeros_like(self.scale)),
                           m=size)

    def pad_cols(self, total: int) -> "RowSampling":
        """Extend the source dim with never-sampled zero columns."""
        if total <= self.m:
            return self
        return RowSampling(idx=self.idx, scale=self.scale, m=total)


@dataclasses.dataclass(frozen=True)
class ComposedSketch:
    """``S = outer ∘ inner``: apply ``inner`` first, then ``outer``."""

    inner: object
    outer: object

    @property
    def s(self) -> int:
        return self.outer.s

    @property
    def m(self) -> int:
        return self.inner.m

    def apply(self, A: torch.Tensor) -> torch.Tensor:
        return self.outer.apply(self.inner.apply(A))

    def apply_t(self, A: torch.Tensor) -> torch.Tensor:
        return self.outer.apply_t(self.inner.apply_t(A))

    def materialize(self) -> torch.Tensor:
        return self.outer.apply(self.inner.materialize())

    def cols(self, offset: int, size: int) -> "ComposedSketch":
        return ComposedSketch(inner=self.inner.cols(offset, size), outer=self.outer)

    def pad_cols(self, total: int) -> "ComposedSketch":
        return ComposedSketch(inner=self.inner.pad_cols(total), outer=self.outer)


def draw_sketch(gen: torch.Generator, kind: str, s: int, m: int, *, probs=None, p: int = 2,
                dtype=torch.float32):
    """Draw an ``(s, m)`` sketch of the requested family on ``gen.device``.

    ``probs`` is required for ``kind="leverage"`` (the leverage-score
    distribution of the matrix being protected, Tables 2/3).
    """
    if kind == "gaussian":
        return GaussianSketch.draw(gen, s, m, dtype)
    if kind == "srht":
        return SRHTSketch.draw(gen, s, m, dtype)
    if kind == "countsketch":
        return CountSketch.draw(gen, s, m, dtype)
    if kind == "osnap":
        return OSNAPSketch.draw(gen, s, m, p=p, dtype=dtype)
    if kind == "uniform":
        return RowSampling.draw(gen, s, m, None, dtype)
    if kind == "leverage":
        if probs is None:
            raise ValueError("leverage sampling requires `probs`")
        return RowSampling.draw(gen, s, m, probs, dtype)
    if kind == "osnap+gaussian":
        s0 = min(m, max(2 * s, s + 8))
        inner = OSNAPSketch.draw(gen, s0, m, p=p, dtype=dtype)
        return ComposedSketch(inner=inner, outer=GaussianSketch.draw(gen, s, s0, dtype))
    raise ValueError(f"unknown sketch kind {kind!r}; expected one of {SKETCH_KINDS}")
