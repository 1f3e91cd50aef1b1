"""A-posteriori error estimate from an independent test sketch
(counterpart of ``repro/obs/error_estimate.py``).

With ``Ω_test`` (n × q, iid N(0, 1)) drawn independently of every sketch
the factors are built from, the stream keeps ``Ψ = A Ω_test`` alongside
them (:func:`repro_torch.obs.telemetry.fold_psi_chunk`). For an
approximation ``Â`` built without ``Ω_test`` the error ``E = A − Â`` is
independent of it, and ``E‖E Ω‖_F² = q‖E‖_F²`` makes

    ``est = ‖Ψ − Â Ω_test‖_F / ‖Ψ‖_F``

an estimate of ``‖A − Â‖_F / ‖A‖_F`` that concentrates like ``1 ± O(1/√q)``
(Tropp, Yurtsever, Udell & Cevher 2017, §6): no second pass over ``A``.
``Â Ω_test`` is applied factor by factor, ``C (U (R Ω))`` for CUR and
``C (X (Cᵀ Ω))`` for SPSD, never materialising ``Â``.

Mid-stream, a CUR estimate covers the columns seen so far (``R`` and ``Ψ``
are zero on the others); an SPSD estimate is meant for a finished stream
(``C X Cᵀ`` acts on every row of ``Ω_test``). The finalizers are looked up
by ``ops.name`` when first needed, so this module imports no plug-in.
"""

from __future__ import annotations

import torch

__all__ = ["estimate_rel_error", "low_rank_apply"]


def _finalizer(name: str):
    """The plug-in finalizer for ``ops.name`` and its factor kind."""
    if name == "streaming_cur":
        from ..cur.streaming import streaming_cur_finalize

        return streaming_cur_finalize, "cur"
    if name == "adaptive_cur":
        from ..stream.adaptive import adaptive_cur_finalize

        return adaptive_cur_finalize, "cur"
    if name == "streaming_spsd":
        from ..spsd.streaming import streaming_spsd_finalize

        return streaming_spsd_finalize, "spsd"
    if name == "adaptive_spsd":
        from ..spsd.streaming import adaptive_spsd_finalize

        return adaptive_spsd_finalize, "spsd"
    raise ValueError(
        f"no estimator wiring for PanelOps {name!r} — pass apply_fn= with the "
        "factors' action V ↦ Â V"
    )


def low_rank_apply(state, V: torch.Tensor) -> torch.Tensor:
    """The current factors' action ``Â V`` without ``Â``: finalizes ``state``
    (which leaves it usable) and applies ``C (U (R V))`` for CUR plug-ins,
    ``C (X (Cᵀ V))`` for SPSD ones, in fp32. ``V`` is ``(n, q)`` or
    ``(n_pad, q)``; padded rows are dropped."""
    fin, kind = _finalizer(state.ops.name)
    res = fin(state)
    C = res.C.float()
    if kind == "cur":
        Vn = V[: res.R.shape[1]].float()
        return C @ (res.U.float() @ (res.R.float() @ Vn))
    Vn = V[: res.C.shape[0]].float()
    return C @ (res.X.float() @ (C.T @ Vn))


def estimate_rel_error(state, *, apply_fn=None) -> torch.Tensor:
    """``‖Ψ − Â Ω_test‖_F / ‖Ψ‖_F`` of a telemetered state (``telemetry=True``
    at init), a 0-dim float32 tensor; 0 for a zero stream. ``apply_fn``
    ``(state, V) -> Â V`` overrides :func:`low_rank_apply` for plug-ins it
    does not know. Never touches ``A``."""
    tel = state.tel
    if tel is None:
        raise ValueError(
            "estimate_rel_error needs in-stream telemetry: init the state with "
            "telemetry=True so Ψ = A·Ω_test is accumulated"
        )
    ahat_omega = (apply_fn or low_rank_apply)(state, tel.omega)
    num = torch.linalg.norm(tel.psi - ahat_omega.float())
    den = torch.linalg.norm(tel.psi)
    return torch.where(den > 0, num / torch.clamp(den, min=torch.finfo(torch.float32).tiny),
                       torch.zeros((), device=den.device))
