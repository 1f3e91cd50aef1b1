"""Convex-cone projections (paper §3.2): the port against the JAX reference.

Same inputs through both: ``sym_project`` within 1e-6 relative (one add and
one scale, in any order), ``psd_project`` within 1e-5 relative (other
eigensolvers, reconstructed from their clipped spectra). Both come out
symmetric; ``psd_project`` comes out PSD (smallest eigenvalue above −1e-5
of the largest) and idempotent within 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import projections as jproj  # noqa: E402
from repro_torch.core import projections as tproj  # noqa: E402


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.mark.parametrize("n,seed", [(3, 0), (17, 1), (40, 2)])
def test_projections_match_reference(n, seed):
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((n, n)).astype(np.float32)
    X = (B @ B.T + 0.7 * rng.standard_normal((n, n))).astype(np.float32)  # near-PSD, not symmetric
    Xt = torch.from_numpy(X)
    S = tproj.sym_project(Xt)
    assert _rel(S, jproj.sym_project(jnp.asarray(X))) < 1e-6
    assert torch.equal(S, S.T)
    P = tproj.psd_project(Xt)
    assert P.dtype == torch.float32
    assert _rel(P, jproj.psd_project(jnp.asarray(X))) < 1e-5
    ev = torch.linalg.eigvalsh(tproj.sym_project(P.double()))
    assert float(ev.min()) > -1e-5 * float(ev.max())
    assert _rel(tproj.psd_project(P), P) < 1e-5


def test_psd_project_keeps_the_dtype_and_clips_to_zero():
    """A bf16 input is projected in fp32 and cast back, as the reference
    does; a negative-definite input projects to zero."""
    X = torch.from_numpy(np.random.default_rng(3).standard_normal((12, 12)).astype(np.float32))
    P = tproj.psd_project(X.to(torch.bfloat16))
    want = jproj.psd_project(jnp.asarray(X.numpy()).astype(jnp.bfloat16))
    assert P.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert _rel(P.float(), np.asarray(want.astype(jnp.float32))) < 1e-2  # bf16 rounding
    assert torch.count_nonzero(tproj.psd_project(-torch.eye(5))) == 0
