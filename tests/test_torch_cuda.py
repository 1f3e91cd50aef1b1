"""The port's CUDA kernels and kernel routes against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device: a CUDA
kernel has no CPU mode. The file imports neither JAX nor the reference, so
it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: 1e-5 of the largest entry — both sides read the same (rounded)
inputs and sum in fp32, in different orders; ``slots`` and ``C`` must be
equal exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, tol=1e-5):
    scale = float(want.float().abs().max()) + 1e-30
    assert float((got.float() - want.float()).abs().max()) <= tol * scale


def _inputs(dev, s_c=72, m=300, L=96, c=16, s_r=72, seed=3):
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)  # noqa: E731
    Q, _ = torch.linalg.qr(f(s_c, c))
    q = (Q * (torch.arange(c, device=dev) < c // 2)).contiguous()
    C = f(m, c) * (torch.arange(c, device=dev) < c // 2)
    kw = dict(min_gain=0.5, run_mean=0.0, true_cols=float(L), n_filled=c // 2,
              free=c - c // 2, panel_cap=3)
    return f(s_c, m), f(m, L), f(L, s_r), q, C, f(s_c, s_r), kw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain(cuda, dtype):
    sc, a_l, srt, q, C, M, kw = _inputs(cuda)
    sc, a_l, srt = sc.to(dtype), a_l.to(dtype), srt.to(dtype)
    h = torch.randint(0, 40, (300,), device=cuda, dtype=torch.int32)
    sg = (torch.randint(0, 2, (300,), device=cuda) * 2 - 1).float()
    ops.reset_launches()
    got_cs = ops.countsketch_apply(h, sg, a_l, 40)
    got_ct = ops.countsketch_apply(h, sg, a_l.T.contiguous().T, 40, transpose_out=True)
    got_ps = ops.panel_score(sc, a_l, q)
    got_pu = ops.panel_update(sc, a_l, srt, q, C.clone(), M.clone(), **kw)
    with ops.force_plain():
        want_cs = ops.countsketch_apply(h, sg, a_l, 40)
        want_ps = ops.panel_score(sc, a_l, q)
        want_pu = ops.panel_update(sc, a_l, srt, q, C.clone(), M.clone(), **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == {"countsketch": 2, "panel_score": 1, "panel_update": 1}
    _close(got_cs, want_cs)
    _close(got_ct, want_cs.T)
    for g, w in zip(got_ps, want_ps):
        _close(g, w)
    for g, w in zip(got_pu[1:5], want_pu[1:5]):
        _close(g, w)
    assert torch.equal(got_pu[0], want_pu[0]) and torch.equal(got_pu[5], want_pu[5])


def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    sc, a_l, srt, q, C, M, kw = _inputs(cuda)
    with pytest.raises(ValueError):
        ops.panel_score(sc, a_l, q.T)  # columns not contiguous
    with pytest.raises(ValueError):
        ops.panel_score(sc.double(), a_l.double(), q)
    with pytest.raises(ValueError):
        ops.panel_update(sc, a_l, srt[:10], q, C, M, **kw)
    with pytest.raises(ValueError):
        ops.panel_score(sc, a_l.cpu(), q)


@pytest.mark.parametrize("sketch,kw", [("countsketch", {}), ("gaussian", {}),
                                       ("gaussian", dict(swap_gain=2.0, row_idx=None, r=8))])
def test_cuda_stream_routes_match_plain(cuda, sketch, kw):
    """Small streams on the card: kernels vs ``force_plain()`` give the same
    indices and C, and M within tolerance."""
    from repro_torch.data.synthetic import spiked_decay_matrix
    from repro_torch.stream.adaptive import adaptive_cur_init
    from repro_torch.stream.engine import stream_panels

    A, _ = spiked_decay_matrix(0, 512, 400, n_spikes=12, device=cuda)
    A += 0.3 * torch.randn(A.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(1))
    kw = dict(kw)
    row_idx = kw.pop("row_idx", torch.arange(16))

    def run():
        g = torch.Generator(cuda).manual_seed(2)
        st = adaptive_cur_init(g, 512, 400, 12, row_idx, sketch=sketch, s_c=96, s_r=96,
                               panel=64, panel_cap=3, device=cuda, **kw)
        return stream_panels(st, A, 64)

    ops.reset_launches()
    got = run()
    launched = dict(ops.LAUNCHES)
    with ops.force_plain():
        want = run()
    torch.cuda.synchronize()
    assert sum(launched.values()) >= 7  # every panel went through a kernel
    for x, y in ((got.C, want.C), (got.R, want.R), (got.ctx.col_idx, want.ctx.col_idx),
                 (got.ctx.row_idx, want.ctx.row_idx)):
        assert torch.equal(x, y)
    _close(got.M, want.M, 1e-4)
