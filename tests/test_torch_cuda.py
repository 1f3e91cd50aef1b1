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


F32, BF16 = torch.float32, torch.bfloat16


# (sketch, panel, C and M) dtypes kernels 2 and 3 take; "mixed-bf16-acc" is
# a bf16 Gaussian stream's (the reference draws the sketch in fp32),
# "fp32-bf16-acc" an fp32 stream's with adaptive_cur_init(dtype=bf16)
@pytest.mark.parametrize("dtypes", [(F32, F32, F32), (BF16, BF16, F32), (F32, BF16, F32),
                                    (F32, BF16, BF16), (F32, F32, BF16), (BF16, BF16, BF16)],
                         ids=["fp32", "bf16", "mixed", "mixed-bf16-acc", "fp32-bf16-acc",
                              "bf16-bf16-acc"])
@pytest.mark.parametrize("srt_view", [False, True], ids=["srt", "srt-window"])
def test_cuda_kernels_match_plain(cuda, dtypes, srt_view):
    """Tolerance as above; a bf16 M within one bf16 rounding step (2^-7) of
    its largest entry, since the two fp32 folds may round to bf16 the other
    way. A second launch gives the same bits."""
    dsc, da, dcm = dtypes
    sc, a_l, srt, q, C, M, kw = _inputs(cuda)
    if srt_view:  # a transposed window of a row-major S_R, as on the path
        srt = torch.randn((srt.shape[1], 3 * srt.shape[0]), device=cuda)[:, 5:5 + srt.shape[0]].T
    sc, a_l, srt, C, M = sc.to(dsc), a_l.to(da), srt.to(dsc), C.to(dcm), M.to(dcm)
    h = torch.randint(0, 40, (300,), device=cuda, dtype=torch.int32)
    sg = (torch.randint(0, 2, (300,), device=cuda) * 2 - 1).float()
    ops.reset_launches()
    got_cs = ops.countsketch_apply(h, sg, a_l, 40)
    got_ct = ops.countsketch_apply(h, sg, a_l.T.contiguous().T, 40, transpose_out=True)
    got_ps = ops.panel_score(sc, a_l, q)
    again_ps = ops.panel_score(sc, a_l, q)
    got_pu = ops.panel_update(sc, a_l, srt, q, C.clone(), M.clone(), **kw)
    again_pu = ops.panel_update(sc, a_l, srt, q, C.clone(), M.clone(), **kw)
    with ops.force_plain():
        want_cs = ops.countsketch_apply(h, sg, a_l, 40)
        want_ps = ops.panel_score(sc, a_l, q)
        want_pu = ops.panel_update(sc, a_l, srt, q, C.clone(), M.clone(), **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == {"countsketch": 2, "panel_score": 2, "panel_update": 2,
                            "twoside_sketch": 0}
    _close(got_cs, want_cs)
    _close(got_ct, want_cs.T)
    for g, w in zip(got_ps, want_ps):
        _close(g, w)
    for g, w in zip(got_pu[2:5], want_pu[2:5]):
        _close(g, w)
    _close(got_pu[1], want_pu[1], 1e-5 if dcm == F32 else 2.0 ** -7)
    assert torch.equal(got_pu[0], want_pu[0]) and torch.equal(got_pu[5], want_pu[5])
    assert all(torch.equal(x, y) for x, y in zip(got_ps, again_ps))
    assert all(torch.equal(x, y) for x, y in zip(got_pu, again_pu))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 72, 300, 200, 48), (3, 96, 256, 192, 96),
                                   (2, 130, 129, 257, 131)])
def test_cuda_twoside_sketch_matches_plain(cuda, shape, dtype):
    """Kernel 4 against its plain version (ragged edges, a batch, a
    transposed S_R view) and two launches bitwise equal."""
    B, s_c, m, n, s_r = shape
    rng = np.random.default_rng(sum(shape))
    f = lambda *sh: torch.from_numpy(rng.standard_normal(sh).astype(np.float32)).to(cuda, dtype)  # noqa: E731
    sc, a, sr = f(s_c, m), f(B, m, n), f(s_r, n)
    ops.reset_launches()
    got = ops.twoside_sketch(sc, a, sr.T)
    again = ops.twoside_sketch(sc, a, sr.T)
    one = ops.twoside_sketch(sc, a[0], sr.T)
    with ops.force_plain():
        want = ops.twoside_sketch(sc, a, sr.T)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["twoside_sketch"] == 3
    assert got.shape == (B, s_c, s_r) and got.dtype == torch.float32
    _close(got, want, 1e-5)
    assert torch.equal(got, again) and torch.equal(one, got[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("view", ["transposed", "stack_item_transposed"])
def test_cuda_countsketch_reads_transposed_views(cuda, view, dtype):
    """Kernel 1 on ``Aᵀ`` with a row-major (s, n) output, as ``select_rows``
    calls it: the transpose of a matrix, and of one item of a stack (an
    offset view), against the plain version."""
    rng = np.random.default_rng(11)
    base = torch.from_numpy(rng.standard_normal((3, 257, 300)).astype(np.float32)).to(cuda, dtype)
    a = base[0].T if view == "transposed" else base[1].T  # (300, 257), column-major
    h = torch.from_numpy(rng.integers(0, 40, 300).astype(np.int32)).to(cuda)
    sg = torch.from_numpy(rng.choice([-1.0, 1.0], 300).astype(np.float32)).to(cuda)
    ops.reset_launches()
    got = ops.countsketch_apply(h, sg, a, 40, order=ops.bucket_order(h, 40))
    with ops.force_plain():
        want = ops.countsketch_apply(h, sg, a, 40)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["countsketch"] == 1 and got.shape == (40, 257)
    _close(got, want)


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
    with pytest.raises(ValueError):
        ops.twoside_sketch(sc, a_l, srt.double())
    with pytest.raises(ValueError):  # a bf16 sketch with an fp32 panel
        ops.panel_score(sc.to(BF16), a_l, q)
    with pytest.raises(ValueError):  # C and M share one dtype
        ops.panel_update(sc, a_l, srt, q, C.to(BF16), M, **kw)
    with pytest.raises(ValueError):  # srt has the sketch's dtype
        ops.panel_update(sc, a_l.to(BF16), srt.to(BF16), q, C, M, **kw)
    with pytest.raises(ValueError):  # srt without a unit stride
        ops.panel_update(sc, a_l, srt.repeat(1, 2)[:, ::2], q, C, M, **kw)


@pytest.mark.parametrize("sketch,kw,a_dtype", [
    ("countsketch", {}, F32), ("gaussian", {}, F32),
    ("gaussian", dict(swap_gain=2.0, row_idx=None, r=8), F32),
    ("gaussian", dict(dtype=BF16), F32), ("gaussian", dict(dtype=BF16), BF16)],
    ids=["countsketch", "gaussian", "gaussian-evict-rows", "gaussian-bf16-state",
         "gaussian-bf16"])
def test_cuda_stream_routes_match_plain(cuda, sketch, kw, a_dtype):
    """Small streams on the card: kernels vs ``force_plain()`` give the same
    indices and C, and M within tolerance: 1e-4 of its largest entry in
    fp32; a bf16 M within one bf16 rounding step (2^-7) of its largest entry
    per panel, since each panel's fold may round to bf16 the other way. With
    bf16 state (an fp32 or a bf16 stream) every panel goes through kernel 3."""
    from repro_torch.data.synthetic import spiked_decay_matrix
    from repro_torch.stream.adaptive import adaptive_cur_init
    from repro_torch.stream.engine import stream_panels

    A, _ = spiked_decay_matrix(0, 512, 400, n_spikes=12, device=cuda)
    A += 0.3 * torch.randn(A.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(1))
    A = A.to(a_dtype)
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
    if "dtype" in kw:
        assert launched["panel_update"] == 7 and got.M.dtype == BF16
    for x, y in ((got.C, want.C), (got.R, want.R), (got.ctx.col_idx, want.ctx.col_idx),
                 (got.ctx.row_idx, want.ctx.row_idx)):
        assert torch.equal(x, y)
    _close(got.M, want.M, 1e-4 if got.M.dtype == F32 else 7 * 2.0 ** -7)
