"""The port's CUDA kernels and kernel routes against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device: a CUDA
kernel has no CPU mode. The file imports neither JAX nor the reference, so
it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: 1e-5 of the largest entry — both sides read the same (rounded)
inputs and sum in fp32, in different orders; ``slots`` and ``C`` must be
equal exactly, and kernel 1's view and fold kernels must give the bits of
its gather kernel (the same sums in the same order).
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
@pytest.mark.parametrize("srt_layout", ["view", "rows"])
def test_cuda_twoside_sketch_whole_waves_and_split_tail(cuda, dtype, srt_layout):
    """Kernel 4 over a batch whose tile count is not a multiple of the
    resident slots (both products take whole waves, then split the rest
    stream-K), with S_R^T a transposed view or row-major: the plain version
    within 1e-5 of the largest entry, and a second launch bitwise."""
    from repro_torch.kernels.panel_score import blocks_per_sm, sm_count
    from repro_torch.kernels.twoside_sketch import twoside_plans

    B, s_c, m, n, s_r = 20, 256, 520, 1024, 1000
    rng = np.random.default_rng(17)
    f = lambda *sh: torch.from_numpy(rng.standard_normal(sh).astype(np.float32)).to(cuda, dtype)  # noqa: E731
    sc, a = f(s_c, m), f(B, m, n)
    srt = f(s_r, n).T if srt_layout == "view" else f(n, s_r)
    code = int(dtype == BF16)
    bps = [blocks_per_sm("twoside_sketch", stage, code) for stage in (0, 1)]
    plans = twoside_plans(B, s_c, m, n, s_r, sm_count(torch.cuda.current_device()), bps)
    assert all(0 < p.whole < p.tiles and p.whole % p.nblocks == 0 for p in plans)
    ops.reset_launches()
    got = ops.twoside_sketch(sc, a, srt)
    again = ops.twoside_sketch(sc, a, srt)
    with ops.force_plain():
        want = ops.twoside_sketch(sc, a, srt)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["twoside_sketch"] == 2
    _close(got, want, 1e-5)
    assert torch.equal(got, again)


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
    got = ops.countsketch_apply(h, sg, a, 40, chunks=ops.window_orders(h, 40, 256))
    with ops.force_plain():
        want = ops.countsketch_apply(h, sg, a, 40)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["countsketch"] == 1 and got.shape == (40, 257)
    _close(got, want)
    # the view kernel gives the bits of the gather kernel on a contiguous copy
    assert ops.reads_columns(a) and not ops.reads_columns(a.contiguous())
    assert torch.equal(got, ops.countsketch_apply(h, sg, a.contiguous(), 40))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,aligned", [((1000, 70, 1100), True), ((300, 33, 40), False),
                                           ((2000, 600, 512), True), ((600, 1100, 700), True)],
                         ids=["groups-ragged", "unaligned", "one-group", "wide"])
def test_cuda_countsketch_view_chunks_groups_bits(cuda, shape, aligned, dtype):
    """The view kernel over several chunks (the last ragged), several bucket
    groups (s > 512) and column bands, on a 16-byte aligned view and on one
    that is not: the bits of the gather kernel on a contiguous copy, and the
    plain version within 1e-5 of the largest entry; with the transposed
    output as well (the view kernel from 1024 columns on)."""
    m, n, s = shape
    rng = np.random.default_rng(m + n)
    base = torch.from_numpy(rng.standard_normal((n, m + 8)).astype(np.float32)).to(cuda, dtype)
    a = base[:, : m] if aligned else base[:, 1 : m + 1]  # rows of base: columns of the view
    a = a.T
    h = torch.from_numpy(rng.integers(0, s, m).astype(np.int32)).to(cuda)
    sg = torch.from_numpy((rng.choice([-1.0, 1.0], m) / np.sqrt(2)).astype(np.float32)).to(cuda)
    ops.reset_launches()
    got = ops.countsketch_apply(h, sg, a, s)
    copy = ops.countsketch_apply(h, sg, a.contiguous(), s)
    with ops.force_plain():
        want = ops.countsketch_apply(h, sg, a, s)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["countsketch"] == 2 and ops.reads_columns(a)
    assert torch.equal(got, copy)
    _close(got, want)
    got_t = ops.countsketch_apply(h, sg, a, s, transpose_out=True)
    assert ops.reads_columns(a, transpose_out=True) == (n >= 1024)
    assert torch.equal(got_t, ops.countsketch_apply(h, sg, a.contiguous(), s, transpose_out=True))
    assert torch.equal(got_t, got.T)


@pytest.mark.parametrize("x_dtype,m_dtype,fold_dtype", [(F32, F32, F32), (F32, BF16, F32),
                                                        (BF16, F32, BF16), (BF16, BF16, BF16)],
                         ids=["fp32", "fp32-bf16-M", "bf16-fold-fp32-M", "bf16"])
@pytest.mark.parametrize("window", ["indexed", "own-order"])
def test_cuda_countsketch_fold_equals_add_of_apply_t(cuda, x_dtype, m_dtype, fold_dtype, window):
    """The fold into M equals ``M.add_(apply_t(x).to(fold dtype).to(M's
    dtype))`` through the gather kernel bit for bit, with a window's slice
    of the stream's window orders or with its own order; buckets the window
    leaves empty keep M's bits; the plain fold within 1e-5 of M's largest
    entry (one bf16 rounding step, 2^-7, for a bf16 M)."""
    from repro_torch.core.sketching import CountSketch

    rng = np.random.default_rng(4)
    n, s, L, rows = 640, 300, 64, 90
    S = CountSketch(hashes=torch.from_numpy(rng.integers(0, s, n).astype(np.int32)).to(cuda),
                    signs=torch.from_numpy(rng.choice([-1.0, 1.0], n).astype(np.float32)).to(cuda),
                    s=s)
    if window == "indexed":
        S.index_windows(L)
    x = torch.from_numpy(rng.standard_normal((rows, 3 * L)).astype(np.float32)).to(cuda, x_dtype)
    x = x[:, L : 2 * L]  # a window of a wider chunk sketch, as Route A hands it over
    M0 = torch.from_numpy(rng.standard_normal((rows, s)).astype(np.float32)).to(cuda, m_dtype)
    W = S.cols(2 * L, L)
    assert bool(W._order) == (window == "indexed")
    order = W.order()
    ops.reset_launches()
    got = ops.countsketch_fold(W.hashes, W.signs, x, M0.clone(), order=order,
                               fold_dtype=fold_dtype)
    want = M0.clone().add_(ops.countsketch_apply(W.hashes, W.signs, x.T, s, order=order,
                                                 transpose_out=True).to(fold_dtype).to(m_dtype))
    with ops.force_plain():
        plain = ops.countsketch_fold(W.hashes, W.signs, x, M0.clone(), fold_dtype=fold_dtype)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["countsketch"] == 2
    assert torch.equal(got, want)
    empty = torch.bincount(W.hashes.long(), minlength=s) == 0
    assert bool(empty.any()) and torch.equal(got[:, empty], M0[:, empty])
    _close(got, plain, 1e-5 if m_dtype == F32 else 2.0 ** -7)


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
    with pytest.raises(ValueError):  # kernel 4 reads S_C and A along their rows
        ops.twoside_sketch(sc.T.contiguous().T, a_l, srt)
    with pytest.raises(ValueError):
        ops.twoside_sketch(sc, a_l.T.contiguous().T, srt)
    with pytest.raises(ValueError):  # the fold needs M's rows contiguous
        ops.countsketch_fold(torch.zeros(L := a_l.shape[1], dtype=torch.int32, device=cuda),
                             torch.ones(L, device=cuda), sc[:, :L], M.T.contiguous().T)


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


@pytest.mark.parametrize("mode", ["fixed", "adaptive-route-a", "adaptive-route-b",
                                  "adaptive-evict"])
def test_cuda_symmetric_stream_routes_match_plain(cuda, mode):
    """A kernel stream on the engine's symmetric mode, on the card against
    ``force_plain()``: the fixed stream and the adaptive CountSketch stream
    through Route A (kernel 1's chunk sketch and per-panel fold), the
    adaptive Gaussian stream through Route B (kernel 3 every panel, M of
    s × s), and with ``swap_gain`` on the per-panel route (kernel 2 every
    panel). Indices and C equal, M within 1e-4 of its largest entry,
    the R placeholder untouched, X finite."""
    from repro_torch.spsd import (adaptive_spsd_finalize, adaptive_spsd_init, rbf_kernel_oracle,
                                  streaming_spsd_finalize, streaming_spsd_init)
    from repro_torch.stream.engine import stream_panels

    g = torch.Generator(cuda).manual_seed(4)
    pts = torch.randn((8, 16), generator=g, device=cuda)[torch.randint(0, 8, (600,), generator=g,
                                                                        device=cuda)]
    pts += 0.5 * torch.randn(pts.shape, generator=g, device=cuda)
    K = rbf_kernel_oracle(pts, 1.0 / 64)(None, None)
    n, c, panel = 600, 16, 128  # 600 = 4·128 + a 88-column tail

    def run():
        gg = torch.Generator(cuda).manual_seed(5)
        if mode == "fixed":
            st = streaming_spsd_init(gg, n, torch.arange(0, n, n // c)[:c], s=160, panel=panel,
                                     device=cuda)
            return stream_panels(st, K, panel), streaming_spsd_finalize
        st = adaptive_spsd_init(gg, n, c, s=160, panel=panel, min_gain=1.0, device=cuda,
                                sketch="countsketch" if mode.endswith("a") else "gaussian",
                                swap_gain=1.1 if mode.endswith("evict") else None)
        # with eviction, the chunk route scores in plain torch (Route A), the
        # per-panel route through kernel 2, as in the reference
        route = "per-panel" if mode.endswith("evict") else "chunk"
        return stream_panels(st, K, panel, route=route), adaptive_spsd_finalize

    ops.reset_launches()
    got, fin = run()
    launched = dict(ops.LAUNCHES)
    with ops.force_plain():
        want, _ = run()
    torch.cuda.synchronize()
    if mode.endswith("b"):
        assert launched["panel_update"] == 5 and got.M.shape == (160, 160)
    elif mode.endswith("evict"):
        assert launched["panel_score"] == 5
        assert int(got.ctx.n_evicted) == int(want.ctx.n_evicted)
    else:
        assert launched["countsketch"] >= 6  # the chunk sketch and 5 folds
    assert got.R.shape == (0, 640)
    assert torch.equal(got.C, want.C) and torch.equal(got.ctx.col_idx, want.ctx.col_idx)
    _close(got.M, want.M, 1e-4)
    assert bool(torch.isfinite(fin(got).X).all())


def test_cuda_sp_svd_stream_matches_plain(cuda, monkeypatch):
    """SP-SVD on the card through kernel 1's OSNAP paths (Ψ and S_C on the
    panel, the Ω window on the panel's transpose through the view kernel,
    the S_R window fold, two launches each per panel) against
    ``force_plain()``: C, R and M within 1e-4 of their largest entries, the
    product ``U diag(Σ) Vᵀ`` within 1e-4; a stream resumed on the same
    state sorts nothing more (Ω's windows carry the orders indexed once)."""
    from repro_torch.core.svd import sp_svd_finalize, sp_svd_init
    from repro_torch.stream.engine import stream_panels

    g = torch.Generator(cuda).manual_seed(6)
    m, n, panel = 1024, 3072, 512
    A = torch.randn((m, 48), generator=g, device=cuda) @ torch.randn((48, n), generator=g,
                                                                     device=cuda)
    A += 0.1 * torch.randn((m, n), generator=g, device=cuda)
    sizes = dict(c=32, r=32, c0=96, r0=96, s_c=64, s_r=64)

    def init():
        return sp_svd_init(torch.Generator(cuda).manual_seed(7), m, n, sizes=sizes, panel=panel,
                           device=cuda)

    sorts = []
    for name in ("bucket_order", "window_orders"):
        orig = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _o=orig: sorts.append(a) or _o(*a))
    ops.reset_launches()
    got = stream_panels(init(), A, panel, stop=2 * panel)
    n_sorts = len(sorts)
    got = stream_panels(got, A, panel)
    assert len(sorts) == n_sorts  # no panel of the resumed stream sorts
    assert ops.LAUNCHES["countsketch"] == 8 * (n // panel)
    with ops.force_plain():
        want = stream_panels(init(), A, panel)
    torch.cuda.synchronize()
    for x, y in ((got.C, want.C), (got.R, want.R), (got.M, want.M)):
        _close(x, y, 1e-4)
    prods = [(U * S[None, :]) @ V.T for U, S, V in (sp_svd_finalize(got), sp_svd_finalize(want))]
    _close(prods[0], prods[1], 1e-4)
