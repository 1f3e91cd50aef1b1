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
    assert ops.LAUNCHES == {"countsketch": 2, "countsketch_batched": 0, "panel_score": 2,
                            "panel_update": 2, "twoside_sketch": 0}
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


@pytest.mark.parametrize("mode", ["fixed-route-a", "fixed-per-panel", "adaptive-route-a",
                                  "adaptive-route-b", "adaptive-evict-rows"])
def test_cuda_telemetry_on_off_bitwise(cuda, mode):
    """Telemetry on the card changes neither the factors nor the launches:
    a small stream with and without a frame gives C, R, M and the index sets
    bit for bit and the same launch counts, on Route A (kernel 1), the
    per-panel route, Route B (kernel 3) and the per-panel body with kernel
    2; Ψ within 1e-5 (relative to its norm) of a float64 ``A·Ω_test``."""
    from repro_torch.cur import streaming_cur_init
    from repro_torch.data.synthetic import spiked_decay_matrix
    from repro_torch.stream.adaptive import adaptive_cur_init
    from repro_torch.stream.engine import stream_panels

    A, _ = spiked_decay_matrix(0, 512, 400, n_spikes=12, device=cuda)
    A += 0.3 * torch.randn(A.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(1))

    def run(tel):
        g = torch.Generator(cuda).manual_seed(2)
        common = dict(s_c=96, s_r=96, panel=64, telemetry=tel, device=cuda)
        if mode.startswith("fixed"):
            st = streaming_cur_init(g, 512, 400, torch.arange(0, 400, 25), torch.arange(16),
                                    sketch="countsketch", **common)
        else:
            kw = dict(sketch="countsketch") if mode.endswith("a") else dict(sketch="gaussian")
            if mode.endswith("rows"):
                kw.update(swap_gain=2.0, r=8)
            st = adaptive_cur_init(g, 512, 400, 12, None if "rows" in mode else torch.arange(16),
                                   panel_cap=3, **kw, **common)
        ops.reset_launches()
        st = stream_panels(st, A, 64, route="per-panel" if "per-panel" in mode else "chunk")
        torch.cuda.synchronize()
        return st, dict(ops.LAUNCHES)

    (off, l_off), (on, l_on) = run(False), run(True)
    assert l_off == l_on and sum(l_on.values()) >= 7
    if mode == "adaptive-route-b":
        assert l_on["panel_update"] == 7
    if mode == "adaptive-evict-rows":
        assert l_on["panel_score"] == 7
    for x, y in ((off.C, on.C), (off.R, on.R), (off.M, on.M), (off.ctx.col_idx, on.ctx.col_idx),
                 (off.ctx.row_idx, on.ctx.row_idx)):
        assert torch.equal(x, y)
    want = A.double() @ on.tel.omega[:400].double()
    assert float(torch.linalg.norm(on.tel.psi.double() - want)) <= 1e-5 * float(
        torch.linalg.norm(want))
    assert int(on.tel.panels_seen) == 7


def test_cuda_sharded_fixed_cur_bitwise(cuda):
    """A W = 2 sharded fixed stream on the card: C and R bit for bit those of
    the single-host stream, M within 1e-4 of its largest entry; kernel 1
    runs one chunk sketch per worker and one fold per panel."""
    from repro_torch.cur import streaming_cur_init
    from repro_torch.stream import simulate_sharded_stream, stream_panels

    g = torch.Generator(cuda).manual_seed(3)
    A = torch.randn((384, 640), generator=g, device=cuda)

    def init():
        return streaming_cur_init(torch.Generator(cuda).manual_seed(4), 384, 640,
                                  torch.arange(0, 640, 40), torch.arange(0, 384, 24),
                                  sketch="countsketch", s_c=128, s_r=128, panel=64, device=cuda)

    single = stream_panels(init(), A, 64)
    ops.reset_launches()
    shard = simulate_sharded_stream(init(), A, 64, 2)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["countsketch"] == 2 + 10
    assert torch.equal(shard.C, single.C) and torch.equal(shard.R, single.R)
    _close(shard.M, single.M, 1e-4)


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_cuda_panel_update_at_slot_offset(cuda, dtype):
    """Kernel 3 for a worker whose slot range starts at ``slot_lo > 0`` and
    is partly filled (``n_filled = slot_lo + 2``, ``free = slot_lo + c_local
    − n_filled``): slots and C equal to the plain version's, every admitted
    slot inside ``[n_filled, slot_lo + c_local)``, C outside that range
    untouched."""
    sc, a_l, srt, _, _, M, _ = _inputs(cuda, c=32)
    slot_lo, c_local = 16, 8
    n_filled = slot_lo + 2
    rng = np.random.default_rng(5)
    C = torch.from_numpy(rng.standard_normal((300, 32)).astype(np.float32)).to(cuda)
    C[:, n_filled : slot_lo + c_local] = 0.0  # this worker's free slots
    Q, _ = torch.linalg.qr(torch.randn((72, c_local), device=cuda))
    q = (Q * (torch.arange(c_local, device=cuda) < 2)).contiguous()
    kw = dict(min_gain=0.5, run_mean=0.0, true_cols=float(a_l.shape[1]), n_filled=n_filled,
              free=slot_lo + c_local - n_filled, panel_cap=4)
    args = (sc, a_l.to(dtype), srt, q) if dtype == F32 else (sc.to(BF16), a_l.to(BF16),
                                                              srt.to(BF16), q)
    got = ops.panel_update(*args, C.clone(), M.clone(), **kw)
    with ops.force_plain():
        want = ops.panel_update(*args, C.clone(), M.clone(), **kw)
    slots = got[5]
    assert torch.equal(slots, want[5]) and torch.equal(got[0], want[0])
    admitted = slots[slots < 32]
    assert admitted.numel() > 0
    assert bool(((admitted >= n_filled) & (admitted < slot_lo + c_local)).all())
    outside = torch.ones(32, dtype=torch.bool, device=cuda)
    outside[n_filled : slot_lo + c_local] = False
    assert torch.equal(got[0][:, outside], C[:, outside])
    _close(got[1], want[1], 1e-4)


def _resilient_inits(cuda):
    """A fixed CountSketch stream (kernel 1: chunk sketch and folds) and an
    adaptive Gaussian one (Route B: kernel 3 every panel), both telemetered,
    with a 384 x 640 operand on the card."""
    from repro_torch.cur import streaming_cur_init
    from repro_torch.stream.adaptive import adaptive_cur_init

    A = torch.randn((384, 640), generator=torch.Generator(cuda).manual_seed(3), device=cuda)

    def fixed():
        return streaming_cur_init(torch.Generator(cuda).manual_seed(4), 384, 640,
                                  torch.arange(0, 640, 40), torch.arange(0, 384, 24),
                                  sketch="countsketch", s_c=128, s_r=128, panel=64,
                                  telemetry=True, device=cuda)

    def adaptive():
        return adaptive_cur_init(torch.Generator(cuda).manual_seed(5), 384, 640, 16,
                                 torch.arange(0, 384, 24), sketch="gaussian", s_c=96, s_r=96,
                                 panel=64, panel_cap=3, telemetry=True, device=cuda)

    return A, {"fixed-kernel-1": (fixed, "countsketch"), "adaptive-kernel-3": (adaptive,
                                                                               "panel_update")}


def _same_state(a, b):
    from repro_torch.checkpoint.checkpoint import _leaves

    la, lb = _leaves(a), _leaves(b)
    assert [k for k, _, _ in la] == [k for k, _, _ in lb]
    for (k, x, _), (_, y, _) in zip(la, lb):
        assert (torch.equal(x, y) if torch.is_tensor(x) else x == y), k


@pytest.mark.parametrize("pack", [False, True], ids=["dir", "packed"])
def test_cuda_checkpoint_restores_onto_cuda(cuda, pack, tmp_path):
    """A CUDA stream state's checkpoint restores onto the card, in fresh
    storage, with the template's sketch objects and the saved bits."""
    from repro_torch.checkpoint import restore, save
    from repro_torch.stream import stream_panels

    A, inits = _resilient_inits(cuda)
    make = inits["adaptive-kernel-3"][0]
    st = stream_panels(make(), A, 64, stop=192)
    save(str(tmp_path), 3, st, pack=pack)
    template = make()
    out, _, step = restore(str(tmp_path), template)
    assert step == 3 and out.offset == 192
    assert all(x.is_cuda for x in (out.C, out.R, out.M, out.ctx.ScC, out.tel.psi))
    assert out.C.data_ptr() != template.C.data_ptr()
    assert out.ctx.S_C is template.ctx.S_C
    _same_state(out, st)


@pytest.mark.parametrize("name", ["fixed-kernel-1", "adaptive-kernel-3"])
def test_cuda_kill_and_resume_bitwise(cuda, name, tmp_path):
    """Killed at panel 6 of 10 and resumed from its checkpoints in a second
    invocation, a stream on the card equals its uninterrupted run bit for
    bit (C, R, M, the ctx, the frame), through its kernel."""
    from repro_torch.stream import (ArrayPanelSource, FaultInjector, FaultPlan, InjectedCrash,
                                    run_resilient_stream)

    A, inits = _resilient_inits(cuda)
    make, kname = inits[name]
    src = ArrayPanelSource(A, 64)
    ref, _ = run_resilient_stream(make(), src, chunk_panels=2)
    inj = FaultInjector(src, FaultPlan(crash_at_panel=6))
    ops.reset_launches()
    with pytest.raises(InjectedCrash):
        run_resilient_stream(make(), inj, chunk_panels=2, ckpt_dir=str(tmp_path), ckpt_every=1)
    st, rep = run_resilient_stream(make(), inj, chunk_panels=2, ckpt_dir=str(tmp_path),
                                   ckpt_every=1)
    torch.cuda.synchronize()
    assert rep.resumed_from == 6 and ops.LAUNCHES[kname] > 0
    _same_state(ref, st)


def test_cuda_nccl_group_of_one_runs_mesh(cuda):
    """``mesh_sharded_stream`` in an NCCL group of one rank: the single-host
    stream's bits."""
    import socket

    import torch.distributed as dist

    from repro_torch.stream import mesh_sharded_stream, stream_panels

    A, inits = _resilient_inits(cuda)
    make = inits["fixed-kernel-1"][0]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    try:
        merged = mesh_sharded_stream(make(), A, 64)
    finally:
        dist.destroy_process_group()
    _same_state(merged, stream_panels(make(), A, 64))


def _gloo_rank(rank, world, port, A, out_q):
    """A gloo rank on the card: its block of the parent's A (CUDA IPC)
    through ``mesh_sharded_stream``; reports C, R, M and kernel 1's launches."""
    import datetime

    import torch.distributed as dist

    from repro_torch.cur import streaming_cur_init
    from repro_torch.stream import mesh_sharded_stream

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=120))
    try:
        st = streaming_cur_init(torch.Generator("cuda").manual_seed(4), 384, 640,
                                torch.arange(0, 640, 40), torch.arange(0, 384, 24),
                                sketch="countsketch", s_c=128, s_r=128, panel=64, device="cuda")
        ops.reset_launches()
        w = A.shape[1] // world
        merged = mesh_sharded_stream(st, A[:, rank * w:(rank + 1) * w], 64)
        # numpy arrays travel by value; a CPU tensor would be shared through
        # a file descriptor this process no longer serves once it exits
        out_q.put((rank, merged.C.cpu().numpy(), merged.R.cpu().numpy(), merged.M.cpu().numpy(),
                   ops.LAUNCHES["countsketch"]))
    finally:
        dist.destroy_process_group()


def test_cuda_gloo_ranks_share_operand_and_reuse_build(cuda):
    """Two spawned gloo ranks on the one card take views of the parent's A
    through CUDA IPC and load the libraries already built (their files are
    not written again); their merged state equals ``simulate_sharded_stream``
    at W = 2 bit for bit (M is a + b in either order)."""
    import socket

    from repro_torch.cur import streaming_cur_init
    from repro_torch.kernels import build
    from repro_torch.stream import simulate_sharded_stream

    A, _ = _resilient_inits(cuda)
    build.build_all()
    libs = sorted((build.BUILD_ROOT / build.source_hash()).glob("lib*.so"))
    mtimes = [p.stat().st_mtime_ns for p in libs]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp = torch.multiprocessing
    out_q = mp.get_context("spawn").Queue()
    procs = mp.start_processes(_gloo_rank, args=(2, port, A, out_q), nprocs=2, join=False,
                               start_method="spawn")
    got = dict((r[0], r[1:]) for r in (out_q.get(timeout=300) for _ in range(2)))
    while not procs.join(timeout=60):
        pass
    assert libs and [p.stat().st_mtime_ns for p in libs] == mtimes
    want = simulate_sharded_stream(streaming_cur_init(
        torch.Generator(cuda).manual_seed(4), 384, 640, torch.arange(0, 640, 40),
        torch.arange(0, 384, 24), sketch="countsketch", s_c=128, s_r=128, panel=64,
        device=cuda), A, 64, 2)
    for rank in (0, 1):
        C, R, M, launches = got[rank]
        assert launches == 1 + 5  # one chunk sketch and five folds per rank
        assert np.array_equal(C, want.C.cpu().numpy()) and np.array_equal(R, want.R.cpu().numpy())
        assert np.array_equal(M, want.M.cpu().numpy())


# ---------------------------------------------------------------------------
# kernel 1 over a head batch, and the serving path (dense and compressed)
# ---------------------------------------------------------------------------


def _stack_inputs(dev, N, p, s, m, ncols, seed=6):
    rng = np.random.default_rng(seed)
    h = torch.from_numpy(rng.integers(0, s, (N, p, m)).astype(np.int32)).to(dev)
    sg = torch.from_numpy((rng.choice([-1.0, 1.0], (N, p, m)) / np.sqrt(p)).astype(np.float32))
    A = torch.from_numpy(rng.standard_normal((N, m, ncols)).astype(np.float32)).to(dev)
    return h, sg.to(dev), A


def _per_item(h, sg, A, s, transpose_out=False):
    """Each item's parts through the single-sketch kernel, added in order."""
    outs = []
    for n in range(h.shape[0]):
        parts = [ops.countsketch_apply(h[n, q].contiguous(), sg[n, q].contiguous(), A[n], s,
                                       transpose_out=transpose_out) for q in range(h.shape[1])]
        out = parts[0]
        for x in parts[1:]:
            out = out + x
        outs.append(out)
    return torch.stack(outs)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("layout", ["rows", "panel-transposed", "column-major", "fold"])
def test_cuda_countsketch_batched_matches_per_item_and_plain(cuda, layout, dtype):
    """One launch for the stack; bit for bit the per-item kernels' sums of
    parts (the same bucket orders, the parts added in order), and within
    1e-5 of the plain version."""
    N, p, s = 40, 4, 96
    if layout == "rows":  # S_C·A_L of a panel window (rows contiguous, a row stride)
        h, sg, A = _stack_inputs(cuda, N, p, s, 64, 100)
        A, kw = A[:, :, 20:52].to(dtype), {}
    elif layout == "panel-transposed":  # the Ω window on a panel's transpose
        h, sg, _ = _stack_inputs(cuda, N, p, s, 32, 1)
        hist = torch.randn((N, 64, 100), device=cuda).to(dtype)
        A, kw = hist[:, :, 20:52].transpose(1, 2), {"transpose_out": True}
    elif layout == "column-major":  # S_R·V_R at finalize (the view kernel)
        h, sg, A = _stack_inputs(cuda, N, p, s, 600, 32)
        A, kw = A.transpose(1, 2).contiguous().transpose(1, 2).to(dtype), {}
    else:
        h, sg, X = _stack_inputs(cuda, N, p, s, 32, 96)
        X = X.transpose(1, 2).contiguous().to(dtype)  # (N, 96, 32): rows of sc_a
        M0 = torch.randn((N, 96, s), device=cuda)
        ops.reset_launches()
        got = ops.countsketch_batched_fold(h, sg, X, M0.clone())
        assert ops.LAUNCHES["countsketch_batched"] == 1
        want = M0 + _per_item(h, sg, X.transpose(1, 2), s).transpose(1, 2)
        assert torch.equal(got, want)
        with ops.force_plain():
            _close(got, ops.countsketch_batched_fold(h, sg, X, M0.clone()))
        return
    ops.reset_launches()
    got = ops.countsketch_batched(h, sg, A, s, **kw)
    assert ops.LAUNCHES["countsketch_batched"] == 1
    assert torch.equal(got, _per_item(h, sg, A, s, **kw))
    with ops.force_plain():
        _close(got, ops.countsketch_batched(h, sg, A, s, **kw))


def _to(sk, dev):
    """Stacked sketches moved to ``dev`` (fresh orders there)."""
    import dataclasses

    from repro_torch.core.sketching import StackedOSNAPSketch

    return dataclasses.replace(sk, **{
        f: StackedOSNAPSketch(hashes=getattr(sk, f).hashes.to(dev),
                              signs=getattr(sk, f).signs.to(dev), s=getattr(sk, f).s)
        for f in ("psi", "omega", "s_c", "s_r")}, g_r=sk.g_r.to(dev), g_c=sk.g_c.to(dev))


def test_cuda_stacked_engine_matches_per_head_and_cpu(cuda):
    """The stacked engine's launches do not grow with the heads; its M is
    the per-head engine's on the card bit for bit, C and R within 1e-5
    (torch.bmm against per-head products); against the CPU's, σ within 1e-5
    and the whole rank-c reconstruction within 1e-4 (cuSOLVER's QR and SVD
    against LAPACK's, as the CPU tests hold the port to XLA's)."""
    from repro_torch.core import svd
    from repro_torch.stream.engine import panel_update

    sizes = dict(c=32, r=32, c0=64, r0=64, s_c=96, s_r=96)
    launches = []
    for N in (8, 64):
        g = torch.Generator(cuda).manual_seed(N)
        st = svd.spsvd_stacked_init(g, N, 64, 300, sizes=sizes, osnap_p=4, device=cuda)
        A = torch.randn((N, 64, 300), generator=g, device=cuda)
        ops.reset_launches()
        svd.spsvd_stacked_scan(st, A, 9, 32)
        svd.spsvd_stacked_update(st, A[:, :, 288:])
        U, S, V = svd.spsvd_stacked_finalize(st)
        launches.append(ops.LAUNCHES["countsketch_batched"])
    assert launches[0] == launches[1] == 10 * 4 + 2
    for i in (0, 17, 63):
        h = svd.spsvd_engine_init(None, 64, 300, sizes=sizes, osnap_p=4, sketches=st.sk.head(i),
                                  device=cuda)
        for off in range(0, 288, 32):
            panel_update(h, A[i][:, off : off + 32])
        panel_update(h, A[i][:, 288:])
        assert torch.equal(st.M[i], h.M)
        _close(st.C[i], h.C)
        _close(st.R[i], h.R)
    cpu = svd.spsvd_stacked_init(None, 64, 64, 300, sizes=sizes, osnap_p=4,
                                 sketches=_to(st.sk, "cpu"), device="cpu")
    svd.spsvd_stacked_scan(cpu, A.cpu(), 9, 32)
    svd.spsvd_stacked_update(cpu, A.cpu()[:, :, 288:])
    Uc, Sc, Vc = svd.spsvd_stacked_finalize(cpu)
    _close(S.cpu(), Sc)
    _close(((U * S[:, None]) @ V.transpose(1, 2)).cpu(), (Uc * Sc[:, None]) @ Vc.transpose(1, 2),
           tol=1e-4)


@pytest.mark.parametrize("compressed", [False, True], ids=["dense", "compressed"])
def test_cuda_generate_matches_cpu(cuda, compressed):
    """Greedy generation of the fp32 llama smoke config on the card gives
    the CPU's tokens (the same weights and sketches), with kernel 1 launched
    by the compressed cache's conversion and folds."""
    from repro_torch.configs import get_arch
    from repro_torch.core.svd import StackedSPSVDSketches
    from repro_torch.core.sketching import StackedOSNAPSketch
    from repro_torch.models import init_params
    from repro_torch.serve import KVCompressionConfig, generate

    cfg = get_arch("llama3.2-1b").smoke_config()
    model = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    prompt = torch.randint(0, cfg.vocab_size, (2, 40), generator=torch.Generator().manual_seed(1))
    kw = {}
    if compressed:
        kc = KVCompressionConfig(rank=4, oversample=2, panel=8, decode_panel=4, refresh_every=8)
        g = torch.Generator().manual_seed(2)
        N, hd, n_max = cfg.n_layers * 2 * cfg.n_kv_heads, cfg.head_dim, 40 + 12
        c = 8

        def draw():
            osn = lambda s, m: StackedOSNAPSketch.draw(g, N, s, m, p=4)  # noqa: E731
            return StackedSPSVDSketches(psi=osn(2 * c, hd), g_r=torch.randn((N, c, 2 * c), generator=g),
                                        omega=osn(2 * c, n_max), g_c=torch.randn((N, c, 2 * c), generator=g),
                                        s_c=osn(3 * c, hd), s_r=osn(3 * c, n_max))

        sk = (draw(), draw())
        kw = dict(kv_compress=kc, kv_sketches={0: sk})
    want = generate(model, cfg, prompt, 12, **kw)
    if compressed:
        kw["kv_sketches"] = {0: tuple(_to(x, cuda) for x in sk)}
    ops.reset_launches()
    got = generate(model.to(cuda), cfg, prompt.to(cuda), 12, **kw)
    assert torch.equal(got.cpu(), want)
    assert (ops.LAUNCHES["countsketch_batched"] > 0) == compressed


GRAPH_ARCHS = ["phi4-mini-3.8b", "mistral-nemo-12b", "musicgen-large", "gemma3-12b",
               "deepseek-v2-lite-16b", "kimi-k2-1t-a32b", "mamba2-1.3b", "zamba2-1.2b",
               "llama-3.2-vision-90b"]


@pytest.mark.parametrize("arch,compressed,dense_moe",
                         [("llama3.2-1b", False, False), ("llama3.2-1b", True, False),
                          ("deepseek-v2-lite-16b", False, True), ("llama-3.2-vision-90b", True, False)]
                         + [(a, False, False) for a in GRAPH_ARCHS],
                         ids=["dense", "compressed", "deepseek-dense_moe", "vision-compressed"]
                         + GRAPH_ARCHS)
def test_cuda_generate_graphs_match_eager_route(cuda, arch, compressed, dense_moe):
    """On the card ``generate`` replays CUDA graphs of its decode step: a
    smoke config's greedy tokens equal the eager route's
    (``ops.eager_route()``), every step's logits within 1e-5, kernel 1's
    launches counted through the replays equal the eager route's, and only
    the compressed cache's refresh steps run eagerly; at temperature 0.8 two
    graph runs from one seed draw the same tokens."""
    import contextlib

    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    from repro_torch.models.modality import synth_patch_embeddings
    from repro_torch.serve import KVCompressionConfig, generate

    cfg = get_arch(arch).smoke_config()
    g = torch.Generator(device=cuda).manual_seed(0)
    model = init_params(g, cfg, device=cuda)
    prompt = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda, generator=g)
    kw = dict(dense_moe=dense_moe)
    if cfg.d_vision:
        with torch.no_grad():  # the gates are trainable leaves, 0 at init (adding nothing)
            for block in model.blocks:
                if hasattr(block.mixer, "gate"):
                    block.mixer.gate.fill_(0.5)
        kw["vision"] = synth_patch_embeddings(g, cfg, 2, cuda)
    if compressed:
        kw["kv_compress"] = KVCompressionConfig(rank=4, oversample=2, panel=8, decode_panel=4,
                                                refresh_every=8)
    n = 20

    def run(eager: bool, temperature: float = 0.0):
        logits, stats = [], {}
        ops.reset_launches()
        with ops.eager_route() if eager else contextlib.nullcontext():
            toks = generate(model, cfg, prompt, n, gen=torch.Generator(device=cuda).manual_seed(2),
                            temperature=temperature, stats=stats,
                            on_step=lambda i, lg: logits.append(lg.clone()), **kw)
        return toks, logits, dict(ops.LAUNCHES), stats

    tg, lg_g, launch_g, st_g = run(False)
    te, lg_e, launch_e, st_e = run(True)
    assert torch.equal(tg, te)
    for a, b in zip(lg_g, lg_e):
        _close(a, b)
    assert launch_g == launch_e
    assert (launch_g["countsketch_batched"] > 0) == compressed
    assert st_e["route"] == "eager" and st_e["eager_steps"] == n - 1
    assert st_g["route"] == "graph" and st_g["graphs"] == (2 if compressed else 1)
    assert st_g["eager_steps"] == st_g["refresh_steps"] == (2 if compressed else 0)
    assert st_g["replays"] + st_g["graphs"] + st_g["eager_steps"] == n - 1
    assert st_g["pool_bytes"] > 0
    assert torch.equal(run(False, 0.8)[0], run(False, 0.8)[0])


@pytest.mark.parametrize("shape", [(128256, 2048), (16, 2048, 8192)], ids=["embed", "w_up"])
def test_cuda_twoside_sketch_at_compression_shapes(cuda, shape):
    """Kernel 4 at the compressed llama3.2-1b step's two largest launches (s =
    128, fp32) against its plain version: 1e-4 of the largest entry, since
    the embedding's sums run over 128256 terms (``chip_smoke.py``'s bound)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    s, (m, n) = 128, shape[-2:]
    sc = torch.randn((s, m), generator=g, device=cuda) / s ** 0.5
    a = torch.randn(shape, generator=g, device=cuda)
    srt = (torch.randn((s, n), generator=g, device=cuda) / s ** 0.5).T
    ops.reset_launches()
    got = ops.twoside_sketch(sc, a, srt)
    assert ops.LAUNCHES["twoside_sketch"] == 1
    with ops.force_plain():
        want = ops.twoside_sketch(sc, a, srt)
    _close(got, want, tol=1e-4)


def test_cuda_sdpa_train_step_matches_plain_and_compresses_through_kernel_4(cuda):
    """One fp32 llama smoke step on the card: the loss and every gradient
    through SDPA's backward against the plain attention path (1e-4 of each
    gradient's largest entry: fp32 both, other summation orders); the
    compressed mean of those gradients takes one kernel-4 launch per
    compressible leaf and gives the CPU's (the same sketches, 1e-4)."""
    from repro_torch.configs import get_arch
    from repro_torch.convert import stacked_leaves
    from repro_torch.models import init_params
    from repro_torch.models.attention import plain_attention
    from repro_torch.train import CompressionConfig, compressed_mean_grads, is_compressible
    from repro_torch.train.grad_compress import _sketches_for, group_leaves
    from repro_torch.train.train_step import _value_and_grad, make_loss_fn

    cfg = get_arch("llama3.2-1b").smoke_config()
    model = init_params(torch.Generator().manual_seed(0), cfg, device="cpu").to(cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks.to(cuda)}
    loss, _, grads = _value_and_grad(make_loss_fn(cfg), model, batch)
    with plain_attention():
        loss_p, _, grads_p = _value_and_grad(make_loss_fn(cfg), model, batch)
    _close(loss, loss_p, tol=1e-4)
    for k in grads:
        _close(grads[k], grads_p[k], tol=1e-4)
    ccfg = CompressionConfig(rank=8, sketch_factor=2, min_dim=32)
    tree = group_leaves(grads, stacked_leaves(model, cfg))
    sk = {i: _sketches_for(100 + i, g.shape[-2:], ccfg, torch.device("cpu"))
          for i, g in enumerate(tree.values()) if is_compressible(g, ccfg)}
    ops.reset_launches()
    out, _ = compressed_mean_grads(tree, {}, 0, ccfg, sketches={
        i: tuple(type(x)(x.mat.to(cuda)) for x in v) for i, v in sk.items()})
    assert ops.LAUNCHES["twoside_sketch"] == len(sk) > 0
    want, _ = compressed_mean_grads({k: v.cpu() for k, v in tree.items()}, {}, 0, ccfg,
                                    sketches=sk)
    for k in want:
        _close(out[k].cpu(), want[k], tol=1e-4)


def test_cuda_generate_on_a_1x1_mesh_takes_the_graph_route(cuda):
    """``generate`` under ``activation_sharding`` of a 1×1 mesh (a
    data-only mesh's case for each rank: no collective in a step) replays
    its CUDA graphs, and its tokens equal the graph route's with no mesh."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed import Mesh, activation_sharding
    from repro_torch.models import init_params
    from repro_torch.serve import generate

    cfg = get_arch("llama3.2-1b").smoke_config()
    g = torch.Generator(device=cuda).manual_seed(0)
    model = init_params(g, cfg, device=cuda)
    prompt = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda, generator=g)
    plain, meshed = {}, {}
    want = generate(model, cfg, prompt, 12, stats=plain)
    with activation_sharding(Mesh({"data": 1, "model": 1})):
        got = generate(model, cfg, prompt, 12, stats=meshed)
    assert plain["route"] == meshed["route"] == "graph" and meshed["replays"] == 12 - 2
    assert torch.equal(got, want)
