"""The port's op census (``repro_torch.launch.hlo_census``) against the
reference's loop-aware HLO census (``repro.launch.hlo_census``, the cases
of ``tests/test_census.py``) on the same shapes.

The reference counts a compiled module's dots, weighting each by its
loops' trip counts; the port counts the ops a run dispatches, so a loop of
8 is eight dispatches. Flops are held equal (2·M·N·K a product, exact in
both); a matmul's bytes are its operands plus its result in the port
(eager PyTorch fuses nothing) and between that and four times it in the
reference's; the wire factors are the reference's, copied. Collectives
are counted on a ``fake`` process group of 16 ranks (this process is rank
0; the group moves nothing). Each kernel wrapper on ``meta`` records one
launch with its bound's operations and bytes. llama3.2-1b's smoke prefill
counts the same on the CPU and on ``meta`` (the plain attention route on
both), and its flops lie within 2 % of the reference's census of the same
prefill compiled (the reference's flash attention and the port's plain one
compute the same block products; the difference is the elementwise work
XLA folds into dots, none at this size).
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.launch import hlo_census as rcensus
from repro_torch.kernels import ops
from repro_torch.launch.hlo_census import Census, _wire_factor, nbytes

META = torch.device("meta")
PREFILL_FLOP_TOL = 0.02


def _ref(fn, *shapes) -> dict:
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return rcensus.census(jax.jit(fn).lower(*args).compile().as_text())


def _port(fn, *shapes, device="cpu") -> dict:
    args = [torch.zeros(s, device=device) for s in shapes]
    with Census() as c:
        fn(*args)
    return c.result()


def test_flops_plain_matmul():
    shapes, true = ((64, 128), (128, 96)), 2 * 64 * 128 * 96
    assert _port(lambda a, b: a @ b, *shapes)["flops"] == true
    assert abs(_ref(lambda a, b: a @ b, *shapes)["flops"] - true) / true < 1e-6


def test_flops_loop_multiplied():
    def port(w, x):
        for _ in range(8):
            x = torch.tanh(x @ w)
        return x

    def ref(w, x):
        def body(x, _):
            return jnp.tanh(x @ w), None
        return jax.lax.scan(body, x, None, length=8)[0]

    shapes, true = ((256, 256), (64, 256)), 8 * 2 * 64 * 256 * 256
    got = _port(port, *shapes)
    assert got["flops"] == true == _ref(ref, *shapes)["flops"]
    assert got["n_ops"] == 16  # eight products, eight tanh


def test_flops_nested_loops():
    def port(w, x):
        for _ in range(3):
            for _ in range(4):
                x = x @ w
        return x

    def ref(w, x):
        def outer(x, _):
            def inner(x, _):
                return x @ w, None
            return jax.lax.scan(inner, x, None, length=4)[0], None
        return jax.lax.scan(outer, x, None, length=3)[0]

    shapes, true = ((128, 128), (32, 128)), 12 * 2 * 32 * 128 * 128
    assert _port(port, *shapes)["flops"] == true == _ref(ref, *shapes)["flops"]


def test_batched_dot_flops():
    shapes, true = ((4, 128, 64), (4, 64, 96)), 2 * 4 * 128 * 64 * 96
    assert _port(lambda a, b: torch.einsum("bik,bkj->bij", a, b), *shapes)["flops"] == true
    ref = _ref(lambda a, b: jnp.einsum("bik,bkj->bij", a, b), *shapes)
    assert abs(ref["flops"] - true) / true < 1e-6


def test_batched_dot_with_an_fp32_output_counts_its_flops():
    """``bmm.dtype`` (bf16 operands, fp32 output: the sequence-sharded
    decode's partial value product on the card and on ``meta``) takes the
    plain product's formula, its output dtype no operand."""
    a, b = (torch.zeros(s, dtype=torch.bfloat16, device="meta") for s in ((4, 128, 64),
                                                                        (4, 64, 96)))
    with Census() as c:
        out = torch.bmm(a, b, out_dtype=torch.float32)
    assert out.dtype == torch.float32
    assert c.result()["flops"] == 2 * 4 * 128 * 64 * 96


def test_hbm_bytes_of_a_matmul():
    m = k = n = 512
    lo = 4 * (m * k + k * n + m * n)
    got = _port(lambda a, b: a @ b, (m, k), (k, n))
    assert got["hbm_bytes"] == lo and got["n_ops"] == 1
    assert lo <= _ref(lambda a, b: a @ b, (m, k), (k, n))["hbm_bytes"] <= 4 * lo
    # views and detach do no work; an expanded operand is read once
    x = torch.zeros((m, k))
    with Census() as c:
        x.T.detach()[:4]
        x[:1].expand(m, k).sum()
    assert c.result()["n_ops"] == 1 and c.result()["hbm_bytes"] == 4 * k + 4
    assert nbytes(x[:1].expand(m, k)) == 4 * k


@pytest.mark.parametrize("g", [2, 16])
@pytest.mark.parametrize("op", ["all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                                "collective-permute"])
def test_wire_factors_equal_the_reference(op, g):
    assert _wire_factor(op, g) == rcensus._wire_factor(op, g)


@pytest.fixture
def fake_world():
    """``fake_world(n)`` makes this process rank 0 of a ``fake`` process
    group of ``n`` ranks; destroyed after the test."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def make(n):
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)

    yield make
    if dist.is_initialized():
        dist.destroy_process_group()


def test_collectives_counted_with_their_group_size(fake_world):
    import torch.distributed as dist

    fake_world(32)
    g16, g2 = dist.new_group(list(range(16))), dist.new_group([0, 1])
    x = torch.empty(1000, device=META)
    out, rs = torch.empty(16000, device=META), torch.empty(1000, device=META)
    with Census() as c:
        dist.all_reduce(x, group=g16)
        dist.all_reduce(x, group=g2)
        dist.all_gather_into_tensor(out, x, group=g16)
        dist.reduce_scatter_tensor(rs, out, group=g16)
    got = c.result()["collectives"]
    assert got["all-reduce"]["count"] == 2 and got["all-reduce"]["result_bytes"] == 8000
    assert got["all-reduce"]["wire_bytes"] == pytest.approx(4000 * (2 * 15 / 16 + 1))
    assert got["all-gather"] == dict(count=1, result_bytes=64000.0, group_size=16,
                                     wire_bytes=64000 * 15 / 16)
    assert got["reduce-scatter"] == dict(count=1, result_bytes=4000.0, group_size=16,
                                         wire_bytes=4000 * 15.0)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


def test_kernel_wrappers_on_meta_record_one_launch():
    """Each wrapper on ``meta``: one launch in the census and none in
    ``LAUNCHES`` (it counts launches on a card), outputs of the kernel's shapes, the census's operations and
    bytes the bound's (each input read once, each output written once)."""
    m, n, s, L, c, sr, N, p = 512, 96, 64, 32, 8, 48, 3, 2
    h, sg = _meta(m, dtype=torch.int32), _meta(m)
    hb, sgb = _meta(N, p, m, dtype=torch.int32), _meta(N, p, m)
    sc, a_l, q = _meta(s, m), _meta(m, L), _meta(s, c)
    C, M = _meta(m, 16), _meta(s, sr)
    cases = [
        ("countsketch", lambda: ops.countsketch_apply(h, sg, _meta(m, n), s), (s, n),
         m * n, 4 * m * n + 8 * m + 4 * s * n),
        ("countsketch", lambda: ops.countsketch_fold(h, sg, _meta(7, m), _meta(7, s)), (7, s),
         7 * m, 4 * 7 * m + 2 * 4 * 7 * s + 8 * m),
        ("countsketch_batched", lambda: ops.countsketch_batched(hb, sgb, _meta(N, m, n), s),
         (N, s, n), p * N * m * n, 4 * N * m * n + 8 * N * p * m + 4 * N * s * n),
        ("panel_score", lambda: ops.panel_score(sc, a_l, q)[0], (s, L),
         2 * s * L * (m + c + 1), 4 * (s * m + m * L + s * c) + 4 * (s * L + 2 * L)),
        ("panel_update", lambda: ops.panel_update(
            sc, a_l, _meta(L, sr), q, C, M, min_gain=1.0, run_mean=0.0, true_cols=L,
            n_filled=0, free=16, panel_cap=4)[2], (s, L), 2 * s * L * (m + c + 1 + sr),
         4 * (s * m + m * L + L * sr + s * c) + 2 * 4 * s * sr + 4 * m * 4 + 4 * (s * L + 4 * L)),
        ("twoside_sketch", lambda: ops.twoside_sketch(sc, _meta(N, m, n), _meta(n, sr)),
         (N, s, sr), 2 * N * s * n * (m + sr), 4 * (s * m + N * m * n + n * sr + N * s * sr)),
    ]
    for name, call, shape, flops, nb in cases:
        before = ops.LAUNCHES[name]
        with Census() as cen:
            out = call()
        assert ops.LAUNCHES[name] == before, name
        assert out.is_meta and tuple(out.shape) == shape, name
        k = cen.result()["kernels"]
        assert k == {name: dict(launches=1, flops=float(flops), bytes=float(nb))}, name
        assert cen.result()["n_ops"] == 1, name


def _smoke_prefill(device):
    from repro_torch import models as pmodels
    from repro_torch.configs import get_arch
    from repro_torch.models import attention

    cfg = get_arch("llama3.2-1b").smoke_config()
    gen = torch.Generator().manual_seed(0)
    model = pmodels.init_params(gen, cfg, device=device)
    tokens = torch.zeros((2, 16), dtype=torch.int32, device=device)
    census = Census()
    census.track(model)
    with attention.plain_attention(), census:
        pmodels.prefill(model, cfg, tokens, 24)
    return census.result(), cfg, model


def test_cpu_census_equals_meta_census_of_a_prefill():
    cpu, _, _ = _smoke_prefill("cpu")
    meta, _, _ = _smoke_prefill(META)
    for key in ("flops", "hbm_bytes", "n_ops", "peak_bytes", "kernels", "collectives"):
        assert cpu[key] == meta[key], key
    assert cpu["flops"] > 0 and cpu["n_ops"] > 0


def test_prefill_flops_match_the_reference_census():
    from repro.configs import get_arch as rget
    from repro.models import init_params, prefill

    got, _, _ = _smoke_prefill(META)
    cfg = rget("llama3.2-1b").smoke_config()
    params = jax.eval_shape(lambda k: init_params(k, cfg), jax.random.key(0))
    tokens = jax.ShapeDtypeStruct((2, 16), jnp.int32)
    text = jax.jit(lambda p, t: prefill(p, cfg, t, 24)).lower(params, tokens).compile().as_text()
    want = rcensus.census(text)["flops"]
    assert abs(got["flops"] / want - 1) <= PREFILL_FLOP_TOL, (got["flops"], want)
