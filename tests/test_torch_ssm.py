"""The port's Mamba-2 SSD mixer (``repro_torch.models.ssm``) against the JAX
reference (``repro.models.ssm``) on shared inputs.

Inputs come from numpy; a mixer's weights from the reference's
``init_mamba2``, crossed with :func:`repro_torch.convert.to_tensor` (bf16
leaves as their bits). ``ssm_groups=2`` runs beside the shipped G = 1: the
reference's ``jnp.repeat`` is ``repeat_interleave`` (group-major heads), and
a tiling ``Tensor.repeat`` differs from it only at G > 1. Tolerances, of
the largest entry of the reference's output:

* fp32: 1e-5 — the same products summed in other orders (XLA's cumsum
  and batched dots against torch's) and other ``exp`` ulps, through a
  decay matrix whose entries reach exp(0) = 1;
* bf16: 3e-2 — both sides round the projections, the conv and the gate to
  bf16 (2^-8 relative) at different places (XLA fuses elementwise chains,
  the port rounds after each op), the scan itself in fp32; the SSM state,
  fp32 on both sides from bf16 inputs, likewise;
* the port's chunked scan against its own token-by-token recurrence
  (fp32): 2e-5 absolute, the reference's own test's bound for the same
  check; its conv windows, the same projections of one token or of all,
  within torch's default fp32 tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import ssm as rssm
from repro_torch import configs as pconfigs
from repro_torch import convert
from repro_torch.models import ssm as pssm

ARCH = "mamba2-1.3b"
TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _close(got, want, tol, what=""):
    got = got.float().numpy() if torch.is_tensor(got) else np.asarray(got, np.float64)
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, f"{what}: shape {got.shape} != {want.shape}"
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max abs err {err} > {tol} x {scale}"


def _cfgs(dtype="float32", groups=1, chunk=16):
    kw = dict(dtype=dtype, ssm_groups=groups, ssm_chunk=chunk)
    return (dataclasses.replace(rconfigs.get_arch(ARCH).smoke_config(), **kw),
            dataclasses.replace(pconfigs.get_arch(ARCH).smoke_config(), **kw))


def _pair(cfg_r, cfg_p, seed=0):
    """The reference's mixer weights (numpy) and the port's module holding them."""
    params = jax.tree.map(np.asarray, rssm.init_mamba2(jax.random.key(seed), cfg_r))
    mod = pssm.Mamba2(torch.Generator(), cfg_p, torch.device("meta"))
    mod.load_state_dict({k: convert.to_tensor(v, "cpu") for k, v in params.items()},
                        assign=True)
    return params, mod


def _x(rng, cfg, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x).astype(cfg.param_dtype), convert.to_tensor(
        np.asarray(jnp.asarray(x).astype(cfg.param_dtype)), "cpu")


# the scan alone: S a multiple of the chunk, ragged (40 at chunk 16), chunk > S
SCAN_CASES = [(32, 16), (40, 16), (12, 16)]


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,chunk", SCAN_CASES, ids=["whole", "ragged", "chunk_gt_S"])
def test_ssd_chunked_matches_reference(S, chunk, dtype, groups):
    """y and the fp32 final state; xh, B and C in ``dtype`` (as the mixer
    hands them over), dt and A fp32."""
    B, H, P, N = 2, 4, 8, 16
    rng = np.random.default_rng(S + chunk + groups)
    jdt = jnp.dtype(dtype)
    xh, Bm, Cm = (np.asarray(jnp.asarray(rng.standard_normal(s).astype(np.float32)).astype(jdt))
                  for s in ((B, S, H, P), (B, S, groups, N), (B, S, groups, N)))
    dt = (np.log1p(np.exp(rng.standard_normal((B, S, H)))) * 0.3).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.3).astype(np.float32)
    y_r, s_r = jax.jit(rssm.ssd_chunked, static_argnums=5)(xh, dt, A, Bm, Cm, chunk)
    y_p, s_p = pssm.ssd_chunked(*(convert.to_tensor(a, "cpu") for a in (xh, dt, A, Bm, Cm)),
                                chunk)
    assert y_p.dtype == s_p.dtype == torch.float32 and s_p.shape == (B, H, N, P)
    _close(y_p, y_r, TOL["float32"], "y")
    _close(s_p, s_r, TOL["float32"], "final state")


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [32, 40], ids=["whole", "ragged"])
def test_mamba2_forward_and_decode_match_reference(S, dtype, groups):
    """The mixer's prefill output, its conv windows (the last K − 1
    pre-conv inputs, in the parameter dtype) and its fp32 state; then four
    decode steps from them, output and states each step."""
    cfg_r, cfg_p = _cfgs(dtype, groups)
    params, mod = _pair(cfg_r, cfg_p, seed=groups)
    rng = np.random.default_rng(S + groups)
    x_r, x_p = _x(rng, cfg_r, (2, S, cfg_r.d_model))
    tol = TOL[dtype]
    y_r, st_r = jax.jit(lambda p, x: rssm.mamba2_forward(p, x, cfg_r))(params, x_r)
    y_p, st_p = pssm.mamba2_forward(mod, x_p, cfg_p)
    assert y_p.dtype == cfg_p.param_dtype and st_p[2].dtype == torch.float32
    assert st_p[0].dtype == st_p[1].dtype == cfg_p.param_dtype
    _close(y_p, y_r, tol, "forward output")
    for name, g, w in zip(("conv_x", "conv_bc", "ssm"), st_p, st_r):
        _close(g, w, tol, f"prefill {name}")
    step = jax.jit(lambda p, x, a, b, c: rssm.mamba2_decode(p, x, cfg_r, a, b, c))
    for t in range(4):
        xd_r, xd_p = _x(rng, cfg_r, (2, 1, cfg_r.d_model))
        o_r, st_r = step(params, xd_r, *st_r)
        o_p, st_p = pssm.mamba2_decode(mod, xd_p, cfg_p, *st_p)
        _close(o_p, o_r, tol, f"decode step {t}")
        for name, g, w in zip(("conv_x", "conv_bc", "ssm"), st_p, st_r):
            _close(g, w, tol, f"decode step {t} {name}")


@pytest.mark.parametrize("groups", [1, 2])
def test_chunked_forward_equals_the_stepped_recurrence(groups):
    """The port alone, fp32: ``mamba2_forward`` over 40 tokens (ragged at
    chunk 16) equals ``mamba2_decode`` stepped from ``init_mamba2_state``
    over the same tokens, output and final states; two forms of one
    recurrence (the chip's gate (1) of run (v), at a small size)."""
    _, cfg = _cfgs("float32", groups)
    g = torch.Generator()
    g.manual_seed(groups)
    mod = pssm.Mamba2(g, cfg, "cpu")
    x = torch.randn((2, 40, cfg.d_model), generator=g)
    y, (cx, cbc, st) = pssm.mamba2_forward(mod, x, cfg)
    state = pssm.init_mamba2_state(cfg, 2, "cpu")
    outs = []
    for t in range(40):
        o, state = pssm.mamba2_decode(mod, x[:, t : t + 1], cfg, *state)
        outs.append(o)
    torch.testing.assert_close(torch.cat(outs, 1), y, atol=2e-5, rtol=0)
    torch.testing.assert_close(state[2], st, atol=2e-5, rtol=0)
    # the windows: the same projections, one token's product against the
    # whole sequence's (torch's default fp32 tolerance)
    torch.testing.assert_close(state[0], cx)
    torch.testing.assert_close(state[1], cbc)


def test_groups_are_repeat_interleaved_not_tiled():
    """At G = 2, H = 4 heads 0, 1 read group 0 and heads 2, 3 group 1: a
    head fed only group 1's B gets no input, so zeroing group 0's B zeroes
    heads 0 and 1's states alone."""
    B, S, H, P, N = 1, 8, 4, 2, 3
    g = torch.Generator()
    g.manual_seed(3)
    xh = torch.randn((B, S, H, P), generator=g)
    dt = torch.full((B, S, H), 0.1)
    Bm = torch.randn((B, S, 2, N), generator=g)
    Bm[:, :, 0] = 0
    _, state = pssm.ssd_chunked(xh, dt, -torch.ones(H), Bm, torch.randn((B, S, 2, N)), 4)
    assert not state[:, :2].any() and state[:, 2:].abs().min() > 0


def test_causal_conv_carries_its_window():
    """Two halves through ``_causal_conv``, the first's window passed to
    the second, equal the whole sequence at once; the window is a copy."""
    g = torch.Generator()
    g.manual_seed(4)
    u, w, b = torch.randn((2, 10, 6), generator=g), torch.randn((4, 6), generator=g), torch.randn(6)
    whole, win = pssm._causal_conv(u, w, b)
    a, st = pssm._causal_conv(u[:, :7], w, b)
    c, st2 = pssm._causal_conv(u[:, 7:], w, b, st)
    torch.testing.assert_close(torch.cat([a, c], 1), whole)  # SiLU's vector and tail ulps
    assert torch.equal(st2, win) and torch.equal(win, u[:, -3:]) and win._base is None


def test_init_draws_the_reference_distribution_and_dtypes():
    """Not the reference's bits: the same names, shapes and dtypes (fp32
    ``dt_bias``, ``a_log``, ``d_skip`` beside bf16 matrices), dt_bias the
    softplus inverse of a step in [0.001, 0.1], a_log = log(1..16)."""
    cfg_r = rconfigs.get_arch(ARCH).full_config()
    cfg_p = pconfigs.get_arch(ARCH).full_config()
    shapes = jax.eval_shape(lambda k: rssm.init_mamba2(k, cfg_r), jax.random.key(0))
    small = dataclasses.replace(pconfigs.get_arch(ARCH).smoke_config(), dtype="bfloat16")
    g = torch.Generator()
    g.manual_seed(0)
    mod = pssm.Mamba2(g, small, "cpu")
    meta = pssm.Mamba2(torch.Generator(), cfg_p, torch.device("meta"))
    got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in meta.state_dict().items()}
    assert got == {k: (tuple(v.shape), str(v.dtype)) for k, v in shapes.items()}
    for name in ("dt_bias", "a_log", "d_skip"):
        assert getattr(mod, name).dtype == torch.float32
    assert mod.w_x.dtype == mod.conv_bc_w.dtype == torch.bfloat16
    step = torch.nn.functional.softplus(mod.dt_bias)
    assert float(step.min()) >= 0.001 * (1 - 1e-5) and float(step.max()) <= 0.1 * (1 + 1e-5)
    torch.testing.assert_close(mod.a_log, torch.log(torch.linspace(1.0, 16.0, 4)))
    assert not mod.conv_x_b.any() and torch.equal(mod.d_skip, torch.ones(4))
