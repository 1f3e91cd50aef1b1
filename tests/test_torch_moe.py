"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX reference's
``repro.models.moe`` on shared inputs.

Weights come from the reference's ``init_moe`` (numpy leaves, handed to the
port's module); activations are drawn with numpy. Everything is fp32 on
smoke shapes. Tolerances:

* top-k expert indices, capacity ranks, slots and the drop mask: equal;
* gates and the aux loss: 1e-6 of the largest entry (fp32 softmax and the
  router product summed in other orders);
* outputs: 1e-5 of the largest entry (fp32 expert products, gate-weighted
  sums over k in another order; the smoke logits' bound).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import moe as rmoe
from repro_torch import configs as pconfigs
from repro_torch import convert
from repro_torch.models import moe as pmoe

ARCH = "deepseek-v2-lite-16b"


def _cfgs(arch=ARCH, **kw):
    return (dataclasses.replace(rconfigs.get_arch(arch).smoke_config(), **kw),
            dataclasses.replace(pconfigs.get_arch(arch).smoke_config(), **kw))


def _module(params, cfg_p):
    """The port's MoE holding the reference's leaves, named as
    ``convert.model_state`` names a block's FFN."""
    state = {}
    convert._flatten("", params, state)
    mod = pmoe.MoE(torch.Generator(), cfg_p, torch.device("meta"))
    mod.load_state_dict({k: convert.to_tensor(v, "cpu") for k, v in state.items()}, assign=True)
    return mod


def _moe(cfg_r, cfg_p, seed=0):
    params = jax.tree.map(np.array, rmoe.init_moe(jax.random.key(seed), cfg_r))
    return params, _module(params, cfg_p)


def _close(got, want, tol, what=""):
    got, want = (t.detach() if torch.is_tensor(t) else t for t in (got, want))  # trainable
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1e-30, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max abs err {err} > {tol} x {scale}"


def _reference_routing(params, x, cfg):
    """The reference's routing and capacity ranks, restated from
    ``moe_ffn``'s lines on its own arrays: (gates, experts, aux, pos, cap)."""
    B, S, D = x.shape
    T, E, k = B * S, cfg.n_experts, cfg.moe_top_k
    probs = jax.nn.softmax(jnp.asarray(x).reshape(T, D) @ params["router"], axis=-1)
    gates, experts = jax.lax.top_k(probs, k)
    gates = gates / jnp.sum(gates, axis=-1, keepdims=True)
    fe = jnp.mean(jax.nn.one_hot(experts[:, 0], E, dtype=jnp.float32), axis=0)
    aux = E * jnp.sum(fe * jnp.mean(probs, axis=0))
    P = max(1, cfg.moe_dispatch_shards)
    if T % P:
        P = 1
    cap = rmoe.moe_capacity(T // P, cfg)
    flat = experts.reshape(P, -1)
    onehot = jax.nn.one_hot(flat, E, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(onehot, axis=1) - 1, flat[..., None], axis=2)[..., 0]
    return (np.asarray(gates), np.asarray(experts), float(aux), np.asarray(pos), P, cap)


def _check_against_reference(cfg_r, cfg_p, x, params, mod):
    gates, experts, aux, pos, P, cap = _reference_routing(params, x, cfg_r)
    xt = torch.from_numpy(x)
    r = pmoe.route(mod, xt.reshape(-1, xt.shape[-1]), cfg_p)
    e = r.experts
    assert np.array_equal(e.numpy(), experts)
    _close(r.gates, gates, 1e-6, "gates")
    _close(r.aux_loss(), aux, 1e-6, "aux")
    slot, keep = pmoe.dispatch_slots(e, P, cap, cfg_p.n_experts)
    assert np.array_equal(keep.numpy(), pos < cap)
    assert np.array_equal(slot.numpy(), np.where(pos < cap, pos, cap))
    want, want_aux = rmoe.moe_ffn(params, jnp.asarray(x), cfg_r)
    got, got_r = pmoe.moe_ffn(mod, xt, cfg_p)
    _close(got_r.aux_loss(), want_aux, 1e-6, "moe_ffn aux")
    _close(got, want, 1e-5, "moe_ffn")
    return pos, cap


# (B, S, moe_dispatch_shards, capacity_factor): one group; four groups;
# T = 64, k = 2, E = 8 at factor 0.25 (capacity at its floor of 8, drops)
CASES = {"one_group": (2, 24, 1, 1.25), "four_groups": (2, 24, 4, 1.25),
         "drops": (2, 32, 1, 0.25)}


@pytest.mark.parametrize("case", list(CASES))
def test_moe_ffn_matches_reference(case):
    B, S, shards, factor = CASES[case]
    cfg_r, cfg_p = _cfgs(moe_dispatch_shards=shards, capacity_factor=factor)
    params, mod = _moe(cfg_r, cfg_p, seed=len(case))
    x = np.random.default_rng(1).standard_normal((B, S, cfg_r.d_model)).astype(np.float32)
    pos, cap = _check_against_reference(cfg_r, cfg_p, x, params, mod)
    assert pos.shape[0] == shards
    if case == "drops":
        assert cap == 8 and int((pos >= cap).sum()) > 8


def test_moe_ffn_breaks_router_ties_to_the_lower_index():
    """Tied router probabilities: zero tokens (every expert tied) and two
    equal router columns. The top-k order is ``jax.lax.top_k``'s, lower
    index first, and so are the capacity ranks that follow from it."""
    cfg_r, cfg_p = _cfgs(moe_dispatch_shards=1, capacity_factor=0.5)
    params, _ = _moe(cfg_r, cfg_p, seed=5)
    params["router"][:, 6] = params["router"][:, 1]
    mod = _module(params, cfg_p)
    x = np.random.default_rng(2).standard_normal((2, 16, cfg_r.d_model)).astype(np.float32)
    x[:, ::3] = 0.0
    _check_against_reference(cfg_r, cfg_p, x, params, mod)
    e = pmoe.route(mod, torch.from_numpy(x).reshape(-1, cfg_p.d_model), cfg_p).experts
    assert e[0].tolist() == list(range(cfg_p.moe_top_k))  # a zero token: every expert tied
    pair = (e == 1).any(-1) & (e == 6).any(-1)
    assert bool(pair.any()), "no token routed to both tied experts"
    for row in e[pair]:
        assert row.tolist().index(1) < row.tolist().index(6)


@pytest.mark.parametrize("arch", [ARCH, "kimi-k2-1t-a32b"])
def test_moe_ffn_dense_matches_reference(arch):
    cfg_r, cfg_p = _cfgs(arch)
    params, mod = _moe(cfg_r, cfg_p, seed=3)
    x = np.random.default_rng(3).standard_normal((2, 20, cfg_r.d_model)).astype(np.float32)
    want, want_aux = rmoe.moe_ffn_dense(params, jnp.asarray(x), cfg_r)
    got, got_r = pmoe.moe_ffn_dense(mod, torch.from_numpy(x), cfg_p)
    _close(got_r.aux_loss(), want_aux, 1e-6, "aux")
    _close(got, want, 1e-5, "moe_ffn_dense")


def test_moe_ffn_at_full_capacity_is_the_dropless_path():
    """At ``capacity_factor = E/k`` a group's capacity is its token count, so
    nothing drops and the dispatch computes the dropless function."""
    cfg_r, cfg_p = _cfgs(moe_dispatch_shards=4)
    cfg_p = dataclasses.replace(cfg_p, capacity_factor=cfg_p.n_experts / cfg_p.moe_top_k)
    _, mod = _moe(cfg_r, cfg_p, seed=4)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 32, cfg_p.d_model)).astype(np.float32))
    assert pmoe.moe_capacity(16, cfg_p) == 16
    got, r = pmoe.moe_ffn(mod, x, cfg_p)
    want, r_d = pmoe.moe_ffn_dense(mod, x, cfg_p)
    _close(got, want, 1e-5, "capacity E/k against dropless")
    assert float(r.aux_loss()) == float(r_d.aux_loss())


def test_moe_capacity_and_shared_width_match_reference():
    for arch in (ARCH, "kimi-k2-1t-a32b"):
        for which in ("smoke_config", "full_config"):
            cfg_r = getattr(rconfigs.get_arch(arch), which)()
            cfg_p = getattr(pconfigs.get_arch(arch), which)()
            for n in (1, 8, 100, 1024, 4096):
                assert pmoe.moe_capacity(n, cfg_p) == rmoe.moe_capacity(n, cfg_r)
    cfg_r, cfg_p = _cfgs()
    params, mod = _moe(cfg_r, cfg_p)
    assert mod.shared.w_gate.shape == params["shared"]["w_gate"].shape
    assert mod.shared.w_gate.shape[1] == cfg_p.n_shared_experts * cfg_p.d_ff_expert
    assert mod.router.dtype == torch.float32


def test_full_width_router_input_and_drops_match_reference():
    """deepseek-v2-lite at its published widths (d_model 2048, 16 MLA heads,
    kv_lora 512, the dense first layer's d_ff 10944, 64 experts top-6), cut
    to its first two layers, the vocabulary to 512 and the experts' width
    to 8 (neither reaches the router's input), fp32, on one request of 1024
    random tokens: one dispatch group of capacity 120, the group the card's
    prefill forms from each half request. The first MoE layer's router
    input agrees with the reference's within 1e-5 of its largest entry (the
    smoke logits' bound), and both route, rank and drop the same
    assignments. Run with ``-s`` to print the dropped share and how close
    each token's router input lies to its request's mean, by position."""
    from repro.models import blocks as rblocks
    from repro.models import init_params as rinit
    from repro.models.config import NONE as R_NONE
    from repro.models.config import BlockSpec as RSpec
    from repro.models.config import compile_pattern as rcompile
    from repro.models.layers import rmsnorm as rrmsnorm
    from repro_torch.models import blocks as pblocks
    from repro_torch.models.config import NONE, BlockSpec
    from repro_torch.models.layers import embed_tokens, rmsnorm
    from repro_torch.models.transformer import layer_specs

    S = 1024

    def cut(cfg):
        return dataclasses.replace(cfg, n_layers=2, pattern=cfg.pattern[:2], vocab_size=512,
                                   d_ff_expert=8, dtype="float32", moe_dispatch_shards=1)

    cfg_r = cut(rconfigs.get_arch(ARCH).full_config())
    cfg_p = cut(pconfigs.get_arch(ARCH).full_config())
    params = jax.tree.map(np.array, rinit(jax.random.key(0), cfg_r))
    model = convert.model_params(params, cfg_p, device="cpu")
    layers = [(spec, per[pos][rep])
              for seg, seg_params in zip(rcompile(cfg_r.pattern), params["segments"])
              for per in [[convert._unstack(p, seg.n_repeat) for p in seg_params]]
              for rep in range(seg.n_repeat) for pos, spec in enumerate(seg.unit)]
    toks = np.random.default_rng(7).integers(0, cfg_r.vocab_size, (1, S)).astype(np.int32)

    @jax.jit
    def ref_router_input(p0, p1, tok, toks):
        x = jnp.take(tok, toks, axis=0)
        x, _ = rblocks.block_train(p0, layers[0][0], cfg_r, x, None)
        x, _ = rblocks.block_train(p1, RSpec(layers[1][0].mixer, R_NONE), cfg_r, x, None)
        return rrmsnorm(p1["norm2"], x, cfg_r.norm_eps)

    u_r = np.asarray(ref_router_input(layers[0][1], layers[1][1], params["embed"]["tok"], toks))
    specs = layer_specs(cfg_p)
    x = embed_tokens(model.embed.tok, torch.from_numpy(toks))
    x, _ = pblocks.block_train(model.blocks[0], specs[0], cfg_p, x)
    x, _ = pblocks.block_train(model.blocks[1], BlockSpec(specs[1].mixer, NONE), cfg_p, x)
    u_p = rmsnorm(model.blocks[1].norm2, x, cfg_p.norm_eps)
    _close(u_p, u_r, 1e-5, "router input")

    _, experts, _, pos, P, cap = _reference_routing(layers[1][1]["ffn"], u_r, cfg_r)
    r = pmoe.route(model.blocks[1].ffn, u_p.reshape(S, -1), cfg_p)
    assert (P, cap) == pmoe.dispatch_groups(S, cfg_p) == (1, 120)
    assert np.array_equal(r.experts.numpy(), experts)
    _, keep = pmoe.dispatch_slots(r.experts, P, cap, cfg_p.n_experts)
    assert np.array_equal(keep.numpy(), pos < cap)
    cos = torch.nn.functional.cosine_similarity(u_p, u_p.mean(1, keepdim=True), dim=-1)[0]
    load = np.bincount(experts.reshape(-1), minlength=cfg_r.n_experts)
    print(f"\nfull-width router, {S} tokens, capacity {cap}: reference drops "
          f"{float((pos >= cap).mean())}, port {float((~keep).float().mean())}; largest "
          f"expert load {int(load.max())} of {S} tokens (mean {float(load.mean())}); cosine to "
          f"the request's mean router input, positions [0, 16) {float(cos[:16].mean())}, "
          f"[16, 256) {float(cos[16:256].mean())}, [256, {S}) {float(cos[256:].mean())}")
