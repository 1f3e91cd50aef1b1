"""The sequence-sharded decode cache's parts, in this process (no spawned
ranks): ``d`` data ranks run as threads, and their all-reduces meet in a
stand-in for ``torch.distributed`` that reduces the ranks' tensors in rank
order (:class:`_Threads`).

* ``decode_attention`` over a cache cut into ``d`` blocks (``start``, the
  ranks' group) against the reference's ``decode_attention`` on the whole
  cache, fp32, within ``tests/test_torch_tp.py``'s 1e-5: ``d`` = 2 and 4;
  ``length`` just below, at and just past a block boundary; blocks wholly
  masked (past ``length``, or outside a sliding window: their rank's share
  is 0, never NaN); a window that straddles two blocks.
* ``blocks._write_slot`` at a sequence-sharded cache: the token lands in
  the one block that holds its slot, each block equal to the whole cache's
  write cut into blocks, for slots at and beside the block boundaries.
* ``prefill`` of a prompt longer than a global layer's cache raises
  ``ValueError`` (the reference's cache padding raises there too).

The served models under ``seq_shard`` (zamba2, gemma3, mamba2 at 2×1 and
2×2 in gloo ranks) are ``tests/test_torch_tp_hybrid.py``'s; the dry run's
``long_500k`` cells ``tests/test_torch_dryrun.py``'s.
"""

import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import configs as pconfigs
from repro_torch import models as pmodels
from repro_torch.models import attention as pattn
from repro_torch.models import blocks as pblocks

B, H, KV, D, SMAX = 2, 4, 2, 8, 32
TOL = 1e-5


class _Threads:
    """``d`` ranks as threads; :meth:`all_reduce` (SUM or MAX) waits for
    every rank's tensor and writes their reduction, in rank order, into
    each. Stands in for ``torch.distributed`` in ``models.attention``."""

    ReduceOp = dist.ReduceOp

    def __init__(self, d: int):
        self.d, self.barrier, self.slots = d, threading.Barrier(d), [None] * d
        self.local = threading.local()
        self.calls = 0

    def all_reduce(self, t, op=dist.ReduceOp.SUM, group=None):
        r = self.local.rank
        self.slots[r] = t.clone()
        self.barrier.wait()
        stack = torch.stack(self.slots)
        out = stack.amax(0) if op == dist.ReduceOp.MAX else stack.sum(0)
        if r == 0:
            self.calls += 1
        self.barrier.wait()
        t.copy_(out)

    def run(self, fn) -> list:
        outs, errors = [None] * self.d, []

        def body(r):
            self.local.rank = r
            try:
                outs[r] = fn(r)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=body, args=(r,)) for r in range(self.d)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return outs


def _inputs(seed: int = 0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    k = rng.standard_normal((B, SMAX, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, SMAX, KV, D)).astype(np.float32)
    return q, k, v


# (length, window): a block boundary of d=2 is at 16, of d=4 at 8, 16, 24
CASES = {
    "below-boundary": (15, None), "at-boundary": (16, None), "past-boundary": (17, None),
    "below-boundary-4": (7, None), "at-boundary-4": (8, None), "past-boundary-4": (9, None),
    "masked-blocks": (5, None),  # every block past the first wholly masked
    "window-straddles": (19, 6),  # positions 13..18 across the boundary at 16
    "window-masks-blocks": (30, 6),  # positions 24..29: the earlier blocks masked
    "whole": (32, None),
}


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_decode_attention_equals_the_reference_on_the_whole_cache(monkeypatch, d, case):
    import jax.numpy as jnp

    from repro.models.attention import decode_attention as ref_decode

    length, window = CASES[case]
    q, k, v = _inputs()
    want = np.asarray(ref_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(length, jnp.int32), window=window))
    ranks = _Threads(d)
    monkeypatch.setattr(pattn, "dist", ranks)
    n = SMAX // d
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    length_t = torch.tensor(length, dtype=torch.int32)
    outs = ranks.run(lambda r: pattn.decode_attention(
        qt, kt[:, r * n:(r + 1) * n], vt[:, r * n:(r + 1) * n], length_t, window=window,
        start=r * n, group=object()))
    assert ranks.calls == 3  # the row max, the row sum, the partial outputs
    for o in outs:
        assert o.shape == want.shape and torch.isfinite(o).all()
        assert float(np.abs(o.numpy() - want).max()) <= TOL * max(1.0, float(np.abs(want).max()))
    # the whole cache in one rank: the reference's route, untouched
    whole = pattn.decode_attention(qt, kt, vt, length_t, window=window)
    assert float(np.abs(whole.numpy() - want).max()) <= TOL


@pytest.mark.parametrize("d", [2, 4])
def test_sharded_write_lands_in_the_block_holding_the_slot(d):
    n = SMAX // d
    new_k, new_v = torch.ones((B, 1, KV, D)), torch.full((B, 1, KV, D), 2.0)
    for slot in sorted({0, n - 1, n, n + 1, SMAX - 1}):
        whole = {"k": torch.zeros((B, SMAX, KV, D)), "v": torch.zeros((B, SMAX, KV, D))}
        pblocks._write_slot(whole, torch.tensor(slot, dtype=torch.int32), new_k, new_v)
        for r in range(d):
            blk = {"k": torch.zeros((B, n, KV, D)), "v": torch.zeros((B, n, KV, D))}
            pblocks._write_slot(blk, torch.tensor(slot, dtype=torch.int32), new_k, new_v,
                                start=r * n)
            for name in ("k", "v"):
                assert torch.equal(blk[name], whole[name][:, r * n:(r + 1) * n]), (slot, r)


def test_prefill_of_a_prompt_longer_than_the_cache_raises():
    cfg = pconfigs.get_arch("gemma3-12b").smoke_config()
    model = pmodels.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    with pytest.raises(ValueError, match="does not fit a cache of 8 positions"):
        pmodels.prefill(model, cfg, torch.zeros((1, 9), dtype=torch.int32), 8)
