"""The port's restartable token stream (``repro_torch.data.SyntheticLM``):
the contracts of ``tests/test_data.py``. torch cannot reproduce
``jax.random``'s bits, so the port keeps the reference's contracts, not its
tokens: determinism, restart reproducibility, distinct steps, the token
range and dtype, the motif structure and the state round trip."""

import numpy as np
import torch

from repro_torch.data import DataConfig, SyntheticLM


def _toks(dc, step):
    return SyntheticLM(dc, device="cpu").batch_at(step)["tokens"]


def test_deterministic_batches():
    dc = DataConfig(vocab_size=256, batch=4, seq_len=32, seed=7)
    assert torch.equal(_toks(dc, 5), _toks(dc, 5))


def test_restart_reproducibility():
    """Restarting at step k yields the same stream as never stopping."""
    dc = DataConfig(vocab_size=128, batch=2, seq_len=16, seed=1)
    data = SyntheticLM(dc, device="cpu")
    full = [data.batch_at(i)["tokens"] for i in range(10)]
    resumed = SyntheticLM(dc, device="cpu")
    for i in range(5, 10):
        assert torch.equal(full[i], resumed.batch_at(i)["tokens"])


def test_distinct_steps_and_seeds_give_distinct_batches():
    dc = DataConfig(vocab_size=256, batch=4, seq_len=32)
    assert not torch.equal(_toks(dc, 0), _toks(dc, 1))
    assert not torch.equal(_toks(dc, 0), _toks(DataConfig(256, 4, 32, seed=1), 0))


def test_token_range_and_structure():
    dc = DataConfig(vocab_size=100, batch=8, seq_len=64)
    toks = _toks(dc, 3)
    assert toks.shape == (8, 64) and toks.dtype == torch.int32
    assert int(toks.min()) >= 0 and int(toks.max()) < 100


def test_zipf_unigrams_and_motifs():
    """Low ids dominate (Zipf 1.2: id 0 holds ~1/ζ(1.2) ≈ 0.18 of the draws
    at this vocab, before the motif overlay), and each token repeats its
    motif run's first token with p = 0.5 (plus a chance draw of it)."""
    dc = DataConfig(vocab_size=1000, batch=64, seq_len=64, seed=2)
    toks = _toks(dc, 0).numpy()
    counts = np.bincount(toks.ravel(), minlength=dc.vocab_size)
    assert counts[0] > counts[1] > counts[10] and counts[0] / toks.size > 0.1
    runs = toks.reshape(dc.batch, -1, dc.motif_len)
    share = float((runs[..., 1:] == runs[..., :1]).mean())
    assert 0.5 <= share <= 0.65, share


def test_state_roundtrip():
    dc = DataConfig(vocab_size=100, batch=2, seq_len=8, seed=3)
    st = SyntheticLM(dc, device="cpu").state(42)
    assert st == {"step": 42, "seed": 3}
