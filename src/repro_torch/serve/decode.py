"""Serving driver: batched generation over prefill + decode_step
(counterpart of ``repro/serve/decode.py``).

The reference runs one fused compiled program per token
(``_fused_decode_step``: the decode step, the RNG fold and the sampling,
the cache donated). The port's counterpart is the same body,
:func:`_fused_decode_step`, captured in CUDA graphs on the card and
replayed once per token: the embedding of the token buffer, the decode
step, the sampling, the new token's write into the output at a device
index, the token buffer's update and the cache length's advance. Every
buffer stays at its address and nothing is read back, so the loop waits
for nothing until :func:`generate` returns.

With ``kv_compress=`` the prefilled global-attention caches become
decode-native compressed caches (:mod:`repro_torch.serve.kv_cache`) before
the loop. Their fold and refresh points depend only on the step index
(:func:`~repro_torch.serve.kv_cache.decode_schedule`), so the host picks
the graph: one for plain steps, one for folds (every fold offset: the
window is indexed on the device). A refresh step runs eagerly, on the card:
its SVD finalize waits for the host. A CPU tensor runs every step eagerly,
and so does the card inside :func:`~repro_torch.kernels.ops.eager_route`.

Under a mesh (:func:`~repro_torch.distributed.activation_sharding`) each
rank generates its rows of the batch on its shards of the weights (every
arch: GQA, shared and cross attention on the rank's heads, MLA on its
heads over the whole latent, Mamba-2 on its SSM heads, dense FFNs and MoE
experts on its blocks), its caches on its heads (the Mamba-2 states on its
heads and conv channels); the logits reach the sampling whole (gathered
over the model axis), so every rank of a model-axis group samples the same
tokens. The route is chosen by
the configuration, before the loop: at model axis ``m > 1`` the decode loop
runs the eager body (gloo stages a CUDA tensor's collective through the
host, which no CUDA graph can capture, and NCCL cannot hold two ranks of a
group on one card), and on a data-only mesh (``d × 1``) each rank captures
and replays its own graphs, a step there having no collective, unless the
MoE capacity dispatch gathers the expert ids over the data axes
(:func:`~repro_torch.models.moe.decode_gathers`), which runs it eagerly too,
or FSDP rules gather the weights over a data axis above 1 (eager too).
With the sequence-sharded decode cache (``activation_sharding(...,
seq_shard=True)``, the reference's ``long_500k`` cell) the prompt and the
result are whole on every data rank, each rank holds its block of every
K/V cache's positions, and the loop runs eagerly too: decode attention
combines the blocks over the data axes in every step.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from ..distributed.sharding import dp_index, fsdp_group, seq_group, tp_index
from ..kernels import ops
from ..models import decode_step, prefill
from ..models.blocks import PLAIN, REFRESH
from ..models.config import ModelConfig
from ..models.moe import decode_gathers
from .kv_cache import CompressedKV, compress_prefill_cache, decode_schedule
from .kv_compress import KVCompressionConfig

__all__ = ["generate", "sample_token"]


def sample_token(gen: Optional[torch.Generator], logits: torch.Tensor,
                 temperature: float = 0.0) -> torch.Tensor:
    """logits (B, 1, V), the whole vocab's → (B, 1) int32: the argmax at
    temperature 0 (ties to the lower index, as the reference's), else a draw
    from ``softmax(logits / temperature)`` with ``gen``:
    ``torch.multinomial``'s one-sample draw (the argmax of ``p / q``, ``q``
    exponential), bit for bit, without its check that reads the
    probabilities back.

    Under a mesh with ``d`` data ranks, ``logits`` are this rank's ``B``
    rows of the whole batch of ``B·d``: every rank draws the noise ``q`` of
    the whole batch (every rank seeds the same generator) and keeps its
    rows. The invariant: every rank's generator advances exactly as the
    one-rank run's does, so each data rank's rows get the tokens that run
    draws, and the ranks of a model-axis group draw the same ones."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits[:, 0].float() / temperature, dim=-1)
    di, d = dp_index()
    B, V = probs.shape
    q = torch.empty((B * d, V), dtype=probs.dtype, device=probs.device).exponential_(
        1, generator=gen)[di * B:(di + 1) * B]
    return torch.argmax(probs / q, dim=-1, keepdim=True).to(torch.int32)


def _fused_decode_step(params, cfg: ModelConfig, cache: dict, tok: torch.Tensor,
                       gen: Optional[torch.Generator], step_i: torch.Tensor, temperature: float,
                       dense_moe: bool, *, out: torch.Tensor, phase: str = PLAIN) -> torch.Tensor:
    """One token, in place: :func:`~repro_torch.models.decode_step` on the
    token buffer ``tok`` (B, 1) (it embeds the token and advances the
    cache's length), the sampling with ``gen``, the sampled token written
    into ``out`` (B, n_tokens) at the device index ``step_i`` (a 0-d int),
    ``tok`` set to it and ``step_i`` advanced. The body the graphs capture;
    returns the step's logits (B, 1, V)."""
    logits, _ = decode_step(params, cfg, cache, tok, dense_moe=dense_moe, phase=phase)
    nxt = sample_token(gen, logits, temperature)
    out.index_copy_(1, step_i.reshape(1).long(), nxt)
    tok.copy_(nxt)
    step_i.add_(1)
    return logits


class _DecodeGraphs:
    """The CUDA graphs of one :func:`generate` call, one per phase, in one
    memory pool. A phase's first step is its warm-up: it runs eagerly on a
    side stream (lazy initialisation, workspaces) under
    ``set_sync_debug_mode("error")``, so a step that reads a value back
    raises; then the phase's graph is captured, and every later step of the
    phase replays it, counting the kernel launches it holds. A failed
    capture raises."""

    def __init__(self, body: Callable[[str], torch.Tensor], gen: Optional[torch.Generator]):
        self.body, self.gen = body, gen  # gen: registered with each graph when sampling draws
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs = {}  # phase -> (graph, its logits, its launches)
        self.pool_bytes = 0
        self.replays = 0

    def capture(self, phase: str) -> torch.Tensor:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        mode = torch.cuda.get_sync_debug_mode()
        with torch.cuda.stream(side):
            torch.cuda.set_sync_debug_mode("error")
            try:
                logits = self.body(phase)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        torch.cuda.current_stream().wait_stream(side)
        # what torch.cuda.graph does on entry, first here: the pool's growth
        # then reads from the reserved bytes alone
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        graph = torch.cuda.CUDAGraph()
        if self.gen is not None:
            graph.register_generator_state(self.gen)
        with ops.captured_launches() as launches, torch.cuda.graph(graph, pool=self.pool):
            static = self.body(phase)
        self.pool_bytes += torch.cuda.memory_reserved() - reserved
        self.graphs[phase] = (graph, static, launches)
        return logits

    def replay(self, phase: str) -> torch.Tensor:
        graph, logits, launches = self.graphs[phase]
        graph.replay()
        ops.add_launches(launches)
        self.replays += 1
        return logits


class _Clock:
    """Phase times of one :func:`generate` call in ms, summed by name: CUDA
    events on the card (read once, at the end), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def mark(self, name: str) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((name, ev))
        else:
            self.marks.append((name, time.perf_counter()))

    def read(self) -> dict:
        if self.cuda:
            torch.cuda.synchronize()
        out = {}
        for (_, t0), (name, t1) in zip(self.marks, self.marks[1:]):
            dt = t0.elapsed_time(t1) if self.cuda else (t1 - t0) * 1e3
            out[name] = out.get(name, 0.0) + dt
        return out


@torch.no_grad()
def generate(params, cfg: ModelConfig, prompt: torch.Tensor, n_tokens: int, *,
             gen: Optional[torch.Generator] = None, temperature: float = 0.0, vision=None,
             dense_moe: bool = False, kv_compress: Optional[KVCompressionConfig] = None,
             registry=None, kv_sketches: Optional[dict] = None,
             timings: Optional[dict] = None, stats: Optional[dict] = None,
             on_step: Optional[Callable[[int, torch.Tensor], None]] = None) -> torch.Tensor:
    """Greedy or temperature generation; prompt (B, S) on the model's
    device. Returns (B, n_tokens) int32. ``vision``: a vlm config's patch
    embeddings (B, n_patches, d_vision), read once, at prefill.

    On the card the decode loop replays CUDA graphs of
    :func:`_fused_decode_step` (module docstring); on the CPU, inside
    :func:`~repro_torch.kernels.ops.eager_route`, at model axis ``m > 1``
    or where the MoE dispatch gathers over the data axes, FSDP gathers
    over them or a sequence-sharded cache combines over them (the step's
    collectives cannot be captured), it runs the same body eagerly. Under
    a mesh ``prompt`` (and ``vision``) are this rank's rows
    (:func:`~repro_torch.distributed.shard_batch`) and so is the result;
    with ``seq_shard`` both are the whole batch, on every data rank.

    ``gen`` draws the sampled tokens and, with ``kv_compress``, the
    compressed caches' sketches (``kv_sketches`` hands pre-drawn ones to
    :func:`~repro_torch.serve.kv_cache.compress_prefill_cache`); ``None``
    seeds 0 on the prompt's device. ``registry`` forwards a metrics
    registry to the conversion. ``timings``, when given, receives the ms
    of ``prefill``, ``convert``, ``capture`` (the graphs' warm-up steps
    and captures; 0 on the eager route), ``refresh`` (a compressed cache's
    refresh steps) and ``decode`` (every other decode step). ``stats``
    receives the loop's ``route`` ("graph" or "eager"),
    ``graphs`` captured, ``replays``, ``eager_steps`` (warm-ups apart),
    ``refresh_steps`` and the graphs' ``pool_bytes``. ``on_step(i,
    logits)`` is called on the host after decode step ``i`` with its
    logits (B, 1, V); on the graph route they are the graph's output,
    overwritten by its next replay.
    """
    dev = prompt.device
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
    clock = _Clock(dev)
    clock.mark("start")
    logits, cache = prefill(params, cfg, prompt, prompt.shape[1] + n_tokens, vision=vision,
                            dense_moe=dense_moe)
    clock.mark("prefill")
    if kv_compress is not None:
        cache = compress_prefill_cache(gen, cfg, cache, kv_compress, registry=registry,
                                       sketches=kv_sketches)
    clock.mark("convert")
    compressed = any(isinstance(c, CompressedKV) for c in cache["layers"])
    schedule = decode_schedule(kv_compress if compressed else None, n_tokens - 1)
    out = torch.empty((prompt.shape[0], n_tokens), dtype=torch.int32, device=dev)
    tok = sample_token(gen, logits, temperature)
    out[:, :1] = tok
    step_i = torch.ones((), dtype=torch.int32, device=dev)

    def body(phase: str) -> torch.Tensor:
        return _fused_decode_step(params, cfg, cache, tok, gen, step_i, temperature, dense_moe,
                                  out=out, phase=phase)

    graphs = None
    # gloo's host-staged collectives cannot be captured: the model axis's,
    # the MoE dispatch's gathers, FSDP's (above data axis 1) and a
    # sequence-sharded cache's combine run eagerly
    if (dev.type == "cuda" and not ops._EAGER and tp_index()[1] == 1 and fsdp_group() is None
            and seq_group() is None and not decode_gathers(cfg, dense_moe, prompt.shape[0])):
        graphs = _DecodeGraphs(body, gen if temperature > 0.0 else None)
    eager = refreshes = 0
    for i, (phase, _) in enumerate(schedule):
        if phase == REFRESH:
            clock.mark("decode")
            logits = body(phase)
            clock.mark("refresh")
            eager += 1
            refreshes += 1
        elif graphs is None:
            logits = body(phase)
            eager += 1
        elif phase in graphs.graphs:
            logits = graphs.replay(phase)
        else:
            clock.mark("decode")
            logits = graphs.capture(phase)
            clock.mark("capture")
        if on_step is not None:
            on_step(i, logits)
    clock.mark("decode")
    if timings is not None:
        timings.update({"capture": 0.0, "refresh": 0.0, **clock.read()})
    if stats is not None:
        stats.update(route="eager" if graphs is None else "graph", eager_steps=eager,
                     refresh_steps=refreshes, graphs=0 if graphs is None else len(graphs.graphs),
                     replays=0 if graphs is None else graphs.replays,
                     pool_bytes=0 if graphs is None else graphs.pool_bytes)
    return out
