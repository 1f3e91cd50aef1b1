"""Checkpoints of tensor trees and stream states, on disk in the reference's
two layouts (counterpart of ``repro/checkpoint/checkpoint.py``).

Layouts, byte-compatible with the reference's, so a checkpoint written by
either package restores in the other:

* directory: ``<dir>/step_<N>/manifest.json`` (step, leaf index
  ``{key: {file, shape, dtype, viewed}}``, extra metadata) plus one ``.npy``
  per leaf, written into ``step_<N>.tmp`` and renamed into place;
* packed (``pack=True``): ``<dir>/step_<N>.ckpt`` = ``RPCKPT1\\n`` + u64le
  header length + compact JSON header (``step``, ``leaves{offset, nbytes,
  shape, dtype, store, viewed}``, ``extra``, ``payload_bytes``) + the raw
  leaf bytes, one file write and one rename per save.

Leaves are named by the reference's ``jax.tree_util.keystr`` paths
(``.C``, ``.ctx.S_C.hashes``, ``['params']['w']``): :func:`_walk` turns a
tree — dicts (keys in sorted order), lists, tuples and dataclasses, such as
a :class:`~repro_torch.stream.engine.PanelState` — into ``(key, leaf)``
pairs and back. An ``nn.Module`` (a train state's model) is walked as the
dict of its ``named_parameters()`` (``['params']['blocks.0.ffn.w_up']``),
and a restore copies the loaded values into those parameters in place,
returning the template's module. A train checkpoint's layout is therefore
the port's per-layer one, not the reference's scan stacks: it restores in
the port only. Tensor fields are leaves, ``None`` fields are skipped as
the reference skips them, and the host scalars that are 0-dim leaves in the
reference (``PanelState.offset``, the adaptive contexts' ``slot_lo``,
``min_gain``, ``swap_gain``, ``seen_lo``; :data:`_SCALAR_LEAVES`) are
stored as such; every other field is static and comes from the template.
bfloat16 (which numpy lacks) is stored as a ``uint16`` view with
``"dtype": "bfloat16", "viewed": true``, as the reference stores it.

Every file goes to a ``.part`` and is promoted with ``os.replace``, so no
reader ever opens a half-written file; a torn checkpoint (unparseable
manifest or header, a missing or empty leaf file, a packed file of the
wrong size) is skipped by :func:`list_steps` and :func:`restore`.
``durable=False`` skips the fsync (process-death fault model). ``keep_last``
removes older steps of both layouts.

Restore places each tensor on its template leaf's device, in the template
leaf's dtype (the reference's ``shardings=`` becomes placement by
template), into fresh storage (a module's parameters: in place). Read-only parts — sketches (frozen
dataclasses) and fields a class lists in ``FRESH_SHARED`` (Ω_test, the
dense ``S_R`` of adaptive rows) — come back as the template's own objects
when the saved values equal them, as :func:`~repro_torch.stream.engine.fresh_state`
shares them, so a sketch keeps its cached window orders; otherwise they are
rebuilt with empty caches. ``async_=True`` copies every tensor to host
memory before it returns (the engine updates C, R and M in place on the
next chunk) and only writes the files on a thread.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading
from typing import Any, Callable, Optional

import numpy as np
import torch

__all__ = ["save", "restore", "latest_step", "list_steps"]

_SANITIZE = re.compile(r"[^A-Za-z0-9_.-]+")

# numpy-native dtypes round-trip through .npy; the others (bfloat16, fp8)
# are stored as an unsigned view with the true name in the manifest
_NATIVE_DTYPES = {
    "float64", "float32", "float16", "int64", "int32", "int16", "int8",
    "uint64", "uint32", "uint16", "uint8", "bool",
}
_SIGNED_VIEW = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}

# host scalars of the port that are 0-dim leaves in the reference, by class
_SCALAR_LEAVES = {
    "PanelState": {"offset": "int32"},
    "AdaptiveCURCtx": {"slot_lo": "int32", "min_gain": "float32", "swap_gain": "float32"},
    "AdaptiveRowState": {"slot_lo": "int32", "min_gain": "float32", "seen_lo": "int32"},
}

_PACK_MAGIC = b"RPCKPT1\n"
_PACK_SUFFIX = ".ckpt"


def _leaf_name(key: str) -> str:
    """File name stem of the leaf at ``key`` (a keystr path)."""
    return _SANITIZE.sub("_", key).strip("_") or "root"


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


# ---- tree walking ---------------------------------------------------------


def _walk(node, key: str, fn: Callable, scalar: Optional[str] = None):
    """``node`` rebuilt with ``fn(key, leaf, scalar)`` in place of every leaf,
    visiting the leaves in the reference's flattening order (``scalar`` is
    the stored dtype of a host-scalar leaf, else ``None``)."""
    if scalar is not None or torch.is_tensor(node):
        return fn(key, node, scalar)
    if isinstance(node, dict):
        out = {k: _walk(node[k], f"{key}[{k!r}]", fn) for k in sorted(node)}
        return {k: out[k] for k in node}
    if isinstance(node, (list, tuple)):
        return type(node)(_walk(v, f"{key}[{i}]", fn) for i, v in enumerate(node))
    if isinstance(node, torch.nn.Module):
        return _walk_module(node, key, fn)
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return _walk_dataclass(node, key, fn)
    raise TypeError(f"{key or 'root'}: cannot checkpoint a leaf of type {type(node).__name__}")


def _walk_dataclass(node, key: str, fn: Callable):
    scalars = _SCALAR_LEAVES.get(type(node).__name__, {})
    shared = set(getattr(node, "FRESH_SHARED", ()))
    frozen = type(node).__dataclass_params__.frozen
    fields = [f for f in dataclasses.fields(node) if f.init]
    changes = {}
    for f in fields:
        v = getattr(node, f.name)
        if v is None:
            continue
        if f.name in scalars:
            changes[f.name] = _walk(v, f"{key}.{f.name}", fn, scalars[f.name])
        elif torch.is_tensor(v) or (dataclasses.is_dataclass(v) and not isinstance(v, type)):
            new = _walk(v, f"{key}.{f.name}", fn)
            if (frozen or f.name in shared) and new is not v and _same_values(new, v):
                new = v  # a read-only value: keep the template's object
            changes[f.name] = new
    if all(changes[k] is getattr(node, k) for k in changes):
        return node
    if frozen:  # a rebuilt sketch starts with empty caches (its ``_``-fields)
        changes.update({f.name: f.default_factory() for f in fields if f.name.startswith("_")
                        and f.default_factory is not dataclasses.MISSING})
    return dataclasses.replace(node, **changes)


def _walk_module(node: torch.nn.Module, key: str, fn: Callable):
    """A module's parameters, walked as the dict ``named_parameters()``; a
    restored value is copied into its parameter in place, and the module
    itself is returned."""
    params = dict(node.named_parameters())
    out = _walk(params, key, fn)
    with torch.no_grad():
        for name, t in out.items():
            if t is not params[name]:
                params[name].copy_(t)
    return node


def _same_values(a, b) -> bool:
    if torch.is_tensor(a):
        return a.dtype == b.dtype and a.device == b.device and bool(torch.equal(a, b))
    return all(_same_values(getattr(a, f.name), getattr(b, f.name))
               for f in dataclasses.fields(a) if torch.is_tensor(getattr(a, f.name)))


def _leaves(tree) -> list:
    """``[(key, leaf, scalar dtype or None)]`` in flattening order."""
    out = []

    def visit(key, leaf, scalar):
        out.append((key, leaf, scalar))
        return leaf

    _walk(tree, "", visit)
    return out


# ---- host snapshot ----------------------------------------------------------


def _host_snapshot(leaves, copy_cpu: bool) -> list:
    """``[(key, host tensor)]``: CUDA leaves copied into pinned host memory
    with one synchronisation for all of them; CPU leaves as they are, or
    cloned when ``copy_cpu`` (an async save must not see later updates);
    host scalars as 0-dim tensors of their stored dtype."""
    out, synced = [], False
    for key, leaf, scalar in leaves:
        if scalar is not None:
            host = torch.tensor(np.asarray(leaf, dtype=scalar))
        elif leaf.is_cuda:
            host = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=True)
            host.copy_(leaf.detach(), non_blocking=True)
            synced = True
        else:
            host = leaf.detach().clone() if copy_cpu else leaf.detach()
        out.append((key, host))
    if synced:
        torch.cuda.synchronize()
    return out


def _to_savable(t: torch.Tensor):
    """``(numpy array, dtype name, viewed)``: a dtype numpy lacks is stored
    as the unsigned integer view of its bits."""
    name = _dtype_name(t.dtype)
    t = t.contiguous()
    if name in _NATIVE_DTYPES:
        return t.numpy(), name, False
    size = t.element_size()
    return t.view(_SIGNED_VIEW[size]).numpy().view(np.dtype(f"u{size}")), name, True


def _host_dtype(store: np.dtype) -> torch.dtype:
    """The torch dtype a stored array is read into: an unsigned store as the
    signed integer view of its bits (torch has few unsigned dtypes)."""
    if store.kind == "u":
        return _SIGNED_VIEW[store.itemsize]
    return getattr(torch, str(store))


def _as_dtype(host: torch.Tensor, dtype_name: str) -> torch.Tensor:
    """``host``'s bits as the leaf's true dtype (a viewed store's, e.g. bfloat16)."""
    dtype = getattr(torch, dtype_name)
    return host if host.dtype == dtype else host.view(dtype)


def _from_saved(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if arr.dtype.kind == "u":
        arr = arr.view(np.dtype(f"i{arr.dtype.itemsize}"))
    return _as_dtype(torch.from_numpy(arr), dtype_name)


# ---- packed single-file layout -------------------------------------------


def _pack_parts(step: int, host, extra: Optional[dict]):
    """``(header bytes, payload arrays)`` of the packed layout; the arrays
    are written straight to the file, never joined."""
    index, chunks, off = {}, [], 0
    for key, t in host:
        savable, dtype_name, viewed = _to_savable(t)
        index[key] = {
            "offset": off,
            "nbytes": int(savable.nbytes),
            "shape": list(t.shape),
            "dtype": dtype_name,
            "store": str(savable.dtype),
            "viewed": viewed,
        }
        chunks.append(savable)
        off += int(savable.nbytes)
    header = json.dumps(
        {"step": step, "leaves": index, "extra": extra or {}, "payload_bytes": off},
        separators=(",", ":"),
    ).encode()
    return b"".join([_PACK_MAGIC, len(header).to_bytes(8, "little"), header]), chunks


def _read_packed_manifest(path: str):
    """The packed checkpoint's header, or ``None`` if torn (bad magic,
    unparseable header, or a file size other than header + payload)."""
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            if f.read(len(_PACK_MAGIC)) != _PACK_MAGIC:
                return None
            hlen = int.from_bytes(f.read(8), "little")
            header = json.loads(f.read(hlen))
        data_start = len(_PACK_MAGIC) + 8 + hlen
        if size != data_start + int(header["payload_bytes"]):
            return None
        header["_data_start"] = data_start
        return header
    except (OSError, ValueError, KeyError, TypeError):
        return None


def _atomic_write(dest: str, writer, *, durable: bool = True):
    """Write ``dest`` through a ``.part`` file promoted with ``os.replace``:
    a crash mid-write leaves only the ``.part``. ``durable=False`` skips the
    fsync (atomic against process death, not against power loss)."""
    part = dest + ".part"
    with open(part, "wb") as f:
        writer(f)
        f.flush()
        if durable:
            os.fsync(f.fileno())
    os.replace(part, dest)


def save(
    directory: str,
    step: int,
    tree: Any,
    *,
    extra: Optional[dict] = None,
    keep_last: int = 3,
    async_: bool = False,
    durable: bool = True,
    pack: bool = False,
):
    """Write a checkpoint of ``tree`` at ``step``; returns the final path, or
    the writing ``threading.Thread`` when ``async_``.

    The host snapshot is taken before this returns, ``async_`` or not: only
    the file writes move to the thread. ``pack=True`` writes the single-file
    layout; ``durable=False`` drops the fsync; ``keep_last`` (> 0) keeps
    that many newest steps of either layout."""
    host = _host_snapshot(_leaves(tree), copy_cpu=async_)

    if pack:
        header, chunks = _pack_parts(step, host, extra)

        def _write():
            os.makedirs(directory, exist_ok=True)
            final = os.path.join(directory, f"step_{step:08d}{_PACK_SUFFIX}")

            def _writer(f):
                f.write(header)
                for arr in chunks:
                    f.write(arr.reshape(-1).view(np.uint8))

            _atomic_write(final, _writer, durable=durable)
            _gc(directory, keep_last)
            return final

    else:

        def _write():
            os.makedirs(directory, exist_ok=True)
            final = os.path.join(directory, f"step_{step:08d}")
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            index = {}
            for key, t in host:
                fname = _leaf_name(key) + ".npy"
                savable, dtype_name, viewed = _to_savable(t)
                _atomic_write(os.path.join(tmp, fname), lambda f: np.save(f, savable),
                              durable=durable)
                index[key] = {"file": fname, "shape": list(t.shape), "dtype": dtype_name,
                              "viewed": viewed}
            manifest = {"step": step, "leaves": index, "extra": extra or {}}
            _atomic_write(os.path.join(tmp, "manifest.json"),
                          lambda f: f.write(json.dumps(manifest, indent=1).encode()),
                          durable=durable)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            _gc(directory, keep_last)
            return final

    if async_:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    return _write()


def _gc(directory: str, keep_last: int):
    if keep_last <= 0:
        return
    # a raw listing: torn checkpoints are garbage too, and this runs per save
    steps = set()
    for d in os.listdir(directory):
        m = re.fullmatch(rf"step_(\d+)(?:{re.escape(_PACK_SUFFIX)})?", d)
        if m:
            steps.add(int(m.group(1)))
    for s in sorted(steps)[:-keep_last]:
        base = os.path.join(directory, f"step_{s:08d}")
        shutil.rmtree(base, ignore_errors=True)
        try:
            os.unlink(base + _PACK_SUFFIX)
        except OSError:
            pass


def _read_manifest(ckpt_dir: str) -> Optional[dict]:
    """The directory checkpoint's manifest if it parses and every leaf file
    it indexes exists non-empty; else ``None`` (a torn write)."""
    try:
        with open(os.path.join(ckpt_dir, "manifest.json")) as f:
            manifest = json.load(f)
        leaves = manifest["leaves"]
    except (OSError, ValueError, KeyError, TypeError):
        return None
    for entry in leaves.values():
        try:
            if os.path.getsize(os.path.join(ckpt_dir, entry["file"])) <= 0:
                return None
        except (OSError, KeyError, TypeError):
            return None
    return manifest


def list_steps(directory: str):
    """Steps with intact checkpoints, in either layout (torn ones skipped)."""
    if not os.path.isdir(directory):
        return []
    out = set()
    for d in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", d)
        if m and _read_manifest(os.path.join(directory, d)) is not None:
            out.add(int(m.group(1)))
            continue
        m = re.fullmatch(rf"step_(\d+){re.escape(_PACK_SUFFIX)}", d)
        if m and _read_packed_manifest(os.path.join(directory, d)) is not None:
            out.add(int(m.group(1)))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = list_steps(directory)
    return steps[-1] if steps else None


def _read_packed_leaf(f, data_start: int, entry: dict, pin: bool) -> torch.Tensor:
    """One packed leaf read straight into (pinned, for a CUDA template) host
    memory, as a tensor of its true dtype."""
    host = torch.empty(entry["shape"], dtype=_host_dtype(np.dtype(entry["store"])),
                       pin_memory=pin)
    f.seek(data_start + entry["offset"])
    if f.readinto(host.numpy().reshape(-1).view(np.uint8)) != entry["nbytes"]:
        raise ValueError(f"short read of a leaf of {entry['nbytes']} bytes")
    return _as_dtype(host, entry["dtype"])


def restore(directory: str, template: Any, *, step: Optional[int] = None):
    """Load the checkpoint at ``step`` (default: the newest intact one) into
    the structure of ``template`` (its values are not read but for the
    read-only parts, see the module docstring). Returns ``(tree, extra,
    step)``. Raises ``FileNotFoundError`` for a missing or torn step,
    ``KeyError`` for a leaf the checkpoint lacks, ``ValueError`` for a shape
    other than the template's."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no intact checkpoints under {directory}")
    ckpt = os.path.join(directory, f"step_{step:08d}")
    packed = _read_packed_manifest(ckpt + _PACK_SUFFIX)
    manifest = packed if packed is not None else _read_manifest(ckpt)
    if manifest is None:
        raise FileNotFoundError(
            f"checkpoint at step {step} under {directory} is missing or torn "
            "(manifest unreadable or leaf files incomplete)"
        )
    f = open(ckpt + _PACK_SUFFIX, "rb") if packed is not None else None
    try:

        def load(key, tmpl, scalar):
            if key not in manifest["leaves"]:
                raise KeyError(f"checkpoint at step {step} is missing leaf {key}")
            entry = manifest["leaves"][key]
            on_cuda = scalar is None and tmpl.is_cuda
            if f is not None:
                host = _read_packed_leaf(f, packed["_data_start"], entry, pin=on_cuda)
            else:
                host = _from_saved(np.load(os.path.join(ckpt, entry["file"])), entry["dtype"])
            want = () if scalar is not None else tuple(tmpl.shape)
            if tuple(host.shape) != want:
                raise ValueError(f"{key}: checkpoint shape {tuple(host.shape)} != template {want}")
            if scalar is not None:  # a host scalar: the template's own value when equal
                value = host.item()
                return tmpl if np.asarray(tmpl, dtype=scalar).item() == value else type(tmpl)(value)
            return host.to(device=tmpl.device, dtype=tmpl.dtype, non_blocking=on_cuda)

        tree = _walk(template, "", load)
    finally:
        if f is not None:
            f.close()
    return tree, manifest.get("extra", {}), step
