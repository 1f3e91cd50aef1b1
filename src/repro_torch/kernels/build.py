"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source is compiled by its own ``nvcc`` into a shared library with a
plain C interface (``-gencode arch=compute_90a,code=sm_90a -O3 -shared``),
all compilers started together, and loaded with ``ctypes``. Libraries live in
``build/repro_torch_kernels/<hash>/`` at the repository root (listed in
``.gitignore``), keyed by a hash of every source and the flags, so an edit to
any source rebuilds and an unchanged tree loads what is there. A failed build
raises. Nothing is compiled when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("countsketch", "panel_score", "panel_update", "twoside_sketch")
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C signatures of each library's functions, named <library>_<function> (all
# return a cudaError_t).
SIGNATURES = {
    "countsketch": {
        "countsketch_launch": [_I, _P, _P, _P, _P, _L, _L, _P, _L, _L, _I, _I, _P],
        "countsketch_fold_launch": [_I, _I, _I, _P, _P, _P, _P, _L, _L, _P, _L, _I, _I, _P],
        "countsketch_view_launch": [_I, _P, _P, _P, _P, _P, _L, _I, _I, _P, _L, _L, _I, _I, _P],
        "countsketch_batched_launch": [_I, _P, _P, _P, _P, _L, _L, _L, _P, _L, _L, _L, _I, _I,
                                       _I, _I, _L, _L, _L, _P],
        "countsketch_batched_fold_launch": [_I, _I, _P, _P, _P, _P, _L, _L, _L, _P, _L, _L, _I,
                                            _I, _I, _I, _L, _L, _L, _P],
        "countsketch_batched_view_launch": [_I, _P, _P, _P, _P, _P, _L, _L, _I, _I, _P, _L, _L,
                                            _L, _I, _I, _I, _I, _L, _L, _L, _P],
    },
    "panel_score": {
        "panel_score_launch": [_I, _I, _P, _L, _P, _L, _P, _L, _I, _P, _I, _P, _P, _P, _P,
                               _I, _I, _I, _P],
        "panel_score_blocks_per_sm": [_I, _I, _P],
        "panel_score_geometry": [_P],
    },
    "panel_update": {
        "panel_update_launch": [_I, _I, _I, _I, _P, _L, _P, _L, _P, _L, _P, _L, _I, _P, _L,
                                _I, _P, _L, _P, _P, _I, _P, _I, _I, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _P],
        "panel_update_blocks_per_sm": [_I, _I, _I, _I, _I, _P],
        "panel_update_geometry": [_P],
    },
    "twoside_sketch": {
        "twoside_sketch_launch": [_I, _P, _L, _P, _L, _L, _P, _L, _P, _P, _P, _I, _I, _I, _I,
                                  _I, _I, _L, _I, _L, _P],
        "twoside_sketch_blocks_per_sm": [_I, _I, _P],
        "twoside_sketch_geometry": [_P],
    },
}

_lock = threading.Lock()
_libs: dict = {}
build_log: dict = {}  # name -> compiler output of the library's build (ptxas usage)
build_seconds: float = 0.0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> dict:
    """Compile every missing library in parallel and load all of them."""
    global build_seconds
    with _lock:
        if len(_libs) == len(SOURCES):
            return _libs
        t0 = time.perf_counter()
        out_dir = BUILD_ROOT / source_hash()
        out_dir.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in SOURCES:
            lib = out_dir / f"lib{name}.so"
            if lib.exists():
                continue
            tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
            cmd = [_nvcc(), *FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True), tmp, lib)
        failed = []
        for name, (proc, tmp, lib) in procs.items():
            out, _ = proc.communicate()
            build_log[name] = out
            if proc.returncode != 0:
                failed.append(f"--- {name}.cu (exit {proc.returncode}) ---\n{out}")
            else:
                (out_dir / f"lib{name}.log").write_text(out)
                os.replace(tmp, lib)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        for name in SOURCES:
            log = out_dir / f"lib{name}.log"
            if name not in build_log and log.exists():  # built by an earlier process
                build_log[name] = log.read_text()
            lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
            fns = {}
            for fn_name, argtypes in SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                fns[fn_name] = fn
            _libs[name] = fns
        build_seconds = time.perf_counter() - t0
        return _libs


def launcher(name: str, fn: str = "launch"):
    """The ctypes function ``<name>_<fn>`` of kernel ``name`` (its launch
    function by default), building on first use."""
    return build_all()[name][f"{name}_{fn}"]
