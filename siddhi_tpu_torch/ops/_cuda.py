"""Build and load the port's CUDA kernels (``siddhi_tpu_torch/csrc``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes``; no PyTorch headers are
included, so a build takes seconds. The build runs at first use, into
``siddhi_tpu_torch/_build/`` (listed in ``.gitignore``), keyed by a hash of
the source so an edited kernel is rebuilt. ``build(names)`` starts one
``nvcc`` per source, all at once, and waits for them together.

A wrapper counts what it launches with ``count``; a CUDA-graph capture
on the calling thread (``core/query/step_graph.py``) takes those counts
into its own tally instead (``capture_tally``), since a capture launches
nothing: the graph adds them at each replay.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Tuple

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOGS: Dict[str, str] = {}
# the wrappers' counters are bumped from every thread that launches
_COUNT_LOCK = threading.Lock()
# this thread's capture tally, while it captures a graph
_CAPTURING = threading.local()


def count(wrapper, attr: str = "launches", n: int = 1) -> None:
    """Add ``n`` to a kernel wrapper's counter ``wrapper.<attr>`` (its
    launches, the columns it moved); inside ``capture_tally`` on this
    thread, to the tally instead."""
    tally = getattr(_CAPTURING, "tally", None)
    if tally is not None:
        tally[(wrapper, attr)] = tally.get((wrapper, attr), 0) + n
        return
    with _COUNT_LOCK:
        setattr(wrapper, attr, getattr(wrapper, attr) + n)


@contextlib.contextmanager
def capture_tally():
    """While a graph is captured on this thread, its wrappers' counts go
    to the yielded tally ``{(wrapper, attr): n}``, not to the counters:
    another thread's launches meanwhile are counted as they happen."""
    prev = getattr(_CAPTURING, "tally", None)
    tally = _CAPTURING.tally = {}
    try:
        yield tally
    finally:
        _CAPTURING.tally = prev


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _target(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str]) -> Dict[str, Tuple[Path, str]]:
    """Compile every named source that has no current library, all in
    parallel. Returns {name: (library path, compiler output)}; raises with
    the compiler output if any build fails."""
    names = list(names)
    BUILD_DIR.mkdir(exist_ok=True)
    procs = {}
    for name in names:
        so = _target(name)
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so)
    failed = []
    for name, (proc, tmp, so) in procs.items():
        log, _ = proc.communicate()
        _LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, so)     # atomic: a reader never sees a half file
        (BUILD_DIR / f"{name}.log").write_text(log)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    out = {}
    for name in names:
        so = _target(name)
        log = _LOGS.get(name)
        if log is None:
            logf = BUILD_DIR / f"{name}.log"
            log = logf.read_text() if logf.exists() else ""
        out[name] = (so, log)
    return out


def load(name: str, bind) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed;
    ``bind(lib)`` declares its C signatures once, at load."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            so, _log = build([name])[name]
            lib = ctypes.CDLL(str(so))
            bind(lib)
            lib.siddhi_cuda_error_string.restype = ctypes.c_char_p
            lib.siddhi_cuda_error_string.argtypes = [ctypes.c_int]
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if code != 0:
        msg = lib.siddhi_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
