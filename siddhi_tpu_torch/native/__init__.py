"""Native (C++) host components, bound with ctypes.

Counterpart of ``siddhi_tpu/native/`` for the string dictionary encoder
(``strdict.cpp``), which ``core/event.StringDictionary`` probes once per
bulk encode. The library is built at first use with the host's ``g++``
against the CPython headers, into ``siddhi_tpu_torch/_build/`` (listed in
``.gitignore``), keyed by a hash of the source and the flags so an edited
source is rebuilt. A build goes to a temporary file and is moved into
place with ``os.replace``, so processes building at once never load a
half-written library. A failed build raises with the compiler's output:
there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sysconfig
import threading
from pathlib import Path

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE.parent / "_build"
STRDICT_SRC = _HERE / "strdict.cpp"
_LOCK = threading.Lock()
_STRDICT_LIB = None


def _flags():
    return ["-O2", "-shared", "-fPIC", "-std=c++17",
            "-I", sysconfig.get_paths()["include"]]


def _target() -> Path:
    digest = hashlib.sha1(STRDICT_SRC.read_bytes()
                          + " ".join(_flags()).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libstrdict-{digest}.so"


def build_strdict() -> Path:
    """The strdict library's path, compiling it first if it is missing."""
    so = _target()
    if so.exists():
        return so
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *_flags(), str(STRDICT_SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"strdict build failed: cannot run g++ ({e})") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"strdict build failed (g++ exit {proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, so)
    return so


def strdict_lib() -> ctypes.PyDLL:
    """The native string-dictionary encoder, built if needed. Loaded with
    PyDLL: ``strdict_encode`` walks PyObject* arrays and must hold the
    GIL."""
    global _STRDICT_LIB
    with _LOCK:
        if _STRDICT_LIB is not None:
            return _STRDICT_LIB
        lib = ctypes.PyDLL(str(build_strdict()))
        lib.strdict_new.restype = ctypes.c_void_p
        lib.strdict_new.argtypes = []
        lib.strdict_free.restype = None
        lib.strdict_free.argtypes = [ctypes.c_void_p]
        lib.strdict_clear.restype = None
        lib.strdict_clear.argtypes = [ctypes.c_void_p]
        lib.strdict_count.restype = ctypes.c_int64
        lib.strdict_count.argtypes = [ctypes.c_void_p]
        lib.strdict_insert.restype = None
        lib.strdict_insert.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64]
        lib.strdict_encode.restype = ctypes.c_int64
        lib.strdict_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64]
        _STRDICT_LIB = lib
        return lib
