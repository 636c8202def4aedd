"""Native (C++) host components, bound with ctypes.

Counterpart of ``siddhi_tpu/native/``:

- the string dictionary encoder (``strdict.cpp``), which
  ``core/event.StringDictionary`` probes once per bulk encode;
- the columnar ingest loader (``csv_loader.cpp``): ``CsvLoader`` and
  ``JsonlLoader`` parse transport byte buffers in one C++ pass into the
  typed column arrays ``InputHandler.send_columns`` consumes, string
  attributes dictionary-encoded natively. The engine's bulk ingest from
  bytes: a second entry point in front of ``send_columns``.

Each library is built at first use with the host's ``g++`` into
``siddhi_tpu_torch/_build/`` (listed in ``.gitignore``), keyed by a hash
of the source and the flags so an edited source is rebuilt. A build goes
to a temporary file and is moved into place with ``os.replace``, so
processes building at once never load a half-written library. A failed
build raises with the compiler's output: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sysconfig
import threading
import weakref
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from siddhi_tpu_torch.ops.types import dtype_of
from siddhi_tpu_torch.query_api.definitions import AttrType

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE.parent / "_build"
STRDICT_SRC = _HERE / "strdict.cpp"
CSV_LOADER_SRC = _HERE / "csv_loader.cpp"
_LOCK = threading.Lock()
_STRDICT_LIB = None
_CSV_LOADER_LIB = None
_BASE_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]


def _flags():
    """The strdict library's flags: it walks PyObject* arrays."""
    return [*_BASE_FLAGS, "-I", sysconfig.get_paths()["include"]]


def _build(src: Path, stem: str, flags) -> Path:
    """The library built from ``src``, compiling it first if it is
    missing."""
    digest = hashlib.sha1(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:12]
    so = BUILD_DIR / f"lib{stem}-{digest}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *flags, str(src), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"{stem} build failed: cannot run g++ ({e})") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{stem} build failed (g++ exit {proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, so)
    return so


def build_strdict() -> Path:
    """The strdict library's path, compiling it first if it is missing."""
    return _build(STRDICT_SRC, "strdict", _flags())


def build_csv_loader() -> Path:
    """The ingest loader library's path (a plain C ABI: no Python
    headers), compiling it first if it is missing."""
    return _build(CSV_LOADER_SRC, "csv_loader", _BASE_FLAGS)


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


def csv_loader_lib() -> ctypes.CDLL:
    """The native ingest loader, built if needed."""
    global _CSV_LOADER_LIB
    with _LOCK:
        if _CSV_LOADER_LIB is not None:
            return _CSV_LOADER_LIB
        lib = ctypes.CDLL(str(build_csv_loader()))
        i64, i32, vp = ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p
        p_i32 = ctypes.POINTER(i32)
        p_u8p = ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))
        lib.loader_new.restype = vp
        lib.loader_new.argtypes = []
        lib.loader_free.restype = None
        lib.loader_free.argtypes = [vp]
        lib.loader_dict_size.restype = i64
        lib.loader_dict_size.argtypes = [vp]
        lib.loader_dict_bytes.restype = i64
        lib.loader_dict_bytes.argtypes = [vp, i64]
        lib.loader_dict_export.restype = i64
        lib.loader_dict_export.argtypes = [vp, i64, ctypes.c_char_p, i64,
                                           ctypes.POINTER(i64)]
        lib.loader_parse_csv.restype = i64
        lib.loader_parse_csv.argtypes = [
            vp, ctypes.c_char_p, i64, p_i32, i32, ctypes.POINTER(vp), p_u8p, i64]
        lib.loader_parse_jsonl.restype = i64
        lib.loader_parse_jsonl.argtypes = [
            vp, ctypes.c_char_p, i64, ctypes.c_char_p, p_i32, p_i32, i32,
            ctypes.POINTER(vp), p_u8p, i64]
        _CSV_LOADER_LIB = lib
        return lib


# attribute type -> the parser's column code (csv_loader.cpp COL_*)
_TYPE_CODES = {
    AttrType.INT: 0, AttrType.LONG: 0,
    AttrType.FLOAT: 1, AttrType.DOUBLE: 1,
    AttrType.STRING: 2,
    AttrType.BOOL: 3,
}
# the parser's output buffer per column code
_NATIVE_DTYPES = {0: np.int64, 1: np.float64, 2: np.int64, 3: np.uint8}


class CsvLoader:
    """Parse CSV byte buffers into ``send_columns``-ready column dicts.

    One line a row, one field an attribute in definition order, no
    quoting; an empty field is null (its ``name?`` mask is True), CRLF
    ends a line as LF does, a bool is true when it starts with ``t``,
    ``T`` or ``1``. String columns come back as the app dictionary's ids
    (int64): the parse's new strings, in order of first occurrence, go
    through one bulk ``StringDictionary.encode_array``, which assigns the
    ids one ``encode`` a string would. A malformed buffer raises
    ``ValueError``."""

    def __init__(self, definition, dictionary):
        self.definition = definition
        self.dictionary = dictionary
        self._lib = csv_loader_lib()
        self._loader = ctypes.c_void_p(self._lib.loader_new())
        weakref.finalize(self, self._lib.loader_free, self._loader)
        self._codes = np.array(
            [_TYPE_CODES[a.type] for a in definition.attributes], np.int32)
        # native-dictionary id -> app StringDictionary id
        self._remap = np.zeros(0, np.int64)

    def _sync_dictionary(self) -> None:
        start = len(self._remap)
        n = int(self._lib.loader_dict_size(self._loader))
        if n <= start:
            return
        size = int(self._lib.loader_dict_bytes(self._loader, start))
        buf = ctypes.create_string_buffer(max(size, 1))
        ends = np.zeros(n - start, np.int64)
        got = self._lib.loader_dict_export(
            self._loader, start, buf, size,
            ends.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        if got != n - start:
            raise RuntimeError(f"{type(self).__name__}: dictionary export "
                               f"returned {got} of {n - start} strings")
        raw = buf.raw
        new = np.empty(n - start, object)
        a = 0
        for k, b in enumerate(ends.tolist()):
            try:
                new[k] = raw[a:b].decode("utf-8")
            except UnicodeDecodeError:
                # the strings before it keep the ids they would have had
                # (the reference encodes them one by one before it fails);
                # the map stays as it was, so the next sync fails alike
                self.dictionary.encode_array(new[:k])
                raise
            a = b
        self._remap = np.concatenate(
            (self._remap, self.dictionary.encode_array(new).astype(np.int64)))

    def _native_parse(self, data, out_cols, out_masks, max_rows) -> int:
        return int(self._lib.loader_parse_csv(
            self._loader, data, len(data),
            self._codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(self.definition.attributes), out_cols, out_masks, max_rows))

    def parse(self, data: bytes, max_rows: Optional[int] = None
              ) -> Tuple[Dict[str, np.ndarray], int]:
        """-> (columns dict incl. ``name?`` null masks, n_rows)."""
        attrs = self.definition.attributes
        ncols = len(attrs)
        if max_rows is None:
            max_rows = data.count(b"\n") + 1
        natives: List[np.ndarray] = []
        masks: List[np.ndarray] = []
        out_cols = (ctypes.c_void_p * ncols)()
        out_masks = (ctypes.POINTER(ctypes.c_uint8) * ncols)()
        for c in range(ncols):
            arr = np.zeros(max_rows, _NATIVE_DTYPES[int(self._codes[c])])
            natives.append(arr)
            out_cols[c] = arr.ctypes.data_as(ctypes.c_void_p)
            mk = np.zeros(max_rows, np.uint8)
            masks.append(mk)
            out_masks[c] = mk.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        n = self._native_parse(data, out_cols, out_masks, max_rows)
        if n < 0:
            raise ValueError(f"{type(self).__name__}: parse failed")
        self._sync_dictionary()
        cols: Dict[str, np.ndarray] = {}
        for c, a in enumerate(attrs):
            v = natives[c][:n]
            if a.type == AttrType.STRING:
                # a null slot carries the id of the loader's first string
                # (as the reference's); with no string yet, NULL_ID
                v = (self._remap[v] if len(self._remap)
                     else np.full(n, self.dictionary.NULL_ID, np.int64))
            elif a.type == AttrType.BOOL:
                v = v.astype(bool)
            else:
                v = v.astype(dtype_of(a.type))
            cols[a.name] = v
            cols[a.name + "?"] = masks[c][:n].astype(bool)
        return cols, n


class JsonlLoader(CsvLoader):
    """Parse JSON-lines byte buffers (one flat object a line) into
    ``send_columns``-ready column dicts: the native counterpart of the
    json source mapper for bulk ingest. Fields resolve by attribute name;
    a missing key or a JSON null is null-masked, an unknown key skipped;
    strings take the ``\\" \\\\ \\/ \\n \\t \\r \\b \\f`` and
    ``\\uXXXX`` escapes (surrogate pairs included), encoded to UTF-8."""

    def __init__(self, definition, dictionary):
        super().__init__(definition, dictionary)
        self._names = "".join(a.name for a in definition.attributes).encode("utf-8")
        self._name_lens = np.array(
            [len(a.name.encode("utf-8")) for a in definition.attributes], np.int32)

    def _native_parse(self, data, out_cols, out_masks, max_rows) -> int:
        return int(self._lib.loader_parse_jsonl(
            self._loader, data, len(data), self._names,
            self._name_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self._codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(self.definition.attributes), out_cols, out_masks, max_rows))
