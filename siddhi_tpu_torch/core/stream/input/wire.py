"""Zero-copy columnar wire format — the production ingest front door.

Counterpart of ``siddhi_tpu/core/stream/input/wire.py``, frame for frame
compatible with it: a client encodes a batch of events as ONE binary
frame of contiguous typed column buffers; the server ingests it with
``np.frombuffer`` views and ZERO per-event Python — no JSON rows, no
``Event`` objects, no per-string dictionary probes on the hot path. A
decoded frame feeds ``InputHandler.send_columns``. The views are
read-only: the ingest path copies them into its own batch (and from
there into pinned staging buffers), never writing back.

Frame layout (all little-endian; Arrow's spirit, one frame = one batch)::

    0   magic   b"SWF1"
    4   u16     version (1)
    6   u16     flags (bit0: frame carries a __ts__ timestamp column)
    8   u64     encoder id  (dictionary-delta continuity, see below)
    16  u32     dict_base   (client string ids the server already knows)
    20  u32     dict_delta_n (new strings in this frame)
    24  u32     n_rows
    28  u16     n_cols
    30  u16     reserved (0)
    32  u32     dir_nbytes  (column directory length)
    36  u32     dict_nbytes (dictionary delta length)
    40  u64     payload_nbytes
    48  column directory, then dictionary delta, then payload

Column directory entry (variable size): ``u16 name_len | name utf-8 |
u8 type_code | u8 reserved | u64 offset | u64 nbytes`` — offsets are
payload-relative and 8-byte aligned, so every buffer is one aligned
``np.frombuffer`` view. Null masks travel as ``<name>?`` bool columns;
per-row timestamps as a ``__ts__`` int64 column.

**Dictionary delta.** Strings never travel per event: the client keeps
its own append-only string⇄id dictionary (ids are frame-column int32
values, -1 = null) and each frame carries only the NEW strings since
the last frame (``dict_base`` → ``dict_base + dict_delta_n``). The
server keeps a per-encoder LUT translating client ids to its own
app-global ``StringDictionary`` ids, extended from each delta with ONE
vectorized gather per string column afterwards. A frame whose
``dict_base`` does not match the server's LUT (server restart, LRU
eviction) is rejected with a clean ``SiddhiAppValidationException`` —
the client calls :meth:`WireEncoder.reset` and resends from a full
dictionary (``dict_base == 0`` always re-bootstraps the LUT).

Every malformed input — truncated buffer, bad magic/version, offsets
out of range, unknown type codes, id out of dictionary range — raises
``SiddhiAppValidationException``; never a crash, never a silent
partial batch.
"""

from __future__ import annotations

import struct
import threading
import uuid
from collections import OrderedDict
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np

from siddhi_tpu_torch.compiler.errors import SiddhiAppValidationException
from siddhi_tpu_torch.query_api.definitions import AttrType

MAGIC = b"SWF1"
VERSION = 1
FLAG_TS = 1
# bit 15: the frame is a CONTROL frame (hello / heartbeat / seq-ack /
# checkpoint-cut — the cluster fabric's link-management vocabulary).
# Control frames reuse the same 48-byte header so every endpoint needs
# exactly one frame parser; decode_frame rejects them cleanly and
# decode_control rejects data frames symmetrically.
FLAG_CONTROL = 0x8000

# Capability bits, carried on the hello path (dict_base slot of the
# hello header). Version gates the FRAME LAYOUT; capabilities gate
# optional behaviors within a version, so a decoder can refuse a
# feature without refusing the whole link.
CAP_TS = 1 << 0             # per-row __ts__ timestamp columns
CAP_DICT_DELTA = 1 << 1     # dictionary-delta string protocol
CAP_CONTROL = 1 << 2        # control frames (cluster fabric links)
CAPABILITIES = CAP_TS | CAP_DICT_DELTA | CAP_CONTROL

# control-frame kinds (u16 reserved slot, FLAG_CONTROL set)
CTRL_HELLO = 1              # version + capability negotiation
CTRL_HEARTBEAT = 2          # liveness tick (b = sender's monotone tick)
CTRL_SEQ_ACK = 3            # b = highest contiguous ingest seq applied
CTRL_CHECKPOINT_CUT = 4     # b = barrier id; body = JSON revision info

_HEADER = struct.Struct("<4sHHQIIIHHIIQ")     # 48 bytes
_DIR_FIXED = struct.Struct("<BBQQ")           # after the name
TS_COL = "__ts__"

# type codes <-> numpy dtypes; STRING_IDS columns carry client
# dictionary ids (int32, -1 = null)
T_INT64, T_FLOAT64, T_FLOAT32, T_INT32, T_BOOL, T_INT8, T_STRING_IDS = \
    range(7)
_DTYPES = {
    T_INT64: np.dtype("<i8"),
    T_FLOAT64: np.dtype("<f8"),
    T_FLOAT32: np.dtype("<f4"),
    T_INT32: np.dtype("<i4"),
    T_BOOL: np.dtype("?"),
    T_INT8: np.dtype("<i1"),
    T_STRING_IDS: np.dtype("<i4"),
}
_CODE_OF_DTYPE = {
    np.dtype("<i8"): T_INT64, np.dtype("<f8"): T_FLOAT64,
    np.dtype("<f4"): T_FLOAT32, np.dtype("<i4"): T_INT32,
    np.dtype("?"): T_BOOL, np.dtype("<i1"): T_INT8,
}


def _bad(msg: str) -> SiddhiAppValidationException:
    return SiddhiAppValidationException(f"wire frame: {msg}")


def _align8(n: int) -> int:
    return (n + 7) & ~7


# ----------------------------------------------------------- control frames


class ControlFrame(NamedTuple):
    """A decoded control frame. ``a`` and ``b`` are the two u64 slots
    (sender id and a kind-specific scalar: heartbeat tick, acked seq,
    checkpoint barrier id); ``body`` is an optional opaque blob (JSON by
    convention) for structured payloads like checkpoint revisions."""

    kind: int
    version: int
    capabilities: int
    a: int
    b: int
    body: bytes


def encode_control(kind: int, *, a: int = 0, b: int = 0,
                   body: bytes = b"", version: int = VERSION,
                   capabilities: int = CAPABILITIES) -> bytes:
    """Encode one control frame on the shared 48-byte header: the
    ``encoder_id`` slot carries ``a``, ``dict_base`` the capability
    bits, ``reserved`` the control kind, ``payload_nbytes`` carries
    ``b``, and ``dir_nbytes`` the body length."""
    if not 0 <= kind <= 0xFFFF:
        raise _bad(f"control kind {kind} out of range")
    return _HEADER.pack(MAGIC, version, FLAG_CONTROL, a,
                        capabilities & 0xFFFFFFFF, 0, 0, 0, kind,
                        len(body), 0, b) + bytes(body)


def is_control(buf: bytes) -> bool:
    """True iff ``buf`` starts with a control-frame header (cheap peek
    so a socket reader can route without a full decode)."""
    if len(buf) < 8 or bytes(buf[:4]) != MAGIC:
        return False
    (flags,) = struct.unpack_from("<H", buf, 6)
    return bool(flags & FLAG_CONTROL)


def decode_control(buf: bytes) -> ControlFrame:
    """Decode one control frame. Deliberately does NOT reject a version
    mismatch: the HELLO frame must be readable across versions so the
    negotiation error can name both sides (see :func:`negotiate_hello`)
    instead of dying as a frame-parse error."""
    if len(buf) < _HEADER.size:
        raise _bad(f"truncated control frame: {len(buf)} bytes < "
                   f"{_HEADER.size}-byte header")
    (magic, version, flags, a, caps, _delta_n, _n_rows, _n_cols, kind,
     body_n, _dict_n, b) = _HEADER.unpack_from(buf, 0)
    if magic != MAGIC:
        raise _bad(f"bad magic {magic!r} (expected {MAGIC!r})")
    if not flags & FLAG_CONTROL:
        raise _bad("data frame on the control path — route data frames "
                   "through decode_frame")
    if len(buf) < _HEADER.size + body_n:
        raise _bad(f"truncated control frame body: header promises "
                   f"{body_n} bytes, got {len(buf) - _HEADER.size}")
    body = bytes(buf[_HEADER.size:_HEADER.size + body_n])
    return ControlFrame(kind, version, caps, a, b, body)


def encode_hello(sender_id: int = 0, *, version: int = VERSION,
                 capabilities: int = CAPABILITIES) -> bytes:
    """The link-open frame every wire conversation starts with:
    protocol version + capability bits, so incompatible endpoints fail
    at negotiation time with an error naming both versions instead of
    mid-stream with a frame-parse error."""
    return encode_control(CTRL_HELLO, a=sender_id, version=version,
                          capabilities=capabilities)


def negotiate_hello(buf: bytes, required: int = 0) -> ControlFrame:
    """Decode a peer's hello and negotiate: a version mismatch (or a
    required capability the peer lacks) raises a clean
    ``SiddhiAppValidationException`` naming BOTH sides. Returns the
    hello with capabilities narrowed to the mutually-supported set."""
    hello = decode_control(buf)
    if hello.kind != CTRL_HELLO:
        raise _bad(f"expected a hello control frame, got control kind "
                   f"{hello.kind}")
    if hello.version != VERSION:
        raise _bad(
            f"protocol version mismatch: peer speaks wire version "
            f"{hello.version}, this endpoint speaks version {VERSION} "
            f"— upgrade the older side; the frame layout is not "
            f"cross-version compatible")
    agreed = hello.capabilities & CAPABILITIES
    missing = required & ~agreed
    if missing:
        raise _bad(
            f"capability mismatch: this endpoint requires bits "
            f"{required:#x} but the peer offers "
            f"{hello.capabilities:#x} (missing {missing:#x})")
    return hello._replace(capabilities=agreed)


# ------------------------------------------------------------------ encoder


class WireEncoder:
    """Client-side frame encoder (one per producing device/connection).

    Keeps the client half of the dictionary-delta protocol: an
    append-only string->int32 id map whose NEW entries ride each frame.
    ``encode`` takes attribute-name -> numpy array columns (strings as
    object/str arrays or pre-encoded int ids), optional ``<name>?``
    bool null masks, and optional per-row timestamps."""

    def __init__(self, encoder_id: Optional[int] = None):
        self.encoder_id = (int(encoder_id) if encoder_id is not None
                           else uuid.uuid4().int & ((1 << 64) - 1))
        self._to_id: Dict[str, int] = {}
        self._strings = []
        self._sent = 0        # ids the server has seen (delta watermark)

    def reset(self) -> None:
        """Resend the full dictionary in the next frame (server restart
        / LUT eviction recovery): the next frame's ``dict_base`` is 0,
        which re-bootstraps the server-side LUT."""
        self._sent = 0

    def _encode_strings(self, col: np.ndarray) -> np.ndarray:
        out = np.empty(len(col), np.int32)
        to_id = self._to_id
        for i, v in enumerate(col):
            if v is None:
                out[i] = -1
                continue
            if type(v) is not str:
                v = str(v)
            j = to_id.get(v)
            if j is None:
                j = len(self._strings)
                to_id[v] = j
                self._strings.append(v)
            out[i] = j
        return out

    def encode(self, data: Dict[str, np.ndarray],
               timestamps=None, string_ids=frozenset()) -> bytes:
        """``string_ids`` names columns that are ALREADY this encoder's
        client ids (int32, -1 = null) — the cluster router's relay path,
        which translates router ids via a LUT instead of re-interning
        strings per row (cluster/protocol.RelayEncoder). The caller
        guarantees the ids reference this encoder's dictionary."""
        cols: Dict[str, Tuple[int, np.ndarray]] = {}
        n_rows = None
        for name, values in data.items():
            arr = np.asarray(values)
            if n_rows is None:
                n_rows = len(arr)
            elif len(arr) != n_rows:
                raise _bad(f"column '{name}' has {len(arr)} rows, "
                           f"expected {n_rows}")
            if name.endswith("?"):
                cols[name] = (T_BOOL, np.ascontiguousarray(arr, np.bool_))
            elif name in string_ids:
                cols[name] = (T_STRING_IDS,
                              np.ascontiguousarray(arr, "<i4"))
            elif arr.dtype == object or arr.dtype.kind in ("U", "S"):
                cols[name] = (T_STRING_IDS,
                              self._encode_strings(arr.astype(object)))
            else:
                dt = arr.dtype.newbyteorder("<")
                code = _CODE_OF_DTYPE.get(dt)
                if code is None:
                    if arr.dtype.kind in "iu":
                        code, dt = T_INT64, np.dtype("<i8")
                    elif arr.dtype.kind == "f":
                        code, dt = T_FLOAT64, np.dtype("<f8")
                    elif arr.dtype.kind == "b":
                        code, dt = T_BOOL, np.dtype("?")
                    else:
                        raise _bad(f"column '{name}': unsupported dtype "
                                   f"{arr.dtype}")
                cols[name] = (code, np.ascontiguousarray(arr, dt))
        if n_rows is None:
            n_rows = 0
        flags = 0
        if timestamps is not None:
            flags |= FLAG_TS
            cols[TS_COL] = (T_INT64, np.ascontiguousarray(
                np.asarray(timestamps, np.int64)[:n_rows], "<i8"))

        delta = self._strings[self._sent:]
        dict_base = self._sent
        dict_parts = []
        for s in delta:
            b = s.encode("utf-8")
            dict_parts.append(struct.pack("<I", len(b)))
            dict_parts.append(b)
        dict_blob = b"".join(dict_parts)

        dir_parts = []
        payload_parts = []
        offset = 0
        for name, (code, arr) in cols.items():
            nb = arr.nbytes
            name_b = name.encode("utf-8")
            dir_parts.append(struct.pack("<H", len(name_b)))
            dir_parts.append(name_b)
            dir_parts.append(_DIR_FIXED.pack(code, 0, offset, nb))
            payload_parts.append(arr.tobytes())
            pad = _align8(nb) - nb
            if pad:
                payload_parts.append(b"\0" * pad)
            offset += _align8(nb)
        dir_blob = b"".join(dir_parts)
        payload = b"".join(payload_parts)
        header = _HEADER.pack(
            MAGIC, VERSION, flags, self.encoder_id,
            dict_base, len(delta), n_rows, len(cols), 0,
            len(dir_blob), len(dict_blob), len(payload))
        self._sent = len(self._strings)
        return header + dir_blob + dict_blob + payload


# ------------------------------------------------------------------ decoder


class _EncoderState:
    __slots__ = ("lut", "lock")

    def __init__(self):
        self.lut = np.empty(0, np.int64)   # client id -> server id
        # serializes the gap-check + delta extension: a client retrying
        # a frame on a second connection must not append its delta twice
        # (ThreadingHTTPServer + AdmissionPool process frames concurrently)
        self.lock = threading.Lock()


class DecoderRegistry:
    """Server-side dictionary-delta state, one LUT per (scope, encoder).

    ``scope`` partitions the id space: LUT entries are server ids from a
    SPECIFIC app's StringDictionary, so a shared registry (the REST
    service) must key by app — one encoder posting to streams of two
    different apps would otherwise gather app A's ids into app B's
    columns silently. Bounded LRU (an evicted encoder's next frame fails
    the continuity check with a clean error telling the client to
    ``reset()``)."""

    def __init__(self, max_encoders: int = 256):
        self.max_encoders = int(max_encoders)
        self._states: "OrderedDict[tuple, _EncoderState]" = OrderedDict()
        # keys the LRU evicted, so the evicted client's NEXT frame gets
        # the documented reset() error naming the real cause instead of
        # either a confusing generic gap error or — for an encoder whose
        # LUT happened to be empty — a silent dictionary corruption.
        # Bounded itself (a key leaves when its client resets).
        self._evicted: "OrderedDict[tuple, None]" = OrderedDict()
        self.evictions = 0
        self._lock = threading.Lock()

    def _state_for(self, encoder_id: int, dict_base: int,
                   scope=None) -> _EncoderState:
        key = (scope, encoder_id)
        with self._lock:
            st = self._states.get(key)
            if st is None and dict_base != 0 and key in self._evicted:
                raise _bad(
                    f"encoder {encoder_id:#x} dictionary state was "
                    f"evicted by the bounded decoder LRU (max_encoders="
                    f"{self.max_encoders}) — reset the encoder "
                    f"(WireEncoder.reset) and resend from a full "
                    f"dictionary")
            if st is None or dict_base == 0:
                # dict_base 0 re-bootstraps: a reset() client resends
                # the full dictionary and the stale LUT must not shadow it
                st = _EncoderState()
                self._states[key] = st
                self._evicted.pop(key, None)
            self._states.move_to_end(key)
            while len(self._states) > self.max_encoders:
                old, _ = self._states.popitem(last=False)
                self._evicted[old] = None
                while len(self._evicted) > 8 * self.max_encoders:
                    self._evicted.popitem(last=False)
                self.evictions += 1
            return st


def _view(payload: memoryview, offset: int, nbytes: int, code: int,
          name: str) -> np.ndarray:
    dt = _DTYPES.get(code)
    if dt is None:
        raise _bad(f"column '{name}': unknown type code {code}")
    if offset % 8 != 0:
        raise _bad(f"column '{name}': misaligned offset {offset}")
    if offset + nbytes > len(payload):
        raise _bad(f"column '{name}': buffer [{offset}:{offset + nbytes}) "
                   f"escapes the {len(payload)}-byte payload")
    if nbytes % dt.itemsize != 0:
        raise _bad(f"column '{name}': {nbytes} bytes is not a whole "
                   f"number of {dt.itemsize}-byte elements")
    return np.frombuffer(payload, dt, count=nbytes // dt.itemsize,
                         offset=offset)


def decode_frame(buf: bytes, definition, dictionary,
                 registry: DecoderRegistry, scope=None):
    """Decode one frame against a stream definition: returns
    ``(data, timestamps)`` ready for ``InputHandler.send_columns`` —
    string columns already translated to SERVER dictionary ids (int64,
    negative = null) by one vectorized LUT gather, every other column a
    zero-copy ``np.frombuffer`` view of ``buf``. ``scope`` must identify
    the dictionary's owner (the app name) when ``registry`` is shared
    across apps."""
    if len(buf) < _HEADER.size:
        raise _bad(f"truncated: {len(buf)} bytes < {_HEADER.size}-byte "
                   f"header")
    (magic, version, flags, encoder_id, dict_base, delta_n, n_rows,
     n_cols, _resv, dir_nbytes, dict_nbytes, payload_nbytes) = \
        _HEADER.unpack_from(buf, 0)
    if magic != MAGIC:
        raise _bad(f"bad magic {magic!r} (expected {MAGIC!r})")
    if flags & FLAG_CONTROL:
        raise _bad("control frame on the data path — route control "
                   "frames through decode_control")
    if version != VERSION:
        raise _bad(
            f"protocol version mismatch: frame encoded for wire "
            f"version {version}, this decoder speaks version {VERSION} "
            f"— negotiate on the hello path (encode_hello/"
            f"negotiate_hello) before streaming")
    need = _HEADER.size + dir_nbytes + dict_nbytes + payload_nbytes
    if len(buf) < need:
        raise _bad(f"truncated: header promises {need} bytes, got "
                   f"{len(buf)}")
    mv = memoryview(buf)
    dir_mv = mv[_HEADER.size:_HEADER.size + dir_nbytes]
    dict_mv = mv[_HEADER.size + dir_nbytes:
                 _HEADER.size + dir_nbytes + dict_nbytes]
    payload = mv[_HEADER.size + dir_nbytes + dict_nbytes:need]

    # ---- column directory
    columns: Dict[str, Tuple[int, int, int]] = {}
    pos = 0
    for _ in range(n_cols):
        if pos + 2 > len(dir_mv):
            raise _bad("truncated column directory")
        (name_len,) = struct.unpack_from("<H", dir_mv, pos)
        pos += 2
        if pos + name_len + _DIR_FIXED.size > len(dir_mv):
            raise _bad("truncated column directory entry")
        try:
            name = bytes(dir_mv[pos:pos + name_len]).decode("utf-8")
        except UnicodeDecodeError:
            raise _bad("undecodable column name") from None
        pos += name_len
        code, _r, offset, nbytes = _DIR_FIXED.unpack_from(dir_mv, pos)
        pos += _DIR_FIXED.size
        columns[name] = (code, offset, nbytes)

    # ---- dictionary delta -> per-encoder LUT extension. Deliberately
    # BEFORE column validation: the client advanced its delta watermark
    # at encode time, so applying the delta even when the frame is then
    # rejected keeps both sides in sync — the corrected retry (empty
    # delta, advanced dict_base) passes the continuity check. Validating
    # first would leave the server BEHIND the client's watermark and
    # force a full reset after every rejected frame.
    st = registry._state_for(encoder_id, dict_base, scope=scope)
    with st.lock:
        if len(st.lut) != dict_base:
            raise _bad(
                f"dictionary delta gap: frame assumes {dict_base} known "
                f"client ids but this server knows {len(st.lut)} for "
                f"encoder {encoder_id:#x} — reset the encoder "
                f"(WireEncoder.reset) and resend from a full dictionary")
        if delta_n:
            new_ids = np.empty(delta_n, np.int64)
            pos = 0
            for i in range(delta_n):
                if pos + 4 > len(dict_mv):
                    raise _bad("truncated dictionary delta")
                (slen,) = struct.unpack_from("<I", dict_mv, pos)
                pos += 4
                if pos + slen > len(dict_mv):
                    raise _bad("truncated dictionary delta string")
                try:
                    s = bytes(dict_mv[pos:pos + slen]).decode("utf-8")
                except UnicodeDecodeError:
                    raise _bad(
                        "undecodable dictionary delta string") from None
                pos += slen
                new_ids[i] = dictionary.encode(s)
            st.lut = np.concatenate([st.lut, new_ids])
        lut = st.lut        # immutable snapshot for the gathers below

    # ---- columns -> send_columns dict
    data: Dict[str, np.ndarray] = {}
    timestamps = None
    for attr in definition.attributes:
        rec = columns.get(attr.name)
        if rec is None:
            raise _bad(f"column '{attr.name}' missing from frame")
        code, offset, nbytes = rec
        arr = _view(payload, offset, nbytes, code, attr.name)
        if len(arr) != n_rows:
            raise _bad(f"column '{attr.name}': {len(arr)} rows, frame "
                       f"says {n_rows}")
        if attr.type == AttrType.STRING:
            if code != T_STRING_IDS:
                raise _bad(f"column '{attr.name}' is a string attribute "
                           f"but carries type code {code}")
            ids = arr.astype(np.int64)      # copy: view is read-only
            valid = ids >= 0
            if valid.any():
                hi = int(ids[valid].max())
                if hi >= len(lut):
                    raise _bad(
                        f"column '{attr.name}': client id {hi} outside "
                        f"the {len(lut)}-entry dictionary")
                # ONE vectorized gather translates the whole column from
                # client ids to server ids — zero per-event Python
                ids = np.where(valid, lut[np.where(valid, ids, 0)], -1)
            data[attr.name] = ids
        else:
            if code == T_STRING_IDS:
                raise _bad(f"column '{attr.name}' carries string ids but "
                           f"is not a string attribute")
            data[attr.name] = arr
        mrec = columns.get(attr.name + "?")
        if mrec is not None:
            mcode, moff, mnb = mrec
            if mcode != T_BOOL:
                raise _bad(f"null mask '{attr.name}?' must be bool")
            mask = _view(payload, moff, mnb, mcode, attr.name + "?")
            if len(mask) != n_rows:
                raise _bad(f"null mask '{attr.name}?': {len(mask)} rows, "
                           f"frame says {n_rows}")
            data[attr.name + "?"] = mask
    if flags & FLAG_TS:
        rec = columns.get(TS_COL)
        if rec is None:
            raise _bad("flags promise a __ts__ column but none is present")
        code, offset, nbytes = rec
        if code != T_INT64:
            raise _bad("__ts__ must be int64")
        timestamps = _view(payload, offset, nbytes, code, TS_COL)
        if len(timestamps) != n_rows:
            raise _bad(f"__ts__: {len(timestamps)} rows, frame says "
                       f"{n_rows}")
    return data, timestamps
