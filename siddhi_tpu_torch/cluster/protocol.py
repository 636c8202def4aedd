"""Cluster socket protocol: framed messages over plain TCP.

Counterpart of ``siddhi_tpu/cluster/protocol.py``, byte-compatible with
it. Every link (router<->worker, ingest client<->router) speaks the same
framing, ``u32 length | u8 type | body``, and OPENS with the wire
format's hello control frame (``wire.encode_hello``), so a version or
capability skew fails at link-open with an error naming both sides,
never as a mid-stream frame-parse error.

Bodies are one of three shapes:

- a wire CONTROL frame (``wire.encode_control``) for the link-management
  vocabulary: hello, heartbeat, seq-ack, checkpoint-cut;
- a DATA envelope, ``u64 seq | u32 run | u16 app_len | app | u16
  stream_len | stream`` followed by one columnar wire frame
  (``wire.WireEncoder``), the zero-copy payload path;
- UTF-8 JSON for low-rate structured control (deploy specs, query
  scatter/gather, worker emissions).

The ``RelayEncoder`` is the router's re-framing half: it re-encodes a
decoded batch (string columns already translated to ROUTER dictionary
ids) for one worker link with a vectorized router-id -> client-id LUT, so
no per-row Python runs on the relay path.
"""

from __future__ import annotations

import json
import socket
import struct
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from siddhi_tpu_torch.core.stream.input.wire import WireEncoder

# ---------------------------------------------------------- message types

MSG_HELLO = 1            # body: wire hello control frame (JSON in body)
MSG_DEPLOY = 2           # JSON: app text + routing spec (+ restore flag)
MSG_DEPLOY_OK = 3        # JSON: {app} (or {app, error})
MSG_DATA = 4             # data envelope + wire frame (router -> worker)
MSG_EMIT = 5             # JSON: one run's output rows (worker -> router)
MSG_ACK = 6              # wire CTRL_SEQ_ACK frame: a=run, b=seq
MSG_CHECKPOINT = 7       # wire CTRL_CHECKPOINT_CUT frame: b=barrier id
MSG_CHECKPOINT_OK = 8    # CTRL_CHECKPOINT_CUT frame, body JSON revisions
MSG_QUERY = 9            # JSON: {qid, app, query}
MSG_QUERY_RESULT = 10    # JSON: {qid, rows} | {qid, error}
MSG_HEARTBEAT = 11       # wire CTRL_HEARTBEAT frame
MSG_ERROR = 12           # JSON: {context, error} (worker -> router)
MSG_SHUTDOWN = 13        # empty body: orderly worker exit
MSG_INGEST = 14          # ingest envelope + wire frame (client -> router)
MSG_INGEST_ACK = 15      # CTRL_SEQ_ACK frame: b=assigned global seq
# the port's addition: JSON {sid[, reset]} -> {sid, device, device_name,
# launches} (the worker's device and its kernel wrappers' launch counts)
MSG_STATS = 16

_LEN = struct.Struct("<IB")                # length covers type byte + body
_DATA_FIXED = struct.Struct("<QI")         # seq, run
MAX_MESSAGE = 1 << 30                      # 1 GiB sanity bound


class ProtocolError(RuntimeError):
    """A malformed or unexpected message on a cluster link."""


# ------------------------------------------------------------- low level


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    """Read exactly n bytes; None on clean EOF at a message boundary."""
    parts = []
    got = 0
    while got < n:
        try:
            chunk = sock.recv(min(n - got, 1 << 20))
        except (ConnectionResetError, BrokenPipeError, OSError):
            chunk = b""
        if not chunk:
            return None if not parts else parts  # mid-message EOF below
        parts.append(chunk)
        got += len(chunk)
    return b"".join(parts)


class MessageSocket:
    """One framed duplex link. Sends are serialized by an internal lock
    (multiple router threads share a worker link); receives belong to
    ONE reader thread by construction."""

    def __init__(self, sock: socket.socket):
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sock = sock
        self._send_lock = threading.Lock()
        self.peer = None
        try:
            self.peer = sock.getpeername()
        except OSError:
            pass

    def send(self, mtype: int, body: bytes = b"") -> None:
        msg = _LEN.pack(1 + len(body), mtype) + body
        with self._send_lock:
            self._sock.sendall(msg)

    def recv(self) -> Optional[Tuple[int, bytes]]:
        """Next (type, body), or None on EOF / reset."""
        head = _recv_exact(self._sock, _LEN.size)
        if head is None or isinstance(head, list):
            return None
        length, mtype = _LEN.unpack(head)
        if not 1 <= length <= MAX_MESSAGE:
            raise ProtocolError(f"message length {length} out of bounds")
        if length == 1:
            return mtype, b""
        body = _recv_exact(self._sock, length - 1)
        if body is None or isinstance(body, list):
            return None
        return mtype, body

    def close(self) -> None:
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


# ------------------------------------------------------------- envelopes


def jdump(obj) -> bytes:
    return json.dumps(obj).encode("utf-8")


def jload(body: bytes):
    try:
        return json.loads(body.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ProtocolError(f"bad JSON body: {e}") from None


def _pack_name(name: str) -> bytes:
    b = name.encode("utf-8")
    if len(b) > 0xFFFF:
        raise ProtocolError(f"name too long: {len(b)} bytes")
    return struct.pack("<H", len(b)) + b


def _unpack_name(body: bytes, pos: int) -> Tuple[str, int]:
    if pos + 2 > len(body):
        raise ProtocolError("truncated envelope name")
    (n,) = struct.unpack_from("<H", body, pos)
    pos += 2
    if pos + n > len(body):
        raise ProtocolError("truncated envelope name body")
    return body[pos:pos + n].decode("utf-8"), pos + n


def pack_data(seq: int, run: int, app: str, stream: str,
              frame: bytes) -> bytes:
    """DATA/INGEST envelope. For MSG_INGEST the (seq, run) slots are 0 —
    the ROUTER assigns the global sequence, that is its whole job."""
    return (_DATA_FIXED.pack(seq, run) + _pack_name(app)
            + _pack_name(stream) + frame)


def unpack_data(body: bytes) -> Tuple[int, int, str, str, bytes]:
    if len(body) < _DATA_FIXED.size:
        raise ProtocolError("truncated data envelope")
    seq, run = _DATA_FIXED.unpack_from(body, 0)
    app, pos = _unpack_name(body, _DATA_FIXED.size)
    stream, pos = _unpack_name(body, pos)
    return seq, run, app, stream, body[pos:]


def py_value(v):
    """numpy scalar -> plain Python for the JSON emission path (exact:
    float32 widens losslessly, json round-trips float64 via repr)."""
    if isinstance(v, np.generic):
        return v.item()
    return v


# --------------------------------------------------------- relay encoder


class RelayEncoder(WireEncoder):
    """Router-side re-framing encoder for ONE (worker, app, stream) link.

    The router decodes an ingest frame against its own per-app
    ``StringDictionary`` (string columns become router ids), splits rows
    by key owner, and re-encodes each slice for its worker. String
    columns are already id arrays at that point, so this encoder keeps a
    dense router-id -> client-id LUT per instance: translating a column
    is one vectorized gather, and NEW router ids register their string
    in the inherited dictionary-delta state so the worker's decoder
    learns them from the frame's delta — per-row Python only ever runs
    once per NEW string, same as the ingest decode side."""

    def __init__(self, dictionary):
        super().__init__()
        self._dictionary = dictionary
        self._router_lut = np.full(0, -1, np.int64)

    def encode_ids(self, ids: np.ndarray) -> np.ndarray:
        """Translate a router-id column (int64, negative = null) to this
        link's client ids (int32)."""
        ids = np.asarray(ids, np.int64)
        if len(ids) == 0:
            return ids.astype(np.int32)
        hi = int(ids.max())
        if hi >= len(self._router_lut):
            grown = np.full(hi + 1, -1, np.int64)
            grown[:len(self._router_lut)] = self._router_lut
            self._router_lut = grown
        valid = ids >= 0
        missing = np.unique(ids[valid & (self._router_lut[
            np.where(valid, ids, 0)] < 0)]) if valid.any() else ()
        for rid in missing:
            self._router_lut[int(rid)] = self._intern(
                self._dictionary.decode(int(rid)))
        return np.where(valid, self._router_lut[np.where(valid, ids, 0)],
                        -1).astype(np.int32)

    def _intern(self, s: str) -> int:
        j = self._to_id.get(s)
        if j is None:
            j = len(self._strings)
            self._to_id[s] = j
            self._strings.append(s)
        return j


def encode_for_link(encoder: RelayEncoder, data: Dict[str, np.ndarray],
                    string_attrs, timestamps=None) -> bytes:
    """Re-encode a router-decoded column dict on a worker link: string
    columns (router ids) go through the LUT and travel as pre-encoded
    client ids; everything else passes through untouched."""
    out = {}
    for name, col in data.items():
        if name in string_attrs:
            out[name] = encoder.encode_ids(col)
        else:
            out[name] = col
    return encoder.encode(out, timestamps=timestamps,
                          string_ids=frozenset(string_attrs))
