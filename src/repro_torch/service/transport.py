"""Wire transport for the RandService fleet: two frame formats, one TCP.

Two wire versions coexist on every connection, disambiguated by the
first byte of each frame:

  * **v1 (JSON)** - a 4-byte big-endian length ``N`` followed by ``N``
    bytes of UTF-8 JSON.  Arrays travel as ``{"dtype", "shape",
    "data": base64}`` - dtype by name, bytes verbatim.  Because the
    length prefix is capped at 16 MiB, a v1 frame's first byte is
    always ``0x00`` or ``0x01``.
  * **v2 (binary)** - ``0xB7`` magic + version byte + two u32
    little-endian lengths (header, payload) + a compact JSON header +
    the raw array payload.  Array values leave the message dict and
    travel as raw little-endian bytes after the header, described by a
    ``"_bin"`` table of ``{dtype, shape, off, nbytes}`` - no base64
    inflation, no ``json.dumps`` over megabyte payloads - and decode
    ZERO-COPY: ``np.frombuffer`` views over the received buffer (the
    views are read-only; copy before mutating).

An array is a numpy array or, for bfloat16 (which numpy has no type
for), a CPU ``torch.bfloat16`` tensor.  A bfloat16 array travels as its
raw little-endian 16-bit words under the dtype name ``"bfloat16"`` and
decodes to a ``torch.bfloat16`` tensor over a copy of those words
(``_decode_raw``); every other dtype stays numpy.  The frame bytes equal
the JAX reference's (``repro.service.transport``, whose bfloat16 arrays
are ``ml_dtypes`` arrays) for the same message in both versions, so
either package reads the other's frames.

Either way ``response_digest`` over wire-decoded responses equals the
digest over the server's own arrays.  Versions are negotiated per
connection with a ``hello`` op (the server replies to every frame in
the version the frame arrived in, so v1-only peers keep working
unannounced).  Robustness rules of the framing layer:

  * a frame whose declared length exceeds ``max_frame`` is refused with
    an error frame and the connection is closed (the stream cannot be
    resynchronized after an untrusted length) - v2 header/payload
    lengths included,
  * a peer that disconnects mid-frame raises :class:`TornFrame` on the
    reader's side; the server closes that connection and keeps
    accepting - one client's torn write can never wedge the accept
    loop,
  * the reply to a request whose rid is already journaled is computed
    by ``audit.replay_entry`` (flagged ``"replayed": true``), never by
    serving a second counter window - retries are idempotent by
    construction.

:class:`ShardHost` is one fleet process: a TCP accept loop over a set
of *logical shards*, each an independent ``RandServer`` + journal.
Requests are served PIPELINED: the connection reader admits each
request to its shard's :class:`_Gate` (an arrival-order microbatch
gate) and keeps reading; replies are rid-tagged and sent as their
futures resolve, possibly out of order.  A gate seals a batch only by
COUNT (``max_batch``) or an explicit client ``flush`` op - never by
wall-clock and never on connection EOF - which makes batch composition
a pure function of per-shard arrival order and is what keeps failover
digest-identical with coalescing enabled (see ``_Gate``).

A host usually starts owning exactly one shard; after a peer dies it
*adopts* the dead shard - takes the journal's exclusive flock (the
fencing step: the OS grants it only once the owner is truly gone),
fences the journaled windows off a fresh ledger, and resumes that
shard's tenant regions bit-identically.  The scripted fault layer
(``runtime.fault.FaultInjector``) hooks the request path so kill /
hang / drop / slow adversaries run deterministically in CI.
"""
from __future__ import annotations

import base64
import json
import os
import socket
import struct
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.runtime.fault import FaultInjector, rid_index
from repro_torch.service import audit
from repro_torch.service.frontend import RandRequest
from repro_torch.service.server import RandServer, ServerConfig

_HEADER = struct.Struct("!I")

#: v2 binary framing: magic + version byte, then LE (header, payload)
#: lengths.  The magic can never open a v1 frame - a v1 length prefix
#: under the 16 MiB cap starts 0x00/0x01, never 0xB7.
WIRE_MAGIC = 0xB7
WIRE_V1 = 1
WIRE_V2 = 2
SUPPORTED_VERSIONS = (WIRE_V1, WIRE_V2)
_V2_HEAD = struct.Struct("<II")

#: default cap on one frame's JSON payload (requests and responses are
#: far smaller; the cap exists so a hostile length prefix cannot make
#: the server allocate unbounded memory)
MAX_FRAME = 16 << 20


class TransportError(RuntimeError):
    """Base of the wire-level failure modes."""


class FrameTooLarge(TransportError):
    """Declared frame length exceeds the negotiated cap."""


class TornFrame(TransportError):
    """Peer vanished mid-frame (partial header or body)."""


class WireError(RuntimeError):
    """A structured error frame from the server (``kind`` + message)."""

    def __init__(self, kind: str, message: str):
        super().__init__(message)
        self.kind = kind


# ---------------------------------------------------------------------------
# Framing
# ---------------------------------------------------------------------------

def send_frame(sock: socket.socket, obj: Dict[str, Any], *,
               max_frame: int = MAX_FRAME) -> None:
    """Serialize ``obj`` and write one length-prefixed frame."""
    data = json.dumps(obj, sort_keys=True).encode("utf-8")
    if len(data) > max_frame:
        raise FrameTooLarge(
            f"frame of {len(data)} bytes exceeds cap {max_frame}")
    sock.sendall(_HEADER.pack(len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    """``n`` bytes or None on EOF at offset 0; TornFrame on EOF mid-read."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            if not buf:
                return None
            raise TornFrame(
                f"peer closed after {len(buf)} of {n} bytes")
        buf.extend(chunk)
    return bytes(buf)


def recv_frame(sock: socket.socket, *,
               max_frame: int = MAX_FRAME) -> Optional[Dict[str, Any]]:
    """Read one frame; ``None`` on clean EOF at a frame boundary.

    Raises :class:`TornFrame` on a mid-frame disconnect and
    :class:`FrameTooLarge` when the declared length exceeds the cap
    (after which the stream is unrecoverable - close the socket).
    """
    head = _recv_exact(sock, _HEADER.size)
    if head is None:
        return None
    (length,) = _HEADER.unpack(head)
    if length > max_frame:
        raise FrameTooLarge(
            f"declared frame length {length} exceeds cap {max_frame}")
    body = _recv_exact(sock, length)
    if body is None:        # EOF right after the header: torn, not clean
        raise TornFrame(f"peer closed before {length}-byte body")
    return json.loads(body.decode("utf-8"))


def send_wire(sock: socket.socket, obj: Dict[str, Any], *,
              version: int = WIRE_V1,
              max_frame: int = MAX_FRAME) -> int:
    """Send one frame in ``version``; returns bytes put on the wire.

    ``obj`` may carry arrays (``np.ndarray`` or CPU ``torch.Tensor``)
    at the top level: v1 encodes them via :func:`encode_array` (base64
    JSON); v2 ships them as raw little-endian bytes after the compact
    header, described by the ``"_bin"`` table.
    """
    if version == WIRE_V1:
        enc = {k: (encode_array(v) if _is_array(v) else v)
               for k, v in obj.items()}
        data = json.dumps(enc, sort_keys=True).encode("utf-8")
        if len(data) > max_frame:
            raise FrameTooLarge(
                f"frame of {len(data)} bytes exceeds cap {max_frame}")
        sock.sendall(_HEADER.pack(len(data)) + data)
        return _HEADER.size + len(data)
    if version != WIRE_V2:
        raise TransportError(f"unknown wire version {version}")
    head: Dict[str, Any] = {}
    bins: Dict[str, Dict[str, Any]] = {}
    chunks: List[bytes] = []
    off = 0
    for k, v in obj.items():
        if _is_array(v):
            dtype, shape, raw = _raw_parts(v)
            bins[k] = {"dtype": dtype, "shape": shape,
                       "off": off, "nbytes": len(raw)}
            chunks.append(raw)
            off += len(raw)
        else:
            head[k] = v
    if bins:
        head["_bin"] = bins
    hdata = json.dumps(head, sort_keys=True).encode("utf-8")
    total = 2 + _V2_HEAD.size + len(hdata) + off
    if total > max_frame:
        raise FrameTooLarge(
            f"frame of {total} bytes exceeds cap {max_frame}")
    sock.sendall(bytes((WIRE_MAGIC, WIRE_V2))
                 + _V2_HEAD.pack(len(hdata), off) + hdata)
    for raw in chunks:
        sock.sendall(raw)
    return total


def recv_wire(sock: socket.socket, *, max_frame: int = MAX_FRAME
              ) -> Optional[Tuple[Dict[str, Any], int]]:
    """Read one frame of EITHER version; ``(msg, version)``, or ``None``
    on clean EOF at a frame boundary.

    The version is sniffed from the first byte (``WIRE_MAGIC`` opens a
    v2 frame; anything else is a v1 length prefix).  v2 array payloads
    decode zero-copy - each ``"_bin"`` entry becomes a read-only
    ``np.frombuffer`` view over the received payload buffer, placed
    back into the message under its key (bfloat16: a tensor over a copy,
    see ``_decode_raw``).  Torn/oversize containment matches
    :func:`recv_frame` exactly.
    """
    first = _recv_exact(sock, 1)
    if first is None:
        return None
    if first[0] != WIRE_MAGIC:
        rest = _recv_exact(sock, _HEADER.size - 1)
        if rest is None:
            raise TornFrame("peer closed inside a v1 frame header")
        (length,) = _HEADER.unpack(first + rest)
        if length > max_frame:
            raise FrameTooLarge(
                f"declared frame length {length} exceeds cap {max_frame}")
        body = _recv_exact(sock, length)
        if body is None:
            raise TornFrame(f"peer closed before {length}-byte body")
        return json.loads(body.decode("utf-8")), WIRE_V1
    rest = _recv_exact(sock, 1 + _V2_HEAD.size)
    if rest is None:
        raise TornFrame("peer closed inside a v2 frame header")
    version = rest[0]
    if version != WIRE_V2:
        raise TransportError(f"unsupported wire version {version}")
    hlen, plen = _V2_HEAD.unpack(rest[1:])
    if 2 + _V2_HEAD.size + hlen + plen > max_frame:
        raise FrameTooLarge(
            f"declared v2 frame of {hlen}+{plen} bytes exceeds cap "
            f"{max_frame}")
    hdata = _recv_exact(sock, hlen)
    if hdata is None:
        raise TornFrame("peer closed before the v2 header")
    msg = json.loads(hdata.decode("utf-8"))
    payload = b""
    if plen:
        payload = _recv_exact(sock, plen)
        if payload is None:
            raise TornFrame(f"peer closed before {plen}-byte payload")
    bins = msg.pop("_bin", None)
    if bins:
        for k, d in bins.items():
            msg[k] = _decode_raw(payload, d["dtype"], d["shape"],
                                 offset=d["off"], nbytes=d["nbytes"])
    return msg, version


def reply_array(reply: Dict[str, Any]):
    """The array of a reply read by :func:`recv_wire`, either version:
    a v2 reply already holds the decoded array; a v1 reply holds the
    base64 encoding."""
    a = reply["array"]
    if _is_array(a):
        return a
    return decode_array(a)


# ---------------------------------------------------------------------------
# Array + request encoding
# ---------------------------------------------------------------------------

def _is_array(v: Any) -> bool:
    return isinstance(v, (np.ndarray, torch.Tensor))


def _raw_parts(a) -> Tuple[str, List[int], bytes]:
    """(dtype name, shape, C-order little-endian bytes) of a response: a
    numpy array, or a CPU ``torch.bfloat16`` tensor (the server's form of
    a bfloat16 response, sent as its 16-bit words under the name
    ``"bfloat16"``, as ``ml_dtypes`` names it; ``_decode_raw`` undoes
    it).  Any other tensor raises: the wire layer copies nothing off the
    card."""
    if isinstance(a, torch.Tensor):
        if a.dtype != torch.bfloat16 or a.device.type != "cpu":
            raise TypeError(
                f"the wire carries numpy arrays and CPU bfloat16 tensors, "
                f"not a {a.dtype} tensor on {a.device}")
        return ("bfloat16", list(a.shape),
                a.contiguous().view(torch.int16).numpy().tobytes())
    a = np.asarray(a)
    return str(a.dtype), list(a.shape), a.tobytes()


def _decode_raw(buf: bytes, dtype: str, shape, *, offset: int = 0,
                nbytes: Optional[int] = None):
    """The array of ``nbytes`` raw bytes at ``offset`` of ``buf``.

    Every dtype but bfloat16 is a read-only zero-copy ``np.frombuffer``
    view.  bfloat16 becomes a ``torch.bfloat16`` tensor over a COPY of
    its 16-bit words: a tensor over the read-only receive buffer would be
    writable memory that is not (``torch.from_numpy`` warns of exactly
    that), and this is the one place that decision is made.
    """
    if nbytes is None:
        nbytes = len(buf) - offset
    shape = tuple(int(d) for d in shape)
    if dtype == "bfloat16":
        words = np.frombuffer(buf, dtype=np.int16, count=nbytes // 2,
                              offset=offset).reshape(shape)
        return torch.from_numpy(words.copy()).view(torch.bfloat16)
    dt = np.dtype(dtype)
    return np.frombuffer(buf, dtype=dt, count=nbytes // dt.itemsize,
                         offset=offset).reshape(shape)


def encode_array(a) -> Dict[str, Any]:
    """JSON-able form of an array: dtype name, shape, base64 bytes."""
    dtype, shape, raw = _raw_parts(a)
    return {"dtype": dtype, "shape": shape,
            "data": base64.b64encode(raw).decode("ascii")}


def decode_array(d: Dict[str, Any]):
    """Inverse of :func:`encode_array`, byte-exact."""
    return _decode_raw(base64.b64decode(d["data"]), d["dtype"], d["shape"])


def request_to_wire(req: RandRequest, shard: int) -> Dict[str, Any]:
    return {"op": "request", "shard": int(shard), "rid": req.rid,
            "tenant": req.tenant_id, "shape": list(req.shape),
            "sampler": req.sampler, "dtype": req.out_dtype}


def request_from_wire(msg: Dict[str, Any]) -> RandRequest:
    return RandRequest(tenant_id=msg["tenant"],
                       shape=tuple(int(d) for d in msg["shape"]),
                       sampler=msg["sampler"], out_dtype=msg["dtype"],
                       rid=msg["rid"])


# ---------------------------------------------------------------------------
# ShardHost: one fleet process
# ---------------------------------------------------------------------------

class _DropReply(Exception):
    """Scripted drop-frame fault: close the connection instead of
    replying (the request WAS served and journaled)."""


class _Gate:
    """Per-shard arrival-order microbatch gate + in-flight rid registry.

    The determinism contract of pooled/coalesced fleet serving: a batch
    seals when it reaches ``max_batch`` requests or when an explicit
    client ``flush`` op arrives - NEVER on wall-clock and NEVER on
    connection EOF.  A dying client connection therefore cannot change
    batch composition: its parked requests stay parked; the client
    reconnects and resubmits unanswered rids in their original order;
    and the registry attaches those duplicate arrivals to the
    already-parked entry (or the in-flight future) instead of
    re-admitting them.  The gate's arrival sequence - and hence every
    journaled ``batch`` record - is identical to the no-fault run's,
    which is what the kill-mid-burst digest equality rests on.
    """

    def __init__(self, srv: RandServer, max_batch: int):
        self.srv = srv
        self.max_batch = max(1, int(max_batch))
        self._lock = threading.Lock()
        # arrival order; each entry carries every waiter for its rid
        self._pending: List[Tuple[RandRequest, List[Callable]]] = []
        self._pending_rids: Dict[str, List[Callable]] = {}
        self._inflight: Dict[str, Any] = {}       # rid -> Future

    def admit(self, req: RandRequest, deliver: Callable) -> None:
        """Park ``req``; ``deliver(future)`` fires when it resolves.

        A rid already in flight (or parked) gains a second waiter
        instead of a second slot - resubmissions after a connection
        death cannot perturb composition.
        """
        with self._lock:
            fut = self._inflight.get(req.rid)
            if fut is not None:
                fut.add_done_callback(deliver)
                return
            waiters = self._pending_rids.get(req.rid)
            if waiters is not None:
                waiters.append(deliver)
                return
            waiters = [deliver]
            self._pending.append((req, waiters))
            self._pending_rids[req.rid] = waiters
            if len(self._pending) >= self.max_batch:
                self._seal_locked()

    def flush(self) -> None:
        """Seal the current partial batch (client end-of-burst op)."""
        with self._lock:
            if self._pending:
                self._seal_locked()

    def _seal_locked(self) -> None:
        import concurrent.futures
        batch, self._pending = self._pending, []
        self._pending_rids = {}
        try:
            futs = self.srv.submit_batch([r for r, _ in batch])
        except Exception as e:          # refused batch: fail each waiter
            failed: "concurrent.futures.Future" = concurrent.futures.Future()
            failed.set_exception(e)
            for _, waiters in batch:
                for deliver in waiters:
                    deliver(failed)
            return
        for (req, waiters), fut in zip(batch, futs):
            self._inflight[req.rid] = fut
            fut.add_done_callback(self._retire(req.rid))
            for deliver in waiters:
                fut.add_done_callback(deliver)

    def _retire(self, rid: str) -> Callable:
        def cb(fut) -> None:
            # by resolution time the batch record is durable (the
            # server fsyncs before resolving), so late duplicates fall
            # through to the journal replay path
            with self._lock:
                self._inflight.pop(rid, None)
        return cb


class ShardHost:
    """TCP host for one or more logical RandService shards.

    Every logical shard is a full ``RandServer`` over the *same* global
    plan (same seed): which tenants a shard serves is decided entirely
    by the client-side hash ring, so any host can adopt any shard -
    state is (seed, journal), nothing else.  ``device`` (None: the card,
    and an error without one) is every hosted server's device.
    """

    def __init__(self, seed: int, *, host: str = "127.0.0.1",
                 port: int = 0, config: Optional[ServerConfig] = None,
                 injector: Optional[FaultInjector] = None,
                 backend: Optional[str] = None,
                 max_frame: int = MAX_FRAME, device=None):
        self.seed = seed
        self.device = engine.resolve_device(device)
        self.config = config or ServerConfig(max_batch=1,
                                             max_delay_s=0.0)
        self.injector = injector
        self.backend = backend
        self.max_frame = max_frame
        self._servers: Dict[int, RandServer] = {}
        self._journals: Dict[int, audit.Journal] = {}
        self._gates: Dict[int, _Gate] = {}
        self._adopted: set = set()
        self._hung = threading.Event()
        self._lock = threading.Lock()
        self._closing = threading.Event()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        # poll the listener: closing a socket does NOT wake a thread
        # blocked in accept() on Linux, so a timeout is the only way
        # close() can reliably retire the accept thread (accepted conns
        # come out blocking: stdlib accept() resets inherited timeouts)
        self._sock.settimeout(0.2)
        self.address: Tuple[str, int] = self._sock.getsockname()
        self._conns: set = set()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="shardhost-accept", daemon=True)
        self._accept_thread.start()

    # -- shard lifecycle ---------------------------------------------------

    def add_shard(self, shard: int,
                  journal_path: Optional[str] = None) -> RandServer:
        """Open logical shard ``shard`` on this host (initial ownership)."""
        journal = (audit.Journal(journal_path)
                   if journal_path is not None else None)
        srv = RandServer(self.seed, config=self.config, journal=journal,
                         backend=self.backend, device=self.device)
        with self._lock:
            self._servers[shard] = srv
            self._gates[shard] = _Gate(srv, self.config.max_batch)
            if journal is not None:
                self._journals[shard] = journal
        return srv

    def adopt(self, shard: int, journal_path: str) -> RandServer:
        """Take over a dead peer's shard: lock its journal (fencing -
        raises ``JournalLockedError`` while the owner still lives),
        fence the journaled windows, resume its tenant regions.
        """
        journal = audit.Journal(journal_path)     # flock = the fence
        try:
            # the constructor restores + FENCES the journaled ledger
            # before its pool producers lease ahead (a second restore
            # here would wipe those producers' reservations)
            srv = RandServer(self.seed, config=self.config,
                             journal=journal, backend=self.backend,
                             device=self.device)
        except Exception:
            journal.close()
            raise
        with self._lock:
            self._servers[shard] = srv
            self._gates[shard] = _Gate(srv, self.config.max_batch)
            self._journals[shard] = journal
            # the scripted adversary targets a shard's ORIGINAL owner;
            # without this, every process's injector would re-fire the
            # same spec when the retried request reaches the adopter -
            # a scripted single kill would cascade through the fleet
            self._adopted.add(shard)
        return srv

    def shards(self) -> Tuple[int, ...]:
        with self._lock:
            return tuple(sorted(self._servers))

    # -- accept/serve loops ------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._closing.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue            # poll tick: re-check _closing
            except OSError:
                break               # listener closed by close()
            with self._lock:
                self._conns.add(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             name="shardhost-conn", daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        # one write lock per connection: rid-tagged replies are sent by
        # whichever thread resolves the future (pipelined, possibly out
        # of order), and must never interleave mid-frame
        wlock = threading.Lock()
        try:
            while not self._closing.is_set():
                try:
                    got = recv_wire(conn, max_frame=self.max_frame)
                except FrameTooLarge as e:
                    # the stream cannot be resynced after a bad length:
                    # best-effort error frame, then close
                    self._send(conn, wlock, WIRE_V1,
                               {"ok": False, "kind": "frame_too_large",
                                "error": str(e)})
                    return
                except (TornFrame, TransportError, OSError):
                    return          # torn client write: drop the conn only
                if got is None:
                    return          # clean EOF
                msg, version = got
                if msg.get("op") == "request":
                    try:
                        self._handle_request(msg, conn, wlock, version)
                    except _DropReply:
                        return      # scripted fault: vanish without reply
                    except Exception as e:   # noqa: BLE001 - reply, don't die
                        self._send(conn, wlock, version,
                                   {"ok": False, "kind": "server_error",
                                    "rid": msg.get("rid"),
                                    "error": f"{type(e).__name__}: {e}"})
                    continue
                try:
                    reply = self._dispatch(msg)
                except Exception as e:   # noqa: BLE001 - reply, don't die
                    reply = {"ok": False, "kind": "server_error",
                             "error": f"{type(e).__name__}: {e}"}
                if not self._send(conn, wlock, version, reply):
                    return
        finally:
            with self._lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _send(self, conn: socket.socket, wlock: threading.Lock,
              version: int, obj: Dict[str, Any]) -> bool:
        with wlock:
            try:
                send_wire(conn, obj, version=version,
                          max_frame=self.max_frame)
                return True
            except (OSError, TransportError):
                # receiver gone (or reply unsendable): the client's
                # retry path owns recovery - journaled work replays
                return False

    # -- op handlers -------------------------------------------------------

    def _dispatch(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        op = msg.get("op")
        if op == "adopt":
            return self._handle_adopt(msg)
        if op == "stats":
            return self._handle_stats(msg)
        if op == "hello":
            return self._handle_hello(msg)
        if op == "flush":
            return self._handle_flush(msg)
        if op == "reset":
            return self._handle_reset(msg)
        if op == "ping":
            return {"ok": True, "op": "ping", "shards": list(self.shards())}
        return {"ok": False, "kind": "bad_request",
                "error": f"unknown op {op!r}"}

    def _handle_hello(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        """Version negotiation: highest wire version both sides speak.

        The reply itself goes out in the version the hello ARRIVED in
        (like every reply), so a v1-only peer never sees v2 bytes.
        """
        offered = set(msg.get("versions", [WIRE_V1]))
        common = [v for v in SUPPORTED_VERSIONS if v in offered]
        if not common:
            return {"ok": False, "kind": "bad_request",
                    "error": f"no common wire version in {sorted(offered)}; "
                             f"supported {list(SUPPORTED_VERSIONS)}"}
        return {"ok": True, "op": "hello", "version": max(common),
                "max_batch": self.config.max_batch}

    def _handle_flush(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        """Seal the addressed shard's partial batch (end-of-burst)."""
        try:
            shard, _ = self._shard_server(msg)
        except WireError as e:
            return {"ok": False, "kind": e.kind, "error": str(e)}
        with self._lock:
            gate = self._gates.get(shard)
        if gate is not None:
            gate.flush()
        return {"ok": True, "op": "flush", "shard": shard}

    def _handle_reset(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        """Zero the shard's serving metrics (benchmark warm-up split)."""
        try:
            shard, srv = self._shard_server(msg)
        except WireError as e:
            return {"ok": False, "kind": e.kind, "error": str(e)}
        srv.reset_metrics()
        return {"ok": True, "op": "reset", "shard": shard}

    def _shard_server(self, msg) -> Tuple[int, RandServer]:
        shard = int(msg.get("shard", -1))
        with self._lock:
            srv = self._servers.get(shard)
        if srv is None:
            raise WireError("not_owner",
                            f"shard {shard} is not hosted here "
                            f"(have {list(self.shards())})")
        return shard, srv

    def _handle_request(self, msg: Dict[str, Any], conn: socket.socket,
                        wlock: threading.Lock, version: int) -> None:
        """Admit one request (reader thread); the reply is sent by the
        future's done-callback - rid-tagged, possibly out of order with
        later requests on the same connection (pipelining)."""
        try:
            shard, srv = self._shard_server(msg)
        except WireError as e:
            self._send(conn, wlock, version,
                       {"ok": False, "kind": e.kind,
                        "rid": msg.get("rid"), "error": str(e)})
            return
        req = request_from_wire(msg)
        if self._hung.is_set():
            # a hung host is wedged for good: every request (including
            # reconnect retries) stalls, holding the journal flock -
            # only fencing (SIGKILL) + peer adoption recovers the shard
            time.sleep(3600.0)
        drop_after = False
        if self.injector is not None and shard not in self._adopted:
            spec = self.injector.fire(shard, rid_index(req.rid))
            if spec is not None:
                if spec.kind == "kill":
                    # SIGKILL semantics: no unwind, no journal write for
                    # this request, flock released by the kernel
                    os._exit(137)
                elif spec.kind == "hang":
                    self._hung.set()
                    time.sleep(3600.0)
                elif spec.kind == "slow":
                    # head-of-line on THIS connection only: the reader
                    # stalls, so later arrivals on the conn queue behind
                    time.sleep(spec.seconds)
                elif spec.kind == "drop":
                    drop_after = True
        journal = self._journals.get(shard)
        if journal is not None and req.rid is not None:
            entry = journal.find_request(req.rid)
            if entry is not None:
                # idempotent retry: the assignment is durable - replay
                # it instead of serving a second window.  Never admitted
                # to the gate, so resubmissions of journaled rids cannot
                # perturb batch composition.
                a = audit.replay_entry(entry, seed=self.seed,
                                       backend=self.backend,
                                       device=self.device)
                if drop_after:
                    raise _DropReply()
                self._send(conn, wlock, version,
                           {"ok": True, "rid": req.rid, "replayed": True,
                            "array": a})
                return
        with self._lock:
            gate = self._gates[shard]

        def deliver(fut) -> None:
            try:
                result = fut.result()
            except Exception as e:      # noqa: BLE001 - reply, don't die
                obj = {"ok": False, "kind": "server_error",
                       "rid": req.rid, "error": f"{type(e).__name__}: {e}"}
            else:
                obj = {"ok": True, "rid": req.rid, "replayed": False,
                       "array": result}
            if drop_after:
                # scripted fault: the request WAS served and journaled;
                # vanish (close the conn) instead of replying
                self._drop_conn(conn)
                return
            self._send(conn, wlock, version, obj)

        gate.admit(req, deliver)

    def _drop_conn(self, conn: socket.socket) -> None:
        try:
            conn.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            conn.close()
        except OSError:
            pass

    def _handle_adopt(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        shard = int(msg["shard"])
        with self._lock:
            if shard in self._servers:
                return {"ok": True, "shard": shard, "already": True}
        try:
            self.adopt(shard, msg["journal"])
        except audit.JournalLockedError as e:
            return {"ok": False, "kind": "locked", "error": str(e)}
        return {"ok": True, "shard": shard, "already": False}

    def _handle_stats(self, msg: Dict[str, Any]) -> Dict[str, Any]:
        try:
            shard, srv = self._shard_server(msg)
        except WireError as e:
            return {"ok": False, "kind": e.kind, "error": str(e)}
        return {"ok": True, "shard": shard, "stats": srv.stats()}

    # -- lifecycle ---------------------------------------------------------

    def close(self, timeout: Optional[float] = 60.0) -> None:
        """Stop accepting, drain every hosted shard, close journals,
        and retire every transport thread - an in-process host must not
        leak accept/conn threads into its embedder."""
        self._closing.set()
        self._accept_thread.join(timeout=5.0)
        try:
            self._sock.close()
        except OSError:
            pass
        with self._lock:
            servers = list(self._servers.values())
        for srv in servers:
            srv.shutdown(timeout)
        # idle persistent connections sit blocked in recv; close() alone
        # does not wake them, shutdown() delivers EOF and does
        with self._lock:
            conns, self._conns = list(self._conns), set()
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass

    def __enter__(self) -> "ShardHost":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# Client-side RPC helper
# ---------------------------------------------------------------------------

def rpc(address: Tuple[str, int], msg: Dict[str, Any], *,
        timeout: Optional[float] = 60.0,
        max_frame: int = MAX_FRAME) -> Dict[str, Any]:
    """One-shot request/response against a ShardHost (fresh connection)."""
    with socket.create_connection(address, timeout=timeout) as sock:
        send_frame(sock, msg, max_frame=max_frame)
        reply = recv_frame(sock, max_frame=max_frame)
    if reply is None:
        raise TornFrame(f"no reply from {address}")
    return reply
