"""The port's wire layer (``repro_torch.service.transport`` and the fleet's
hash ring) against the reference ``repro.service``, on the CPU.

Frames are the reference's byte for byte in v1 and v2 for uint32,
float32, bfloat16 and bool - a bfloat16 array is a CPU ``torch.bfloat16``
tensor in the port and an ``ml_dtypes`` array in the reference, carried
as the same 16-bit words - and each package decodes the other's frames to
the same bytes.  The framing's containment of torn, oversize and
unknown-version frames, the in-process ``ShardHost`` (idempotent retries,
drop faults, version negotiation, in-flight dedup, the pipelined client)
and the routing ring behave as the reference's.
"""
import socket
import struct
import threading
import time
import warnings

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.service import audit as j_audit
from repro.service import fleet as j_fleet
from repro.service import transport as j_transport
from repro_torch.runtime import fault as t_fault
from repro_torch.service import audit as t_audit
from repro_torch.service import fleet as t_fleet
from repro_torch.service import transport as t_transport
from repro_torch.service.burst import make_requests
from repro_torch.service.server import ServerConfig

CPU = "cpu"
VERSIONS = [t_transport.WIRE_V1, t_transport.WIRE_V2]
DTYPES = ["uint32", "float32", "bfloat16", "bool"]


class _Buf:
    """A socket stand-in that records every byte sent."""

    def __init__(self):
        self.data = b""

    def sendall(self, d):
        self.data += bytes(d)


def _arrays(dtype):
    """(reference array, port array) of one dtype, equal bytes."""
    rng = np.random.default_rng(17)
    if dtype == "bfloat16":
        words = rng.integers(0, 1 << 16, size=(3, 5), dtype=np.uint16)
        return (words.view(ml_dtypes.bfloat16),
                torch.from_numpy(words.astype(np.int16)).view(torch.bfloat16))
    if dtype == "uint32":
        a = rng.integers(0, 1 << 32, size=(4, 3), dtype=np.uint32)
    elif dtype == "float32":
        a = rng.standard_normal(7).astype(np.float32)
    else:
        a = rng.random((2, 3, 2)) < 0.5
    return a, a.copy()


def _raw(a):
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().tobytes()
    return np.asarray(a).tobytes()


def _pair():
    a, b = socket.socketpair()
    a.settimeout(10.0)
    b.settimeout(10.0)
    return a, b


def _reply(array):
    return {"ok": True, "rid": "burst/000003", "replayed": False,
            "array": array}


# ---------------------------------------------------------------------------
# frames against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("version", VERSIONS)
def test_frame_bytes_equal_reference(version, dtype):
    ref, port = _arrays(dtype)
    jb, tb = _Buf(), _Buf()
    n_ref = j_transport.send_wire(jb, _reply(ref), version=version)
    n_port = t_transport.send_wire(tb, _reply(port), version=version)
    assert tb.data == jb.data and n_port == n_ref == len(tb.data)
    assert t_transport.encode_array(port) == j_transport.encode_array(ref)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("version", VERSIONS)
def test_frames_decode_across_packages(version, dtype):
    ref, port = _arrays(dtype)
    a, b = _pair()
    try:
        j_transport.send_wire(a, _reply(ref), version=version)
        t_transport.send_wire(a, _reply(port), version=version)
        from_ref, v1 = t_transport.recv_wire(b)
        from_port, v2 = j_transport.recv_wire(b)
    finally:
        a.close()
        b.close()
    assert v1 == v2 == version
    got = t_transport.reply_array(from_ref)
    back = j_transport.reply_array(from_port)
    if dtype == "bfloat16":
        assert got.dtype == torch.bfloat16
        assert back.dtype == np.dtype(ml_dtypes.bfloat16)
    else:
        assert isinstance(got, np.ndarray) and got.dtype == np.dtype(dtype)
    assert tuple(got.shape) == tuple(back.shape) == tuple(ref.shape)
    assert _raw(got) == _raw(back) == _raw(ref)
    # the digest over wire-decoded responses is the server's own digest
    want = j_audit.response_digest({"r": ref})
    assert t_audit.response_digest({"r": got}) == want
    assert j_audit.response_digest({"r": back}) == want
    assert t_audit.response_digest({"r": port}) == want


@pytest.mark.parametrize("version", VERSIONS)
def test_bfloat16_decode_is_a_copy_without_warnings(version):
    _, port = _arrays("bfloat16")
    buf = _Buf()
    t_transport.send_wire(buf, _reply(port), version=version)
    a, b = _pair()
    try:
        a.sendall(buf.data)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            got = t_transport.reply_array(t_transport.recv_wire(b)[0])
    finally:
        a.close()
        b.close()
    got[0, 0] = 1.0                      # writable: its own buffer
    assert torch.equal(got[1:], port[1:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.bool])
@pytest.mark.parametrize("version", VERSIONS)
def test_wire_refuses_tensors_other_than_cpu_bfloat16(version, dtype):
    """Only a bfloat16 response travels as a torch tensor; any other tensor
    is refused, in both frames and in ``encode_array``, not converted."""
    t = torch.zeros((2, 3), dtype=dtype)
    with pytest.raises(TypeError, match="numpy arrays and CPU bfloat16"):
        t_transport.send_wire(_Buf(), _reply(t), version=version)
    with pytest.raises(TypeError, match="numpy arrays and CPU bfloat16"):
        t_transport.encode_array(t)


def test_v2_is_zero_copy_for_numpy_dtypes():
    a, b = _pair()
    try:
        t_transport.send_wire(a, {"x": np.arange(64, dtype=np.uint32)},
                              version=t_transport.WIRE_V2)
        x = t_transport.recv_wire(b)[0]["x"]
    finally:
        a.close()
        b.close()
    assert isinstance(x, np.ndarray)
    assert x.base is not None and not x.flags.writeable


# ---------------------------------------------------------------------------
# containment, as tests/test_fleet.py and tests/test_wire.py hold the
# reference to it
# ---------------------------------------------------------------------------

def test_frame_roundtrip_and_clean_eof():
    a, b = _pair()
    msg = {"op": "ping", "nested": {"xs": [1, 2, 3]}}
    t_transport.send_frame(a, msg)
    assert t_transport.recv_frame(b) == msg
    for i in range(5):
        t_transport.send_frame(a, {"i": i})
    assert [t_transport.recv_frame(b) for _ in range(5)] == \
        [{"i": i} for i in range(5)]
    a.close()
    assert t_transport.recv_frame(b) is None
    assert t_transport.recv_wire(b) is None
    b.close()


@pytest.mark.parametrize("case", ["v1 body", "v1 header", "v2 header",
                                  "v2 payload"])
def test_torn_frames_raise_torn_frame(case):
    a, b = _pair()
    if case == "v1 body":
        a.sendall(struct.pack("!I", 100) + b'{"partial": tru')
    elif case == "v1 header":
        a.sendall(b"\x00\x00")
    elif case == "v2 header":
        a.sendall(bytes([t_transport.WIRE_MAGIC]))
    else:
        buf = _Buf()
        t_transport.send_wire(buf, {"x": np.arange(1024, dtype=np.float32)},
                              version=t_transport.WIRE_V2)
        a.sendall(buf.data[:-100])
    a.close()
    recv = (t_transport.recv_frame if case.startswith("v1")
            else t_transport.recv_wire)
    with pytest.raises(t_transport.TornFrame):
        recv(b)
    b.close()


def test_oversize_frames_are_refused_before_reading():
    a, b = _pair()
    with pytest.raises(t_transport.FrameTooLarge):
        t_transport.send_frame(a, {"blob": "x" * 256}, max_frame=64)
    with pytest.raises(t_transport.FrameTooLarge):
        t_transport.send_wire(a, {"x": np.zeros(64, np.float32)},
                              version=t_transport.WIRE_V2, max_frame=64)
    a.sendall(struct.pack("!I", t_transport.MAX_FRAME + 1))
    with pytest.raises(t_transport.FrameTooLarge):
        t_transport.recv_frame(b)
    a.close()
    b.close()
    a, b = _pair()
    a.sendall(bytes((t_transport.WIRE_MAGIC, t_transport.WIRE_V2))
              + struct.pack("<II", 16, t_transport.MAX_FRAME + 1))
    with pytest.raises(t_transport.FrameTooLarge):
        t_transport.recv_wire(b)
    a.close()
    b.close()


def test_unknown_wire_version_is_refused():
    a, b = _pair()
    a.sendall(bytes((t_transport.WIRE_MAGIC, 9)) + struct.pack("<II", 0, 0))
    with pytest.raises(t_transport.TransportError):
        t_transport.recv_wire(b)
    with pytest.raises(t_transport.TransportError):
        t_transport.send_wire(a, {"ok": True}, version=9)
    a.close()
    b.close()


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", [1, 2, 3, 4, 5])
def test_ring_owner_equals_reference_over_10k_tenants(shards):
    port, ref = t_fleet.HashRing(shards), j_fleet.HashRing(shards)
    ids = [f"tenant/{i:05d}" for i in range(10_000)]
    owners = [port.owner(t) for t in ids]
    assert owners == [ref.owner(t) for t in ids]
    assert set(owners) == set(range(shards))
    assert [port.peers(s) for s in range(shards)] == \
        [ref.peers(s) for s in range(shards)]


# ---------------------------------------------------------------------------
# ShardHost in process
# ---------------------------------------------------------------------------

def _req_msg(shard, rid, tenant="alice", n=16, sampler="bits",
             dtype="float32"):
    return {"op": "request", "shard": shard, "rid": rid, "tenant": tenant,
            "shape": [n], "sampler": sampler, "dtype": dtype}


def _host(tmp_path, *, max_batch=4, injector=None, hot=(), seed=0):
    cfg = ServerConfig(max_batch=max_batch, max_delay_s=0.0,
                       hot_classes=tuple(hot))
    host = t_transport.ShardHost(seed, config=cfg, injector=injector,
                                 device=CPU)
    host.add_shard(0, str(tmp_path / "shard0.jsonl"))
    return host


def test_shardhost_serves_then_replays_a_journaled_rid(tmp_path):
    with t_transport.ShardHost(3, device=CPU) as host:
        host.add_shard(0, str(tmp_path / "j.jsonl"))
        first = t_transport.rpc(host.address, _req_msg(0, "rid/001"))
        assert first["ok"] and first["replayed"] is False
        again = t_transport.rpc(host.address, _req_msg(0, "rid/001"))
        assert again["ok"] and again["replayed"] is True
        a1 = t_transport.decode_array(first["array"])
        assert t_transport.decode_array(again["array"]).tobytes() == \
            a1.tobytes()
        other = t_transport.rpc(host.address, _req_msg(0, "rid/002"))
        assert t_transport.decode_array(other["array"]).tobytes() != \
            a1.tobytes()
        r = t_transport.rpc(host.address, _req_msg(5, "rid/003"))
        assert not r["ok"] and r["kind"] == "not_owner"
        r = t_transport.rpc(host.address, {"op": "frobnicate"})
        assert not r["ok"] and r["kind"] == "bad_request"
        r = t_transport.rpc(host.address, {"op": "stats", "shard": 0})
        assert r["ok"] and r["stats"]["requests_served"] == 2


def test_shardhost_survives_torn_and_oversize_clients(tmp_path):
    with t_transport.ShardHost(3, device=CPU) as host:
        host.add_shard(0, str(tmp_path / "j.jsonl"))
        for junk in (struct.pack("!I", 500) + b'{"op": "requ', b"\x00",
                     bytes([t_transport.WIRE_MAGIC])):
            s = socket.create_connection(host.address, timeout=10)
            s.sendall(junk)
            s.close()
        s = socket.create_connection(host.address, timeout=10)
        s.sendall(struct.pack("!I", t_transport.MAX_FRAME + 7))
        reply = t_transport.recv_frame(s)
        assert reply is not None and reply["kind"] == "frame_too_large"
        assert t_transport.recv_frame(s) is None
        s.close()
        assert t_transport.rpc(host.address, _req_msg(0, "rid/ok1"))["ok"]


def test_shardhost_close_retires_transport_threads(tmp_path):
    host = t_transport.ShardHost(3, device=CPU)
    host.add_shard(0, str(tmp_path / "j.jsonl"))
    assert t_transport.rpc(host.address, {"op": "ping"})["ok"]
    idle = socket.create_connection(host.address, timeout=10)
    time.sleep(0.3)
    host.close()
    deadline = time.monotonic() + 5.0
    left = []
    while time.monotonic() < deadline:
        left = [t for t in threading.enumerate()
                if t.name.startswith("shardhost") and t.is_alive()]
        if not left:
            break
        time.sleep(0.05)
    assert not left, [t.name for t in left]
    idle.close()


def test_shardhost_drop_fault_retry_is_bit_identical(tmp_path):
    inj = t_fault.FaultInjector(t_fault.FaultPlan.parse("drop@7"))
    path = str(tmp_path / "j.jsonl")
    with t_transport.ShardHost(3, injector=inj, device=CPU) as host:
        host.add_shard(0, path)
        s = socket.create_connection(host.address, timeout=30)
        t_transport.send_frame(s, _req_msg(0, "rid/007"))
        with pytest.raises((t_transport.TornFrame, OSError)):
            if t_transport.recv_frame(s) is None:
                raise t_transport.TornFrame("dropped")
        s.close()
        retry = t_transport.rpc(host.address, _req_msg(0, "rid/007"))
        assert retry["ok"] and retry["replayed"] is True
        served = t_transport.decode_array(retry["array"])
    replayed = t_audit.replay(path, seed=3, device=CPU)
    assert served.tobytes() == replayed["rid/007"].tobytes()
    assert served.tobytes() == \
        j_audit.replay(path, seed=3)["rid/007"].tobytes()


def _hello(addr, versions):
    with socket.create_connection(addr, timeout=10.0) as s:
        s.settimeout(10.0)
        t_transport.send_wire(s, {"op": "hello", "versions": versions},
                              version=t_transport.WIRE_V1)
        return t_transport.recv_wire(s)[0]


def test_hello_negotiates_max_common_version(tmp_path):
    host = _host(tmp_path, max_batch=4)
    try:
        r = _hello(host.address, [1, 2])
        assert r["ok"] and r["version"] == 2 and r["max_batch"] == 4
        assert _hello(host.address, [1])["version"] == 1
        assert not _hello(host.address, [99])["ok"]
    finally:
        host.close()


def test_duplicate_inflight_rid_attaches(tmp_path):
    host = _host(tmp_path, max_batch=2)
    try:
        req = _req_msg(0, "dup/0", sampler="uniform", dtype="bfloat16")
        with socket.create_connection(host.address, timeout=10.0) as s1, \
                socket.create_connection(host.address, timeout=10.0) as s2:
            s1.settimeout(30.0)
            s2.settimeout(30.0)
            t_transport.send_wire(s1, req, version=t_transport.WIRE_V2)
            t_transport.send_wire(s2, dict(req), version=t_transport.WIRE_V2)
            t_transport.send_wire(s2, {"op": "flush", "shard": 0})
            r1 = t_transport.recv_wire(s1)[0]
            r2 = t_transport.recv_wire(s2)[0]
            while r2.get("rid") is None:        # the flush ack
                r2 = t_transport.recv_wire(s2)[0]
        a1, a2 = t_transport.reply_array(r1), t_transport.reply_array(r2)
        assert a1.dtype == torch.bfloat16 and tuple(a1.shape) == (16,)
        assert torch.equal(a1.view(torch.int16), a2.view(torch.int16))
        jr = t_audit.Journal(str(tmp_path / "shard0.jsonl"), readonly=True)
        assert [r["rid"] for r in jr.requests()] == ["dup/0"]
    finally:
        host.close()


def _client_digest(tmp_path, name, plan):
    jdir = tmp_path / name
    jdir.mkdir()
    injector = t_fault.FaultInjector(plan) if plan else None
    host = _host(jdir, injector=injector,
                 hot=(("bits", "float32"), ("uniform", "float32")))
    try:
        reqs = make_requests(burst=48, tenants=12, seed=7)
        client = t_fleet.FleetClient(
            {0: host.address}, {0: str(jdir / "shard0.jsonl")},
            config=t_fleet.FleetConfig(num_shards=1, journal_dir=str(jdir)))
        out = client.run_shard(0, reqs)
        order = [rid for _, rid in client.delivery_log]
        stats = client.stats()
        client.close()
    finally:
        host.close()
    assert order == [r.rid for r in reqs]
    assert stats["requests"] == 48 and stats["bytes_on_wire_per_req"] > 0
    return t_audit.response_digest(out)


@pytest.mark.parametrize("faults", ["drop@13", "slow@11~0.3",
                                    "drop@5,drop@29"])
def test_pipelined_faults_preserve_order_and_bytes(tmp_path, faults):
    base = _client_digest(tmp_path, "base", None)
    assert _client_digest(tmp_path, "hurt",
                          t_fault.FaultPlan.parse(faults)) == base


#: the integer and threshold classes: equal to the reference bit for bit
EXACT = [("bits", "float32"), ("uniform", "float32"), ("uniform", "bfloat16"),
         ("bernoulli(0.25)", "float32"), ("poisson(3.5)", "bfloat16"),
         ("categorical[0.5,0.25,0.125,0.125]", "float32")]


def test_reference_rpc_gets_the_reference_shards_bytes(tmp_path):
    """The reference client's one-shot ``rpc`` against a port ShardHost
    and against a reference ShardHost: the same bytes, v1 frames."""
    (tmp_path / "p").mkdir()
    (tmp_path / "r").mkdir()
    port = t_transport.ShardHost(3, device=CPU)
    ref = j_transport.ShardHost(3)
    try:
        port.add_shard(0, str(tmp_path / "p" / "j.jsonl"))
        ref.add_shard(0, str(tmp_path / "r" / "j.jsonl"))
        for i, (sampler, dtype) in enumerate(EXACT * 2):
            msg = _req_msg(0, f"x/{i:03d}", tenant=f"t{i % 3}",
                           n=5 + 37 * i, sampler=sampler, dtype=dtype)
            got = j_transport.rpc(port.address, msg)
            want = j_transport.rpc(ref.address, msg)
            assert got["ok"] and want["ok"], (got, want)
            assert got == want
    finally:
        port.close()
        ref.close()
    assert (tmp_path / "p" / "j.jsonl").read_bytes() == \
        (tmp_path / "r" / "j.jsonl").read_bytes()
