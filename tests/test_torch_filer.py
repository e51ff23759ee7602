"""The port's filer held against the reference's (tests/test_filer.py):
the chunk interval model, the five embedded store kinds, the filer's
namespace operations on the same clock, a port and a reference cluster
(master, two volume servers, filer) given the same requests, the gRPC
surface through either package's stub, metadata subscription, the
on-disk stores and the metadata log opened across the packages in both
directions, leveldb persistence and its torn tail, chunk encryption, and
hardlinks.  Entries are compared as serialized protobuf bytes."""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
from helpers import free_port

from seaweedfs_tpu.filer import filechunks as ref_chunks
from seaweedfs_tpu.filer import filer as ref_filer_mod
from seaweedfs_tpu.filer import meta_log as ref_meta_log
from seaweedfs_tpu.filer.filerstore import make_store as ref_make_store
from seaweedfs_tpu.pb import filer_pb2 as ref_pb
from seaweedfs_tpu.pb import rpc as ref_rpc
from seaweedfs_tpu_torch.filer import filechunks
from seaweedfs_tpu_torch.filer import filer as filer_mod
from seaweedfs_tpu_torch.filer import meta_log
from seaweedfs_tpu_torch.filer.filerstore import make_store
from seaweedfs_tpu_torch.pb import filer_pb2 as pb
from seaweedfs_tpu_torch.pb import rpc

KINDS = ("memory", "sqlite", "leveldb", "leveldb2", "leveldb3")
SIDES = {"port": (pb, make_store, filer_mod, filechunks, meta_log),
         "ref": (ref_pb, ref_make_store, ref_filer_mod, ref_chunks,
                 ref_meta_log)}


def _chunk(side, fid, offset, size, mtime):
    return SIDES[side][0].FileChunk(file_id=fid, offset=offset, size=size,
                                    mtime=mtime)


def _ser(entries) -> list[bytes]:
    return [e.SerializeToString(deterministic=True) for e in entries]


# -- the interval model ------------------------------------------------------

INTERVAL_CASES = {
    "append": [("1,a", 0, 100, 1), ("2,b", 100, 50, 2)],
    "full_overwrite": [("1,a", 0, 100, 1), ("2,b", 0, 100, 2)],
    "partial_overwrite": [("1,a", 0, 100, 1), ("2,b", 30, 40, 2)],
    "range": [("1,a", 0, 100, 1), ("2,b", 100, 100, 2)],
    "seeded": [(f"{i},f{i:x}", int(o), int(s), int(m)) for i, (o, s, m)
               in enumerate(np.random.default_rng(7).integers(
                   1, 400, (24, 3)))],
}


def _intervals(side, case):
    fc = SIDES[side][3]
    chunks = [_chunk(side, *c) for c in INTERVAL_CASES[case]]
    vis = [(v.start, v.stop, v.file_id, v.chunk_offset)
           for v in fc.non_overlapping_visible_intervals(chunks)]
    views = [(v.file_id, v.offset, v.size, v.logical_offset)
             for v in fc.view_from_chunks(chunks, 50, 100)]
    kept, garbage = fc.compact_chunks(chunks)
    minus = fc.minus_chunks(chunks, chunks[1:] + [_chunk(side, "9,z", 0,
                                                         10, 99)])
    return (vis, views, _ser(kept), _ser(garbage), _ser(minus),
            fc.total_size(chunks), fc.etag(chunks))


@pytest.mark.parametrize("case", sorted(INTERVAL_CASES))
def test_visible_intervals_are_the_references(case):
    got, want = _intervals("port", case), _intervals("ref", case)
    assert got == want
    if case == "partial_overwrite":
        assert [v[:3] for v in got[0]] == [(0, 30, "1,a"), (30, 70, "2,b"),
                                           (70, 100, "1,a")]


# -- stores ------------------------------------------------------------------


def _store(side, kind, root):
    mk = SIDES[side][1]
    os.makedirs(root, exist_ok=True)
    path = {"sqlite": "filer.db", "leveldb": "ldb", "leveldb2": "ldb2",
            "leveldb3": "ldb3"}.get(kind)
    return mk(kind) if path is None else mk(kind, path=os.path.join(root,
                                                                    path))


def _entry(side, name, is_dir=False, content=b"", size=0):
    e = SIDES[side][0].Entry(name=name, is_directory=is_dir, content=content)
    e.attributes.file_size = size
    e.attributes.mtime = 1_700_000_000
    return e


def _store_ops(side, kind, root, op):
    s = _store(side, kind, root)
    out = []
    try:
        if op == "crud":
            s.insert_entry("/d", _entry(side, "f1", content=b"one"))
            s.insert_entry("/d", _entry(side, "f2", size=7))
            out.append(_ser([s.find_entry("/d", "f1")]))
            out.append(s.find_entry("/d", "zz"))
            out.append(_ser(s.list_entries("/d")))
            s.update_entry("/d", _entry(side, "f2", size=9))
            out.append(_ser([s.find_entry("/d", "f2")]))
            s.delete_entry("/d", "f1")
            out.append(s.find_entry("/d", "f1"))
            out.append(_ser(s.list_entries("/d")))
        elif op == "listing":
            for n in ["a1", "a2", "b1", "b2", "c1", "/b/in/bucket"][:5]:
                s.insert_entry("/p", _entry(side, n))
            out.append(_ser(s.list_entries("/p", limit=2)))
            out.append(_ser(s.list_entries("/p", start_from="a2")))
            out.append(_ser(s.list_entries("/p", start_from="a2",
                                           inclusive=True)))
            out.append(_ser(s.list_entries("/p", prefix="b")))
            s.insert_entry("/buckets/b1", _entry(side, "o", size=3))
            out.append(_ser(s.list_entries("/buckets/b1")))
        elif op == "delete_folder_children":
            s.insert_entry("/x", _entry(side, "sub", is_dir=True))
            s.insert_entry("/x/sub", _entry(side, "f"))
            s.insert_entry("/x/sub/deep", _entry(side, "g"))
            s.insert_entry("/xother", _entry(side, "keep"))
            s.delete_folder_children("/x/sub")
            out += [s.find_entry("/x/sub", "f"),
                    s.find_entry("/x/sub/deep", "g"),
                    _ser([s.find_entry("/xother", "keep")]),
                    _ser(s.list_entries("/x"))]
        else:  # kv
            s.kv_put(b"k", b"v")
            out.append(s.kv_get(b"k"))
            s.kv_put(b"k", b"")
            out.append(s.kv_get(b"k"))
            s.kv_put(b"\x00bin", b"\xff" * 9)
            out.append(s.kv_get(b"\x00bin"))
    finally:
        s.close()
    return out


@pytest.mark.parametrize("op", ["crud", "listing", "delete_folder_children",
                                "kv"])
@pytest.mark.parametrize("kind", KINDS)
def test_store_is_the_references(tmp_path, kind, op):
    got = _store_ops("port", kind, str(tmp_path / "port"), op)
    want = _store_ops("ref", kind, str(tmp_path / "ref"), op)
    assert got == want


def _fill_store(side, kind, root):
    s = _store(side, kind, root)
    for i in range(40):
        d = f"/buckets/b{i % 3}/dir{i % 5}" if i % 2 else f"/plain/d{i % 4}"
        s.insert_entry(d, _entry(side, f"f{i:03d}", size=i,
                                 content=bytes([i]) * (i % 7)))
    s.delete_entry("/plain/d0", "f000")
    s.kv_put(b"filer.store.id", b"\x00\x00\x00\x07")
    s.close()


def _list_store(side, kind, root):
    s = _store(side, kind, root)
    try:
        dirs = [f"/buckets/b{b}/dir{d}" for b in range(3) for d in range(5)]
        dirs += [f"/plain/d{d}" for d in range(4)]
        return ({d: _ser(s.list_entries(d, limit=100)) for d in dirs},
                s.kv_get(b"filer.store.id"))
    finally:
        s.close()


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
@pytest.mark.parametrize("kind", ["sqlite", "leveldb", "leveldb2",
                                  "leveldb3"])
def test_on_disk_store_opens_across_packages(tmp_path, kind, direction):
    """A store directory written by one package lists the same entries,
    byte for byte, in the other, and in the writer itself."""
    writer, reader = direction.split("_to_")
    root = str(tmp_path)
    _fill_store(writer, kind, root)
    got = _list_store(reader, kind, root)
    assert got == _list_store(writer, kind, root)
    assert sum(len(v) for v in got[0].values()) == 39
    assert got[1] == b"\x00\x00\x00\x07"


def _tail_all(log, n=12):
    stop, out = threading.Event(), []
    for seq, r in log.tail(0, stop_event=stop, poll_interval=0.01):
        out.append((seq, r.SerializeToString(deterministic=True)))
        if seq == n:
            stop.set()
    return out


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_meta_log_segment_opens_across_packages(tmp_path, direction):
    writer, reader = direction.split("_to_")
    wpb, _, _, _, wlog = SIDES[writer]
    log = wlog.MetaLogBuffer(dir=str(tmp_path / "log"), fsync=False)
    for i in range(12):
        e = wpb.Entry(name=f"e{i}", content=b"x" * i)
        log.append(f"/d{i % 3}", None if i % 4 else e, e,
                   signatures=[i] if i % 5 == 0 else None,
                   ts=1_700_000_000_000_000_000 + i)
    log.close()
    rlog = SIDES[reader][4].MetaLogBuffer(dir=str(tmp_path / "log"),
                                          fsync=False)
    try:
        assert rlog.log_id == log.log_id and rlog.last_seq() == 12
        got = _tail_all(rlog)
        again = wlog.MetaLogBuffer(dir=str(tmp_path / "log"), fsync=False)
        want = _tail_all(again)
        again.close()
        assert got == want and len(got) == 12
    finally:
        rlog.close()


def test_leveldb_store_persistence_and_compaction(tmp_path):
    s = make_store("leveldb", path=str(tmp_path / "ldb"), compact_bytes=2048)
    r = ref_make_store("leveldb", path=str(tmp_path / "rldb"),
                       compact_bytes=2048)
    for st, side in ((s, "port"), (r, "ref")):
        for i in range(30):
            st.insert_entry("/d", _entry(side, f"f{i:03d}",
                                         content=b"x" * 100))
        for i in range(0, 30, 2):
            st.delete_entry("/d", f"f{i:03d}")
        st.kv_put(b"k1", b"v1")
        st.close()
    for d in ("ldb", "rldb"):
        with open(tmp_path / d / "wal.log", "rb") as f:
            wal = f.read()
        assert len(wal) < 30 * 130
    with open(tmp_path / "ldb" / "wal.log", "rb") as a, \
            open(tmp_path / "rldb" / "wal.log", "rb") as b:
        assert a.read() == b.read()
    s2 = make_store("leveldb", path=str(tmp_path / "ldb"))
    assert [e.name for e in s2.list_entries("/d", limit=100)] == \
        [f"f{i:03d}" for i in range(1, 30, 2)]
    assert s2.find_entry("/d", "f000") is None
    assert s2.kv_get(b"k1") == b"v1"
    s2.close()


@pytest.mark.parametrize("side", ["port", "ref"])
def test_leveldb_store_torn_tail_heals(tmp_path, side):
    """A torn WAL record written by either package is truncated when the
    port opens the store."""
    path = str(tmp_path / "torn")
    s = SIDES[side][1]("leveldb", path=path)
    s.insert_entry("/d", _entry(side, "keep.txt", content=b"kept"))
    s.close()
    with open(os.path.join(path, "wal.log"), "ab") as f:
        f.write(b"\x01\x10\x00\x00\x00/partial")
    s2 = make_store("leveldb", path=path)
    assert s2.find_entry("/d", "keep.txt").content == b"kept"
    s2.insert_entry("/d", _entry("port", "after.txt", content=b"ok"))
    s2.close()
    s3 = ref_make_store("leveldb", path=path)
    assert s3.find_entry("/d", "after.txt").content == b"ok"
    s3.close()


def test_not_ported_store_kinds_name_the_roadmap():
    for kind in ("redis", "etcd", "elastic7", "mongodb", "cassandra",
                 "mysql", "postgres"):
        with pytest.raises(ValueError, match="ROADMAP A-7"):
            make_store(kind)


# -- the filer's operations, on one clock -------------------------------------


class _Clock:
    """time.time / time.time_ns of a fixed instant, ns advancing by one
    per call; the rest from the real module."""

    def __init__(self):
        self.ns = 1_700_000_000_000_000_000

    def time(self):
        return 1_700_000_000.0

    def time_ns(self):
        self.ns += 1
        return self.ns

    def __getattr__(self, name):
        return getattr(time, name)


def _ops(side, op, monkeypatch):
    epb, _, fmod, _, lmod = SIDES[side]
    clock = _Clock()
    monkeypatch.setattr(fmod, "time", clock)
    monkeypatch.setattr(lmod, "time", clock)
    deleted = []
    f = fmod.Filer(SIDES[side][1]("memory"), delete_chunks_fn=deleted.extend)
    out = []

    def ch(fid, offset, size, mtime):
        return _chunk(side, fid, offset, size, mtime)
    try:
        if op == "parents_and_listing":
            f.create_entry("/a/b/c", _entry(side, "file.txt",
                                            content=b"hello"))
            out += [_ser([f.find_entry(p)]) for p in
                    ("/a", "/a/b/c", "/a/b/c/file.txt")]
            out.append(_ser(f.list_directory("/a/b")))
        elif op == "delete_recursive":
            e = epb.Entry(name="data.bin")
            e.chunks.append(ch("7,abc", 0, 10, 1))
            f.create_entry("/dir/sub", e)
            with pytest.raises(IsADirectoryError):
                f.delete_entry("/dir", "sub")
            f.delete_entry("/", "dir", is_recursive=True)
            f.drain_deletions()
            out += [list(deleted), f.find_entry("/dir")]
        elif op == "update_shadowed":
            e = epb.Entry(name="f")
            e.chunks.append(ch("1,old", 0, 10, 1))
            f.create_entry("/d", e)
            e2 = epb.Entry(name="f")
            e2.chunks.append(ch("2,new", 0, 10, 2))
            f.update_entry("/d", e2)
            f.append_chunks("/d", "f", [ch("3,app", 10, 5, 3)])
            f.drain_deletions()
            out += [list(deleted), _ser([f.find_entry("/d/f")])]
        elif op == "rename":
            f.create_entry("/old/sub", _entry(side, "f1", content=b"x"))
            f.rename_entry("/", "old", "/", "new")
            out += [f.find_entry("/old"), _ser([f.find_entry("/new/sub/f1")]),
                    _ser(f.list_directory("/new"))]
        elif op == "meta_log":
            f.create_entry("/logs", _entry(side, "before", content=b"1"))
            stop = threading.Event()
            sub = f.meta_log.subscribe(0, "/logs", stop_event=stop)
            f.create_entry("/logs", _entry(side, "after", content=b"2"))
            f.delete_entry("/logs", "before")
            seen = []
            for ev in sub:
                seen.append(ev)
                if not ev.event_notification.new_entry.name:
                    stop.set()
                    break
            assert all(a.ts_ns < b.ts_ns for a, b in zip(seen, seen[1:]))
            out.append(_ser(seen))
        elif op == "buckets_and_paths":
            out += [f.bucket_collection("/buckets/photos/2024/x.jpg"),
                    f.bucket_collection("/notbuckets/x"),
                    fmod.split_path("/"), fmod.split_path("/a"),
                    fmod.split_path("/a/b/c"), fmod.join_path("/a", "b")]
        else:  # hardlink
            hid = b"x" * 17
            for name in ("a", "b"):
                e = epb.Entry(name=name, hard_link_id=hid,
                              hard_link_counter=2)
                e.chunks.append(ch("1,old", 0, 10, 1))
                f.create_entry("/hl", e)
            e2 = epb.Entry(name="a", hard_link_id=hid, hard_link_counter=2)
            e2.chunks.append(ch("2,new", 0, 10, 2))
            f.update_entry("/hl", e2)
            f.drain_deletions()
            out += [list(deleted), _ser([f.find_entry("/hl/b")])]
            f.delete_entry("/hl", "a")
            f.drain_deletions()
            out.append(list(deleted))
            f.delete_entry("/hl", "b")
            f.drain_deletions()
            out.append(list(deleted))
    finally:
        f.close()
    return out


@pytest.mark.parametrize("op", ["parents_and_listing", "delete_recursive",
                                "update_shadowed", "rename", "meta_log",
                                "buckets_and_paths", "hardlink"])
def test_filer_operations_are_the_references(monkeypatch, op):
    got = _ops("port", op, monkeypatch)
    want = _ops("ref", op, monkeypatch)
    assert got == want
    if op == "hardlink":
        assert got[0] == ["1,old"] and got[-1] == ["1,old", "2,new"]


def test_filer_close_joins_its_deletion_worker():
    f = filer_mod.Filer(make_store("memory"))
    assert f._deleter.name == "filer-deleter" and f._deleter.is_alive()
    f.close()
    assert not f._deleter.is_alive()


# -- clusters: the same requests to a port and a reference filer -------------


def _http(method, url, data=None, headers=None):
    req = urllib.request.Request(url, data=data, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _wait(cond, what, timeout=15.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return
        time.sleep(0.1)
    raise AssertionError(what)


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    from seaweedfs_tpu.filer.server import FilerServer as RefFiler
    from seaweedfs_tpu.master.server import MasterServer as RefMaster
    from seaweedfs_tpu.volume.server import VolumeServer as RefVolumeServer
    from seaweedfs_tpu_torch.filer.server import FilerServer
    from seaweedfs_tpu_torch.master.server import MasterServer
    from seaweedfs_tpu_torch.volume.server import VolumeServer

    out, started = {}, []
    try:
        for side, M, V, F, kw in (
                ("port", MasterServer, VolumeServer, FilerServer,
                 {"codec_name": "cpu"}),
                ("ref", RefMaster, RefVolumeServer, RefFiler, {})):
            m = M(ip="127.0.0.1", port=free_port(), volume_size_limit_mb=64)
            m.start()
            started.append(m)
            for i in range(2):
                v = V(directories=[str(tmp_path_factory.mktemp(
                          f"{side}fvol{i}"))],
                      master_addresses=[f"127.0.0.1:{m.grpc_port}"],
                      ip="127.0.0.1", port=free_port(), pulse_seconds=0.5,
                      **kw)
                v.start()
                started.append(v)
            _wait(lambda: len(m.topo.nodes) == 2, f"{side} heartbeats")
            f = F(masters=[f"127.0.0.1:{m.grpc_port}"], ip="127.0.0.1",
                  port=free_port(), store="sqlite",
                  store_path=str(tmp_path_factory.mktemp(f"{side}db")
                                 / "filer.db"), max_mb=1)
            f.start()
            started.append(f)
            out[side] = f
        yield out
    finally:
        for s in reversed(started):
            s.stop()


PAYLOAD = np.random.default_rng(11).integers(
    0, 256, 2_621_440, dtype=np.uint8).tobytes()  # 2.5 chunks at 1 MB


@pytest.mark.parametrize("side", ["port", "ref"])
def test_filer_write_read_multichunk(clusters, side):
    """The port's and the reference's filer serve the same bodies for the
    same PUT: whole, and ranges across each chunk boundary."""
    f = clusters[side]
    base = f"http://127.0.0.1:{f.port}"
    code, body = _http("PUT", f"{base}/docs/big.bin", PAYLOAD)
    assert code == 201, body
    assert len(f.filer.find_entry("/docs/big.bin").chunks) == 3
    for other in ("port", "ref"):
        ob = f"http://127.0.0.1:{clusters[other].port}"
        if other != side:
            _http("PUT", f"{ob}/docs/big.bin", PAYLOAD)
        code, got = _http("GET", f"{ob}/docs/big.bin")
        assert code == 200 and got == PAYLOAD
        for lo, hi in ((1048000, 1049000), (2097000, 2098000),
                       (0, 10), (2621000, 2621439)):
            req = urllib.request.Request(
                f"{ob}/docs/big.bin", headers={"Range": f"bytes={lo}-{hi}"})
            with urllib.request.urlopen(req, timeout=15) as r:
                assert r.status == 206 and r.read() == PAYLOAD[lo:hi + 1]


def test_filer_list_directory_and_delete(clusters):
    answers = {}
    for side, f in clusters.items():
        base = f"http://127.0.0.1:{f.port}"
        for name in ["a.txt", "b.txt", "c.txt"]:
            assert _http("PUT", f"{base}/listdir/{name}", b"x")[0] == 201
        first = json.loads(_http("GET", f"{base}/listdir/?limit=2")[1])
        rest = json.loads(_http("GET",
                                f"{base}/listdir/?lastFileName=b.txt")[1])
        code, _ = _http("PUT", f"{base}/del/zap.bin", b"deletable" * 1000)
        entry = f.filer.find_entry("/del/zap.bin")
        urls = f.master_client.lookup_file_id(entry.chunks[0].file_id)
        assert _http("DELETE", f"{base}/del/zap.bin")[0] == 204
        f.filer.drain_deletions()
        _wait(lambda: _http("GET", urls[0])[0] == 404, "blob deleted")
        answers[side] = (
            [e["FullPath"] for e in first["Entries"]],
            first["ShouldDisplayLoadMore"],
            [e["FullPath"] for e in rest["Entries"]],
            f.filer.find_entry("/del/zap.bin"))
    assert answers["port"] == answers["ref"] == (
        ["/listdir/a.txt", "/listdir/b.txt"], True, ["/listdir/c.txt"],
        None)


@pytest.mark.parametrize("stub_side", ["port", "ref"])
def test_filer_grpc_surface(clusters, stub_side):
    """The same rpcs through one package's stub to both filers give the
    same answers."""
    spb, srpc = {"port": (pb, rpc), "ref": (ref_pb, ref_rpc)}[stub_side]
    answers = {}
    for side, f in clusters.items():
        stub = srpc.filer_stub(f"127.0.0.1:{f.grpc_port}", timeout=15)
        d = f"/grpc_{stub_side}"
        req = spb.CreateEntryRequest(directory=d)
        req.entry.name = "hello.txt"
        req.entry.content = b"inline content"
        req.entry.attributes.mtime = 1_700_000_000
        out = [stub.CreateEntry(req).error]
        out.append(stub.LookupDirectoryEntry(spb.LookupDirectoryEntryRequest(
            directory=d, name="hello.txt")).entry.SerializeToString())
        out.append([r.entry.name for r in stub.ListEntries(
            spb.ListEntriesRequest(directory=d))])
        stub.AtomicRenameEntry(spb.AtomicRenameEntryRequest(
            old_directory=d, old_name="hello.txt",
            new_directory=d + "2", new_name="renamed.txt"))
        out += [f.filer.find_entry(d + "2/renamed.txt").content,
                f.filer.find_entry(d + "/hello.txt")]
        stub.KvPut(spb.KvPutRequest(key=b"k1", value=b"v1"))
        out.append(stub.KvGet(spb.KvGetRequest(key=b"k1")).value)
        a = stub.AssignVolume(spb.AssignVolumeRequest(count=1))
        out.append((a.error, bool(a.file_id)))
        conf = stub.GetFilerConfiguration(
            spb.GetFilerConfigurationRequest())
        out.append((conf.dir_buckets, conf.max_mb))
        answers[side] = out
    assert answers["port"] == answers["ref"]
    assert answers["port"][-1] == ("/buckets", 1)


@pytest.mark.parametrize("stub_side", ["port", "ref"])
def test_filer_subscribe_metadata_grpc(clusters, stub_side):
    spb, srpc = {"port": (pb, rpc), "ref": (ref_pb, ref_rpc)}[stub_side]
    f = clusters["port"]
    stub = srpc.filer_stub(f"127.0.0.1:{f.grpc_port}")
    seen, ready, done = [], threading.Event(), threading.Event()
    prefix = f"/sub_{stub_side}"

    def consume():
        call = stub.SubscribeMetadata(spb.SubscribeMetadataRequest(
            client_name="test", path_prefix=prefix,
            since_ns=time.time_ns()))
        ready.set()
        for ev in call:
            seen.append(ev)
            if ev.event_notification.new_entry.name == "notify.txt":
                done.set()
                call.cancel()
                return

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    assert ready.wait(10)
    time.sleep(0.3)
    assert _http("PUT", f"http://127.0.0.1:{f.port}{prefix}/notify.txt",
                 b"event!")[0] == 201
    assert done.wait(10), "no metadata event received"
    t.join(10)
    assert seen[-1].directory == prefix


def _chunk_read_retries(side) -> float:
    """The filer's chunk reads that failed over (retry_total, type filer)."""
    if side == "port":
        from seaweedfs_tpu_torch.stats.metrics import RETRY_COUNTER
    else:
        from seaweedfs_tpu.stats.metrics import RETRY_COUNTER
    return sum(c.value for k, c in list(RETRY_COUNTER._children.items())
               if k[:2] == ("filer", "chunk_read"))


@pytest.mark.parametrize("side", ["port", "ref"])
def test_keepconnected_drops_encoded_sources_from_the_vid_map(clusters,
                                                              side):
    """After ec.encode of a file's volumes, the master's KeepConnected
    deltas drop each source from the filer's vid map, and no delta names
    the shard holders; the next read of the file asks the master afresh
    (LookupVolume answers the holders) and fails over nowhere.  The same
    in both packages."""
    from seaweedfs_tpu.pb import master_pb2 as ref_pb_master
    from seaweedfs_tpu_torch.pb import master_pb2 as pb_master

    if side == "port":
        from seaweedfs_tpu_torch.shell.commands import CommandEnv, run_command
    else:
        from seaweedfs_tpu.shell.commands import CommandEnv, run_command
    f = clusters[side]
    base = f"http://127.0.0.1:{f.port}"
    path = "/buckets/vidmap/enc.bin"
    assert _http("PUT", base + path, PAYLOAD)[0] == 201
    vids = sorted({int(c.file_id.split(",")[0])
                   for c in f.filer.find_entry(path).chunks})
    vm = f.master_client.vid_map
    # the volumes' growth reached the vid map by the same stream
    _wait(lambda: all(len(vm.lookup(v)) == 1 for v in vids),
          "the grown volumes in the vid map")
    env = CommandEnv(master_grpc=f.masters[0])
    for v in vids:
        run_command(env, f"ec.encode -volumeId={v} -codec=cpu")
    _wait(lambda: not any(vm.lookup(v) for v in vids),
          "the sources left the vid map", timeout=20.0)
    r0 = _chunk_read_retries(side)
    assert _http("GET", base + path) == (200, PAYLOAD)
    assert _chunk_read_retries(side) == r0
    # the fresh lookups cached the master's answer: the shard holders
    mpb = (pb_master if side == "port" else ref_pb_master)
    for v in vids:
        answer = env.master().LookupVolume(mpb.LookupVolumeRequest(
            volume_or_file_ids=[str(v)])).volume_id_locations[0].locations
        assert {loc.url for loc in vm.lookup(v)} == {
            loc.url for loc in answer} != set()


def test_filer_stop_joins_its_threads(tmp_path):
    """A port filer started against a port master: stop() leaves none of
    the threads it started (the reference's notify drain and master
    client are daemons left running)."""
    from seaweedfs_tpu_torch.filer.server import FilerServer
    from seaweedfs_tpu_torch.master.server import MasterServer

    before = set(threading.enumerate())
    m = MasterServer(ip="127.0.0.1", port=free_port())
    m.start()
    f = FilerServer(masters=[f"127.0.0.1:{m.grpc_port}"], ip="127.0.0.1",
                    port=free_port(), store="leveldb2",
                    store_path=str(tmp_path / "ldb2"))
    f.start()
    _wait(lambda: m.grpc_port and any(
        t.name.startswith("masterclient-filer") for t in
        threading.enumerate()), "the master client's loop")
    req = pb.CreateEntryRequest(directory="/t")
    req.entry.name = "x.txt"
    req.entry.content = b"inline"
    assert not rpc.filer_stub(f"127.0.0.1:{f.grpc_port}",
                              timeout=10).CreateEntry(req).error
    assert _http("GET", f"http://127.0.0.1:{f.port}/t/x.txt") == \
        (200, b"inline")
    f.stop()
    m.stop()
    time.sleep(0.2)
    left = [t.name for t in set(threading.enumerate()) - before
            if t.is_alive() and t.name.startswith(
                ("filer", "masterclient", "httpd", "http-conn"))]
    assert not left, left


@pytest.mark.parametrize("kwargs", [{"peers": ["127.0.0.1:1"]},
                                    {"cluster_id": 3},
                                    {"geo_peers": ["127.0.0.1:1"]},
                                    {"notification": object()}])
def test_left_out_planes_name_the_roadmap(kwargs):
    from seaweedfs_tpu_torch.filer.server import FilerServer

    with pytest.raises(ValueError, match="ROADMAP A-7"):
        FilerServer(masters=["127.0.0.1:1"], store="memory", **kwargs)


def test_cipher_round_trip_and_opaque_volume_bytes(tmp_path_factory):
    pytest.importorskip("cryptography")
    from seaweedfs_tpu.util import cipher as ref_cipher
    from seaweedfs_tpu_torch.filer.server import FilerServer
    from seaweedfs_tpu_torch.master.server import MasterServer
    from seaweedfs_tpu_torch.s3api.filer_client import FilerClient
    from seaweedfs_tpu_torch.util import cipher
    from seaweedfs_tpu_torch.volume.server import VolumeServer

    key = cipher.gen_cipher_key()
    sealed = cipher.encrypt(b"both ways" * 50, key)
    assert ref_cipher.decrypt(sealed, key) == b"both ways" * 50
    assert cipher.decrypt(ref_cipher.encrypt(b"back", key), key) == b"back"
    master = MasterServer(ip="127.0.0.1", port=free_port(),
                          volume_size_limit_mb=64)
    master.start()
    vdir = tmp_path_factory.mktemp("ciphervol")
    vs = VolumeServer([str(vdir)], [f"127.0.0.1:{master.grpc_port}"],
                      ip="127.0.0.1", port=free_port(), pulse_seconds=0.5,
                      codec_name="cpu", max_volume_count=100)
    vs.start()
    _wait(lambda: len(master.topo.nodes) == 1, "heartbeat")
    filer = FilerServer(masters=[f"127.0.0.1:{master.grpc_port}"],
                        ip="127.0.0.1", port=free_port(), store="memory",
                        max_mb=1, cipher=True)
    filer.start()
    try:
        client = FilerClient(f"127.0.0.1:{filer.port}")
        secret = b"TOP-SECRET-" * 400
        client.put_object("/sec/plan.txt", secret)
        code, _, body = client.get_object("/sec/plan.txt")
        assert code == 200 and body == secret
        code, _, body = client.get_object("/sec/plan.txt",
                                          range_header="bytes=4-13")
        assert code == 206 and body == secret[4:14]
        e = client.find_entry("/sec", "plan.txt")
        assert e.chunks and e.chunks[0].cipher_key
        raw = b"".join(p.read_bytes() for p in vdir.glob("*.dat"))
        assert raw and b"TOP-SECRET-" not in raw
    finally:
        filer.stop()
        vs.stop()
        master.stop()
