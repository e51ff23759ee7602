"""The port's protobuf messages (seaweedfs_tpu_torch/pb) against the
reference's generated `*_pb2` classes: the embedded descriptors are the
reference's bytes; every message, with every field set, serializes to the
same bytes on both sides and each side parses the other's; and the port
registers nothing in protobuf's default pool, whichever package a process
imports first."""

import os
import subprocess
import sys

import pytest
from google.protobuf import descriptor as D
from google.protobuf import descriptor_pool

from seaweedfs_tpu.pb import filer_pb2 as ref_filer
from seaweedfs_tpu.pb import master_pb2 as ref_master
from seaweedfs_tpu.pb import volume_info_pb2 as ref_info
from seaweedfs_tpu.pb import volume_server_pb2 as ref_vs
from seaweedfs_tpu_torch import pb
from seaweedfs_tpu_torch.pb import descriptors
from seaweedfs_tpu_torch.pb import filer_pb2, master_pb2, volume_info_pb2
from seaweedfs_tpu_torch.pb import volume_server_pb2

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS = [(master_pb2, ref_master), (volume_server_pb2, ref_vs),
         (volume_info_pb2, ref_info), (filer_pb2, ref_filer)]
MESSAGES = sorted(
    (port_mod.__name__.rsplit(".", 1)[1], name)
    for port_mod, _ in PAIRS
    for name in pb.POOL.FindFileByName(
        port_mod.__name__.rsplit(".", 1)[1].replace("_pb2", ".proto")
    ).message_types_by_name)


def test_descriptors_are_the_reference_bytes():
    assert descriptors.MASTER_PROTO == ref_master.DESCRIPTOR.serialized_pb
    assert descriptors.VOLUME_SERVER_PROTO == \
        ref_vs.DESCRIPTOR.serialized_pb
    assert descriptors.VOLUME_INFO_PROTO == ref_info.DESCRIPTOR.serialized_pb
    assert descriptors.FILER_PROTO == ref_filer.DESCRIPTOR.serialized_pb


def _scalar(field, n: int):
    t = field.type
    if t in (D.FieldDescriptor.TYPE_INT32, D.FieldDescriptor.TYPE_SINT32,
             D.FieldDescriptor.TYPE_SFIXED32):
        return -(n * 7919 % 100000) - 1
    if t in (D.FieldDescriptor.TYPE_INT64, D.FieldDescriptor.TYPE_SINT64,
             D.FieldDescriptor.TYPE_SFIXED64):
        return -((n * 7919 % 2**30) << 32) - 1
    if t in (D.FieldDescriptor.TYPE_UINT32, D.FieldDescriptor.TYPE_FIXED32):
        return (n * 2654435761) & 0xFFFFFFFF or 1
    if t in (D.FieldDescriptor.TYPE_UINT64, D.FieldDescriptor.TYPE_FIXED64):
        return (n * 0x9E3779B97F4A7C15) & (2**64 - 1) or 1
    if t == D.FieldDescriptor.TYPE_BOOL:
        return True
    if t == D.FieldDescriptor.TYPE_FLOAT:
        return 1.5 + n
    if t == D.FieldDescriptor.TYPE_DOUBLE:
        return 0.1 * n + 2.25
    if t == D.FieldDescriptor.TYPE_STRING:
        return f"s{n}-é"
    if t == D.FieldDescriptor.TYPE_BYTES:
        return bytes([n & 0xFF, 0, 255]) * 2
    if t == D.FieldDescriptor.TYPE_ENUM:
        values = [v.number for v in field.enum_type.values]
        return values[-1]
    raise AssertionError(f"unhandled field type {t}")


def _fill(msg, depth: int = 0, seed: int = 1):
    """Set every field of `msg` (two entries for repeated and map fields,
    nested messages three levels deep) from `seed`, the same way for any
    class with this descriptor: only its names and numbers matter."""
    done_oneofs = set()
    for f in msg.DESCRIPTOR.fields:
        n = seed * 31 + f.number
        if f.containing_oneof is not None:
            if f.containing_oneof.name in done_oneofs:
                continue
            done_oneofs.add(f.containing_oneof.name)
        if f.message_type is not None and f.message_type.GetOptions().map_entry:
            kf, vf = f.message_type.fields_by_name["key"], \
                f.message_type.fields_by_name["value"]
            container = getattr(msg, f.name)
            for i in range(2):
                key = _scalar(kf, n + i)
                if vf.message_type is not None:
                    if depth < 3:
                        _fill(container[key], depth + 1, n + i)
                else:
                    container[key] = _scalar(vf, n + i)
            continue
        repeated = f.is_repeated
        if f.message_type is not None:
            if depth >= 3:
                continue
            if repeated:
                for i in range(2):
                    _fill(getattr(msg, f.name).add(), depth + 1, n + i)
            else:
                _fill(getattr(msg, f.name), depth + 1, n)
        elif repeated:
            getattr(msg, f.name).extend([_scalar(f, n), _scalar(f, n + 1)])
        else:
            setattr(msg, f.name, _scalar(f, n))
    return msg


@pytest.mark.parametrize("module,name", MESSAGES,
                         ids=[f"{m}.{n}" for m, n in MESSAGES])
def test_message_bytes_match_reference(module, name):
    port_mod = {p.__name__.rsplit(".", 1)[1]: p for p, _ in PAIRS}[module]
    ref_mod = dict(PAIRS)[port_mod]
    port_cls, ref_cls = getattr(port_mod, name), getattr(ref_mod, name)
    assert port_cls.DESCRIPTOR.file.pool is pb.POOL
    assert port_cls.DESCRIPTOR.full_name == ref_cls.DESCRIPTOR.full_name
    mine = _fill(port_cls()).SerializeToString(deterministic=True)
    theirs = _fill(ref_cls()).SerializeToString(deterministic=True)
    assert mine == theirs
    assert mine or not port_cls.DESCRIPTOR.fields  # every field set
    assert ref_cls.FromString(mine).SerializeToString(
        deterministic=True) == mine
    assert port_cls.FromString(theirs).SerializeToString(
        deterministic=True) == theirs
    assert port_cls.FromString(theirs) == _fill(port_cls())


_NAMES = [f"{fd.package}.{n}" for fd in (
    pb.POOL.FindFileByName("master.proto"),
    pb.POOL.FindFileByName("volume_server.proto"),
    pb.POOL.FindFileByName("volume_info.proto"),
    pb.POOL.FindFileByName("filer.proto"))
    for n in fd.message_types_by_name]

_CHILD = r"""
import json, sys
from google.protobuf import descriptor_pool
names = json.loads(sys.argv[1])
order = sys.argv[2]
FILES = ("master.proto", "volume_server.proto", "volume_info.proto",
         "filer.proto")

def default_view():
    pool = descriptor_pool.Default()
    files, msgs = {}, 0
    for f in FILES:
        try:
            files[f] = pool.FindFileByName(f).serialized_pb.hex()
        except KeyError:
            files[f] = None
    for n in names:
        try:
            pool.FindMessageTypeByName(n)
            msgs += 1
        except KeyError:
            pass
    return {"files": files, "messages": msgs}

def port():
    from seaweedfs_tpu_torch.pb import master_pb2, rpc  # noqa: F401
    from seaweedfs_tpu_torch.pb import volume_info_pb2  # noqa: F401
    from seaweedfs_tpu_torch.volume import server  # noqa: F401
    from seaweedfs_tpu_torch.filer import server as filer  # noqa: F401
    return master_pb2.Heartbeat(ip="x").SerializeToString().hex()

def ref():
    from seaweedfs_tpu.pb import master_pb2, rpc  # noqa: F401
    from seaweedfs_tpu.pb import volume_info_pb2  # noqa: F401
    return master_pb2.Heartbeat(ip="x").SerializeToString().hex()

out = {}
for step in order.split(","):
    out[step] = (port if step == "port" else ref)()
    out[step + "_view"] = default_view()
print(json.dumps(out))
"""


def _child(order: str) -> dict:
    import json

    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, json.dumps(_NAMES), order],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("order", ["port,ref", "ref,port"])
def test_default_pool_is_the_reference_alone(order):
    """In a fresh process, importing the port (its messages, rpc layer and
    volume server and filer) before or after the reference leaves
    protobuf's default pool exactly as the reference alone makes it: the
    port alone adds none of the four files and none of their messages."""
    alone = _child("ref")["ref_view"]
    both = _child(order)
    assert alone["messages"] == len(_NAMES)
    assert both[order.split(",")[-1] + "_view"] == alone
    assert both["port"] == both["ref"]  # the same bytes on the wire
    if order == "port,ref":
        assert both["port_view"] == {
            "files": {f: None for f in alone["files"]}, "messages": 0}
    assert descriptor_pool.Default() is not pb.POOL
