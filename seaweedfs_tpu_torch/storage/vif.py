"""`.vif` sidecar: the volume's VolumeInfo (version, tier files, replication,
.dat size) — the port's counterpart of seaweedfs_tpu/storage/vif.py.

The reference writes protobuf-JSON text (json_format.MessageToJson of
volume_info.proto's VolumeInfo) and falls back to binary protobuf when the
text does not parse.  The port reads and writes the same bytes without
generated protobuf code: a generated module registers `volume_info.proto`
in protobuf's default descriptor pool, and a second copy of it in a process
that also imports the reference would collide.  So the text is read and
written with `json` (camelCase keys, 64-bit integers as strings, default
values left out, two-space indent, as MessageToJson writes them), and the
binary form with a small wire-format decoder of VolumeInfo's fields:

    message RemoteFile {
      string backend_type = 1; string backend_id = 2; string key = 3;
      int64 offset = 4; uint64 file_size = 5; uint64 modified_time = 6;
      string extension = 7; }
    message VolumeInfo {
      repeated RemoteFile files = 1; uint32 version = 2;
      string replication = 3; uint64 dat_file_size = 4; }
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

# (python name, JSON name, kind) in field-number order; kind picks the
# JSON form: "s" string, "i32" number, "i64" string of a 64-bit integer
_REMOTE_FIELDS = (
    ("backend_type", "backendType", "s"),
    ("backend_id", "backendId", "s"),
    ("key", "key", "s"),
    ("offset", "offset", "i64"),
    ("file_size", "fileSize", "i64"),
    ("modified_time", "modifiedTime", "i64"),
    ("extension", "extension", "s"),
)
_INFO_FIELDS = (
    ("version", "version", "i32"),
    ("replication", "replication", "s"),
    ("dat_file_size", "datFileSize", "i64"),
)


@dataclass
class RemoteFile:
    backend_type: str = ""
    backend_id: str = ""
    key: str = ""
    offset: int = 0
    file_size: int = 0
    modified_time: int = 0
    extension: str = ""


@dataclass
class VolumeInfo:
    files: list = field(default_factory=list)  # of RemoteFile
    version: int = 0
    replication: str = ""
    dat_file_size: int = 0


def _to_json_obj(obj, spec) -> dict:
    out = {}
    for name, jname, kind in spec:
        v = getattr(obj, name)
        if not v:  # proto3: default values are left out
            continue
        out[jname] = str(int(v)) if kind == "i64" else v
    return out


def _from_json_obj(cls, d: dict, spec):
    obj = cls()
    for name, jname, kind in spec:
        v = d.get(jname, d.get(name))
        if v is None:
            continue
        setattr(obj, name, str(v) if kind == "s" else int(v))
    return obj


def save_volume_info(path: str, version: int, replication: str = "",
                     dat_file_size: int = 0,
                     remote_files: "list[dict] | None" = None) -> None:
    """Write the .vif as the reference does.  ``dat_file_size`` is the
    logical .dat size: an EC volume with no local shard recovers its
    interval geometry from it.  ``remote_files`` are RemoteFile fields as
    dicts (tier placement)."""
    info = VolumeInfo(version=version, replication=replication,
                      dat_file_size=dat_file_size,
                      files=[RemoteFile(**rf) for rf in remote_files or ()])
    obj = {}
    if info.files:
        obj["files"] = [_to_json_obj(rf, _REMOTE_FIELDS) for rf in info.files]
    obj.update(_to_json_obj(info, _INFO_FIELDS))
    with open(path, "w") as f:
        f.write(json.dumps(obj, indent=2))


def load_volume_info(path: str) -> "VolumeInfo | None":
    """The .vif at `path`, or None when it is missing or empty.  Raises
    ValueError when it is neither VolumeInfo JSON nor binary protobuf."""
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        raw = f.read()
    if not raw:
        return None
    try:
        d = json.loads(raw.decode("utf-8"))
    except (json.JSONDecodeError, UnicodeDecodeError):
        d = None
    if isinstance(d, dict):
        info = _from_json_obj(VolumeInfo, d, _INFO_FIELDS)
        info.files = [_from_json_obj(RemoteFile, rf, _REMOTE_FIELDS)
                      for rf in d.get("files", ())]
        return info
    return _decode_volume_info(raw)


# -- protobuf wire format -----------------------------------------------------


def _varint(buf: bytes, at: int) -> tuple[int, int]:
    shift = value = 0
    while True:
        if at >= len(buf):
            raise ValueError("truncated varint in .vif")
        b = buf[at]
        at += 1
        value |= (b & 0x7F) << shift
        if not b & 0x80:
            return value, at
        shift += 7
        if shift > 63:
            raise ValueError("varint too long in .vif")


def _fields(buf: bytes):
    """Yield (field number, wire type, value) of one message; values of
    length-delimited fields are bytes."""
    at = 0
    while at < len(buf):
        tag, at = _varint(buf, at)
        num, wire = tag >> 3, tag & 7
        if wire == 0:
            value, at = _varint(buf, at)
        elif wire == 1:
            value, at = int.from_bytes(buf[at:at + 8], "little"), at + 8
        elif wire == 2:
            n, at = _varint(buf, at)
            value, at = bytes(buf[at:at + n]), at + n
        elif wire == 5:
            value, at = int.from_bytes(buf[at:at + 4], "little"), at + 4
        else:
            raise ValueError(f"unsupported wire type {wire} in .vif")
        if at > len(buf):
            raise ValueError("truncated field in .vif")
        yield num, wire, value


def _decode_message(cls, buf: bytes, spec, nested=None):
    obj = cls()
    names = {i + 1 + (1 if nested else 0): f for i, f in enumerate(spec)}
    for num, wire, value in _fields(buf):
        if nested and num == 1 and wire == 2:
            obj.files.append(_decode_message(RemoteFile, value,
                                             _REMOTE_FIELDS))
            continue
        f = names.get(num)
        if f is None:
            continue  # unknown field: skipped, as protobuf does
        name, _jname, kind = f
        if kind == "s" and wire == 2:
            setattr(obj, name, value.decode("utf-8"))
        elif kind != "s" and wire == 0:
            if name == "offset" and value >= 1 << 63:  # int64, two's complement
                value -= 1 << 64
            setattr(obj, name, value)
        else:
            raise ValueError(f"field {name} has wire type {wire} in .vif")
    return obj


def _decode_volume_info(raw: bytes) -> VolumeInfo:
    return _decode_message(VolumeInfo, raw, _INFO_FIELDS, nested=True)
