"""Client utilities: incremental volume backup, upload/download,
filer.cat / filer.copy.

The port's copy of seaweedfs_tpu/tools/backup.py.

Reference: weed/command/backup.go (incremental volume mirror via the tail
rpcs), upload.go:51, download.go:32, filer_cat.go:54, filer_copy.go:65.

Divergence from the reference's backup: when the remote has compacted
past the local copy (compaction revision ahead, or remote tail shorter
than the local .dat), the local volume is re-fetched from scratch instead
of locally compacting first — simpler, and correct for a mirror whose
authority is always the remote.
"""

from __future__ import annotations

import json
import os
import secrets
import urllib.parse
import urllib.request

from ..pb import master_pb2, volume_server_pb2 as vspb
from ..pb import rpc as rpclib
from ..storage.needle import Needle
from ..storage.super_block import SuperBlock
from ..storage.volume import Volume

from ..util.http_util import grpc_address as _grpc_addr


def _lookup_volume(master_grpc: str, vid: int) -> str:
    """-> the first location's public url for a volume id."""
    resp = rpclib.master_stub(master_grpc, timeout=30).LookupVolume(
        master_pb2.LookupVolumeRequest(volume_or_file_ids=[str(vid)]))
    locs = resp.volume_id_locations
    if not locs or not locs[0].locations:
        raise LookupError(f"volume {vid} has no locations")
    return locs[0].locations[0].url


def backup_volume(master: str, vid: int, directory: str,
                  collection: str = "") -> dict:
    """Incrementally mirror one volume into `directory` (backup.go).

    Returns {"appended": n, "full_resync": bool}.
    """
    master_grpc = _grpc_addr(master)
    vs_url = _lookup_volume(master_grpc, vid)
    vs_grpc = _grpc_addr(vs_url)
    stub = rpclib.volume_server_stub(vs_grpc, timeout=600)
    stats = stub.VolumeSyncStatus(
        vspb.VolumeSyncStatusRequest(volume_id=vid))

    os.makedirs(directory, exist_ok=True)
    base = os.path.join(
        directory, f"{collection}_{vid}" if collection else str(vid))
    full_resync = False
    if os.path.exists(base + ".dat"):
        vol = Volume(directory, collection, vid)
        local_rev = vol.super_block.compaction_revision
        local_size = vol.content_size
        if local_rev != stats.compact_revision or \
                local_size > stats.tail_offset:
            # the remote compacted (or shrank): this mirror's bytes are
            # no longer a prefix of the remote — start over
            vol.close()
            for ext in (".dat", ".idx"):
                if os.path.exists(base + ext):
                    os.remove(base + ext)
            full_resync = True
            vol = None
        else:
            vol.flush()
    else:
        vol = None
    if vol is None:
        sb = SuperBlock(compaction_revision=stats.compact_revision)
        vol = Volume(directory, collection, vid, super_block=sb)

    since_ns = _last_append_ns(vol)
    appended = 0
    stream = stub.VolumeTailSender(vspb.VolumeTailSenderRequest(
        volume_id=vid, since_ns=since_ns, idle_timeout_seconds=1))
    for resp in stream:
        if resp.is_last_chunk:
            break
        if not resp.needle_header:
            continue
        n = Needle.parse_header(bytes(resp.needle_header))
        full = Needle.from_bytes(
            bytes(resp.needle_header) + bytes(resp.needle_body),
            vol.version, verify=False)
        if n.size > 0:
            vol.append_needle(full)
        else:
            vol.delete_needle(n.id, at_ns=full.append_at_ns)
        appended += 1
    vol.close()
    return {"appended": appended, "full_resync": full_resync}


def _last_append_ns(vol: Volume) -> int:
    from .offline import tail_watermark_ns

    vol.flush()
    return tail_watermark_ns(vol.file_name() + ".dat")


# -- one-shot upload / download ---------------------------------------------


def upload_files(master: str, paths: list[str], collection: str = "",
                 replication: str = "", ttl: str = "") -> list[dict]:
    """`weed upload` (upload.go:51): assign a fid per file, POST the
    bytes to the assigned volume server, report fid+url per file."""
    results = []
    for path in paths:
        with open(path, "rb") as f:
            data = f.read()
        qs = urllib.parse.urlencode({
            "collection": collection, "replication": replication,
            "ttl": ttl})
        with urllib.request.urlopen(
                f"http://{master}/dir/assign?{qs}", timeout=30) as r:
            a = json.loads(r.read())
        if "error" in a and a["error"]:
            raise RuntimeError(a["error"])
        name = os.path.basename(path)
        # random boundary: fixed tokens can collide with binary payloads
        boundary = "----swfs" + secrets.token_hex(16)
        safe_name = name.replace('"', "%22").replace("\r", "").replace("\n", "")
        body = (
            f"--{boundary}\r\nContent-Disposition: form-data; "
            f'name="file"; filename="{safe_name}"\r\n'
            f"Content-Type: application/octet-stream\r\n\r\n"
        ).encode() + data + f"\r\n--{boundary}--\r\n".encode()
        req = urllib.request.Request(
            f"http://{a['url']}/{a['fid']}", data=body, method="POST",
            headers={"Content-Type":
                     f"multipart/form-data; boundary={boundary}",
                     **({"Authorization": f"BEARER {a['auth']}"}
                        if a.get("auth") else {})})
        with urllib.request.urlopen(req, timeout=120) as r:
            up = json.loads(r.read() or b"{}")
        results.append({"fileName": name, "fid": a["fid"],
                        "url": f"{a['url']}/{a['fid']}",
                        "size": up.get("size", len(data))})
    return results


def download_files(master: str, fids: list[str], directory: str = ".") -> list[str]:
    """`weed download` (download.go:32): resolve each fid via the master
    and save the blob under its stored filename (fallback: the fid)."""
    out = []
    for fid in fids:
        vid = fid.partition(",")[0]
        with urllib.request.urlopen(
                f"http://{master}/dir/lookup?volumeId={vid}",
                timeout=30) as r:
            locations = json.loads(r.read())["locations"]
        url = locations[0]["url"]
        req = urllib.request.Request(f"http://{url}/{fid}")
        with urllib.request.urlopen(req, timeout=120) as r:
            data = r.read()
            cd = r.headers.get("Content-Disposition", "")
        name = fid.replace(",", "_")
        if "filename=" in cd:
            # basename() — a hostile server must not steer the write
            # outside the target directory via ../ or an absolute path
            name = os.path.basename(
                cd.split("filename=")[-1].strip('" ')) or name
        path = os.path.join(directory, name)
        with open(path, "wb") as f:
            f.write(data)
        out.append(path)
    return out


# -- filer.cat / filer.copy ---------------------------------------------------


def filer_cat(filer: str, path: str) -> bytes:
    """filer_cat.go:54 — read one filer file's bytes."""
    from ..s3api.filer_client import FilerClient

    status, _, body = FilerClient(filer).get_object(path)
    if status != 200:
        raise FileNotFoundError(f"{path}: HTTP {status}")
    return body


def filer_copy(filer: str, sources: list[str], dest_dir: str) -> list[str]:
    """filer_copy.go:65 — copy local files/directories into the filer
    namespace under dest_dir; returns the created filer paths."""
    from ..s3api.filer_client import FilerClient

    client = FilerClient(filer)
    created = []

    def put_file(local: str, remote: str) -> None:
        size = os.path.getsize(local)
        with open(local, "rb") as f:
            client.put_object_stream(remote, f, size)
        created.append(remote)

    dest_dir = "/" + dest_dir.strip("/")
    for src in sources:
        if os.path.isdir(src):
            root_name = os.path.basename(os.path.normpath(src))
            for dirpath, _dirs, files in os.walk(src):
                rel = os.path.relpath(dirpath, src)
                for fn in files:
                    remote = "/".join(
                        p for p in (dest_dir, root_name,
                                    "" if rel == "." else rel, fn) if p)
                    put_file(os.path.join(dirpath, fn), remote)
        else:
            put_file(src, f"{dest_dir}/{os.path.basename(src)}")
    return created
