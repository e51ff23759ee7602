"""A data directory holding volumes and EC shards — the port's copy of
seaweedfs_tpu/storage/disk_location.py.

Reference: weed/storage/disk_location.go + disk_location_ec.go — scans for
`<collection>_<vid>.dat` / bare `<vid>.dat` volumes and `.ecNN`/`.ecx` shard
groups at startup.  EC volumes open on the location's codec, `cuda` by
default (the reference's default is its host codec `cpu`).
"""

from __future__ import annotations

import os
import re
import threading

from .disk_health import DiskHealth
from .ec.volume import EcVolume
from .super_block import SuperBlock
from .volume import Volume

_EC_RE = re.compile(r"\.ec[0-9][0-9]$")


def parse_volume_file_name(name: str) -> tuple[str, int]:
    """'c_12' -> ('c', 12); '12' -> ('', 12)."""
    if "_" in name:
        collection, vid = name.rsplit("_", 1)
        return collection, int(vid)
    return "", int(name)


def normalize_disk_type(s: str) -> str:
    """'' and 'hdd' are the same (default) type, as in the reference's
    types.ToDiskType (weed/storage/types/volume_disk_type.go)."""
    s = (s or "").strip().lower()
    return "" if s == "hdd" else s


def readable_disk_type(s: str) -> str:
    return normalize_disk_type(s) or "hdd"


class DiskLocation:
    def __init__(self, directory: str, max_volume_count: int = 7,
                 codec_name: str = "cuda", disk_type: str = ""):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_volume_count = max_volume_count
        self.codec_name = codec_name
        self.disk_type = normalize_disk_type(disk_type)
        self.volumes: dict[int, Volume] = {}
        self.ec_volumes: dict[int, EcVolume] = {}
        # disk-fault survival plane: one health state machine per data
        # directory; every volume's write errors feed it
        self.health = DiskHealth(self.directory)
        self._lock = threading.RLock()
        self.load_existing_volumes()

    # -- discovery --------------------------------------------------------

    def load_existing_volumes(self) -> None:
        with self._lock:
            for fname in sorted(os.listdir(self.directory)):
                if fname.endswith(".dat"):
                    base = fname[: -len(".dat")]
                    try:
                        collection, vid = parse_volume_file_name(base)
                    except ValueError:
                        continue
                    if vid not in self.volumes:
                        try:
                            v = Volume(self.directory, collection, vid)
                            v.disk_type = self.disk_type
                            v.health = self.health
                            self.volumes[vid] = v
                        except Exception:
                            continue
            self.load_all_ec_shards()

    def load_all_ec_shards(self) -> None:
        """Group .ecNN files by volume; instantiate when the .ecx exists."""
        seen: set[int] = set()
        for fname in sorted(os.listdir(self.directory)):
            if not _EC_RE.search(fname):
                continue
            base = fname[:-5]
            try:
                collection, vid = parse_volume_file_name(base)
            except ValueError:
                continue
            if vid in seen or vid in self.ec_volumes:
                continue
            base_path = os.path.join(self.directory, base)
            if os.path.exists(base_path + ".ecx"):
                self.ec_volumes[vid] = EcVolume(
                    base_path, vid, codec_name=self.codec_name
                )
                self.ec_volumes[vid].collection = collection
                seen.add(vid)

    # -- volume lifecycle -------------------------------------------------

    def add_volume(self, vid: int, collection: str,
                   super_block: SuperBlock | None = None) -> Volume:
        with self._lock:
            if vid in self.volumes:
                return self.volumes[vid]
            v = Volume(self.directory, collection, vid, super_block=super_block)
            v.disk_type = self.disk_type
            v.health = self.health
            self.volumes[vid] = v
            return v

    def delete_volume(self, vid: int) -> bool:
        with self._lock:
            v = self.volumes.pop(vid, None)
            if v is None:
                return False
            base = v.file_name()
            v.close()
            for ext in (".dat", ".idx", ".vif", ".note"):
                try:
                    os.remove(base + ext)
                except FileNotFoundError:
                    pass
            return True

    def unmount_volume(self, vid: int) -> bool:
        with self._lock:
            v = self.volumes.pop(vid, None)
            if v is None:
                return False
            v.close()
            return True

    def base_name(self, vid: int, collection: str = "") -> str:
        name = f"{collection}_{vid}" if collection else str(vid)
        return os.path.join(self.directory, name)

    def volume_count(self) -> int:
        return len(self.volumes)
