"""File ids: "<volume_id>,<key_hex><cookie_hex8>" (reference: needle/file_id.go)
— the port's copy of seaweedfs_tpu/storage/file_id.py.

The key is minimal-length hex (no leading zeros); the cookie is always the
last 8 hex chars.  "3,01637037d6" -> vid 3, key 0x01, cookie 0x637037d6.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class FileId:
    volume_id: int
    key: int
    cookie: int

    def __str__(self) -> str:
        return f"{self.volume_id},{self.key:x}{self.cookie:08x}"

    @classmethod
    def parse(cls, fid: str) -> "FileId":
        fid = fid.strip()
        if "," not in fid:
            raise ValueError(f"bad file id {fid!r}")
        vid_str, key_hash = fid.split(",", 1)
        # tolerate a trailing "_<count>" chunk suffix and file extension
        if "." in key_hash:
            key_hash = key_hash.split(".", 1)[0]
        if "_" in key_hash:
            key_hash = key_hash.split("_", 1)[0]
        if len(key_hash) <= 8:
            raise ValueError(f"file id {fid!r} too short for key+cookie")
        return cls(
            volume_id=int(vid_str),
            key=int(key_hash[:-8], 16),
            cookie=int(key_hash[-8:], 16),
        )


def parse_volume_or_file_id(s: str) -> int:
    """Accept '3' or '3,01637037d6' and return the volume id."""
    return int(s.split(",", 1)[0])
