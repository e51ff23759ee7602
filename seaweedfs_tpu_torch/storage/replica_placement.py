"""Replica placement: the 'XYZ' digit policy byte — the port's copy of
seaweedfs_tpu/storage/replica_placement.py.

Reference: weed/storage/super_block/replica_placement.go — digit 0 is copies
in other data centers, digit 1 other racks, digit 2 same rack.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ReplicaPlacement:
    same_rack: int = 0
    diff_rack: int = 0
    diff_dc: int = 0

    @classmethod
    def parse(cls, s: str) -> "ReplicaPlacement":
        vals = [0, 0, 0]
        for i, ch in enumerate(s[:3]):
            d = ord(ch) - ord("0")
            if not 0 <= d <= 2:
                raise ValueError(f"unknown replication type {s!r}")
            vals[i] = d
        return cls(diff_dc=vals[0], diff_rack=vals[1], same_rack=vals[2])

    @classmethod
    def from_byte(cls, b: int) -> "ReplicaPlacement":
        return cls.parse(f"{b:03d}")

    def to_byte(self) -> int:
        return self.diff_dc * 100 + self.diff_rack * 10 + self.same_rack

    def copy_count(self) -> int:
        return self.diff_dc + self.diff_rack + self.same_rack + 1

    def __str__(self) -> str:
        return f"{self.diff_dc}{self.diff_rack}{self.same_rack}"
