"""Volume/needle TTL: 2-byte (count, unit) encoding — the port's copy of
seaweedfs_tpu/storage/ttl.py.

Reference: weed/storage/needle/volume_ttl.go — units minute/hour/day/week/
month/year stored as bytes 1..6, empty as (0, 0).
"""

from __future__ import annotations

from dataclasses import dataclass

EMPTY, MINUTE, HOUR, DAY, WEEK, MONTH, YEAR = range(7)

_UNIT_BY_CHAR = {"m": MINUTE, "h": HOUR, "d": DAY, "w": WEEK, "M": MONTH, "y": YEAR}
_CHAR_BY_UNIT = {v: k for k, v in _UNIT_BY_CHAR.items()}
_MINUTES_BY_UNIT = {
    EMPTY: 0,
    MINUTE: 1,
    HOUR: 60,
    DAY: 60 * 24,
    WEEK: 60 * 24 * 7,
    MONTH: 60 * 24 * 30,
    YEAR: 60 * 24 * 365,
}


@dataclass(frozen=True)
class TTL:
    count: int = 0
    unit: int = EMPTY

    @classmethod
    def parse(cls, s: str) -> "TTL":
        """'3m', '4h', '5d', '6w', '7M', '8y'; bare digits mean minutes."""
        if not s:
            return cls()
        unit_ch = s[-1]
        if unit_ch.isdigit():
            count_str, unit = s, MINUTE
        else:
            count_str, unit = s[:-1], _UNIT_BY_CHAR.get(unit_ch, EMPTY)
        return cls(int(count_str), unit)

    @classmethod
    def from_bytes(cls, b: bytes) -> "TTL":
        if b[0] == 0 and b[1] == 0:
            return cls()
        return cls(b[0], b[1])

    @classmethod
    def from_uint32(cls, v: int) -> "TTL":
        return cls.from_bytes(bytes([(v >> 8) & 0xFF, v & 0xFF]))

    def to_bytes(self) -> bytes:
        return bytes([self.count & 0xFF, self.unit & 0xFF])

    def to_uint32(self) -> int:
        if self.count == 0:
            return 0
        return (self.count << 8) | self.unit

    def minutes(self) -> int:
        return self.count * _MINUTES_BY_UNIT.get(self.unit, 0)

    def seconds(self) -> int:
        return self.minutes() * 60

    def expired(self, modified_at_second: float,
                now: float | None = None) -> bool:
        """Volume-granularity expiry (the lifecycle controller's
        ttl_expire transition): a TTL volume whose last write is older
        than the TTL is expired wholesale, like the reference's TTL
        volume deletion."""
        if self.count == 0 or self.unit == EMPTY:
            return False
        if modified_at_second <= 0:
            return False  # never-written / unknown: do not expire
        import time as _time

        if now is None:
            now = _time.time()
        return now - modified_at_second > self.seconds()

    def __str__(self) -> str:
        if self.count == 0 or self.unit == EMPTY:
            return ""
        return f"{self.count}{_CHAR_BY_UNIT[self.unit]}"
