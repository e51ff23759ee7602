"""File-key sequencers (reference: weed/sequence/ — memory, etcd, snowflake).

The memory sequencer is the default; the snowflake variant gives collision-
free ids across multiple masters without coordination.

The port's copy of seaweedfs_tpu/master/sequence.py, without the `etcd`
sequencer: it leases ranges through util/etcd.py's client, which comes with
the filer's stand-ins (ROADMAP A-7).  Asking for it raises; it never falls
back to `memory`, whose ids would collide across masters.
"""

from __future__ import annotations

import threading
import time


class MemorySequencer:
    def __init__(self, start: int = 1):
        self._counter = max(start, 1)
        self._lock = threading.Lock()

    def next_file_id(self, count: int = 1) -> int:
        with self._lock:
            start = self._counter
            self._counter += count
            return start

    def set_max(self, seen_value: int) -> None:
        # reference bumps when counter <= seenValue: a heartbeat reporting
        # max_file_key equal to the current counter must still advance it,
        # or the next assign would reuse a live needle id
        with self._lock:
            if seen_value >= self._counter:
                self._counter = seen_value + 1

    def peek(self) -> int:
        with self._lock:
            return self._counter


class SnowflakeSequencer:
    """41-bit ms timestamp | 10-bit node | 12-bit sequence."""

    EPOCH_MS = 1_600_000_000_000

    def __init__(self, node_id: int = 0):
        self.node_id = node_id & 0x3FF
        self._lock = threading.Lock()
        self._last_ms = 0
        self._seq = 0

    def next_file_id(self, count: int = 1) -> int:
        if not 1 <= count <= 1 << 12:
            # a range can never exceed the 12-bit sequence space, or ids
            # would carry into the node-id bits and collide across masters
            raise ValueError(f"snowflake range {count} exceeds 4096")
        with self._lock:
            now = int(time.time() * 1000) - self.EPOCH_MS
            if now < self._last_ms:
                now = self._last_ms  # keep monotonic under clock skew
            if now == self._last_ms:
                first = self._seq + 1
                if first + count - 1 >= 1 << 12:
                    # sequence exhausted: advance to the next logical ms.
                    # _last_ms is monotonic (clamp above), so this ms can
                    # never be re-entered at seq 0 even if the wall clock
                    # later catches up — no duplicate ids, no lock-held spin.
                    now += 1
                    first = 0
            else:
                first = 0
            self._seq = first + count - 1
            self._last_ms = now
            return (now << 22) | (self.node_id << 12) | first

    def set_max(self, seen_value: int) -> None:
        pass  # timestamps make collisions impossible


def make_sequencer(kind: str = "memory", node_id: int = 0,
                   etcd_endpoint: str = "127.0.0.1:2379"):
    if kind == "memory":
        return MemorySequencer()
    if kind == "snowflake":
        return SnowflakeSequencer(node_id)
    if kind == "etcd":
        raise ValueError(
            "sequencer 'etcd' is not ported yet: it needs util/etcd.py "
            "(ROADMAP A-7); use 'memory' or 'snowflake'")
    raise ValueError(f"unknown sequencer {kind!r}")
