"""Cluster load benchmark: concurrent write then read phases with latency
percentiles.

The port's copy of seaweedfs_tpu/tools/benchmark.py.

Reference: weed/command/benchmark.go:26-45 (defaults c=16, 1KB files) and
its stats harness (:155-284) — requests/sec, throughput, latency
distribution, and a per-second progress line.
"""

from __future__ import annotations

import random
import threading
import time
import urllib.request
from dataclasses import dataclass, field

from ..operation.assign import assign
from ..operation.upload import upload_data


@dataclass
class Stats:
    name: str
    latencies_ms: list = field(default_factory=list)
    bytes_total: int = 0
    failed: int = 0
    start: float = 0.0
    end: float = 0.0
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def record(self, dt_s: float, nbytes: int) -> None:
        with self._lock:
            self.latencies_ms.append(dt_s * 1000)
            self.bytes_total += nbytes

    def fail(self) -> None:
        with self._lock:
            self.failed += 1

    def report(self) -> str:
        lat = sorted(self.latencies_ms)
        n = len(lat)
        took = max(self.end - self.start, 1e-9)
        lines = [
            f"\n------------ {self.name} ----------",
            f"Completed requests:      {n}",
            f"Failed requests:         {self.failed}",
            f"Time taken:              {took:.3f} seconds",
            f"Requests per second:     {n / took:.2f}",
            f"Transfer rate:           {self.bytes_total / 1024 / took:.2f} KB/s",
        ]
        if n:
            avg = sum(lat) / n
            std = (sum((x - avg) ** 2 for x in lat) / n) ** 0.5
            lines += [
                f"Avg latency:             {avg:.2f} ms (std {std:.2f})",
                "Percentage of requests served within a time (ms):",
            ]
            for p in (50, 66, 75, 80, 90, 95, 98, 99, 100):
                i = min(n - 1, int(n * p / 100))
                lines.append(f"   {p:>3}%  {lat[i]:8.2f} ms")
        return "\n".join(lines)


def run_benchmark(
    master: str,
    num_files: int = 1024,
    file_size: int = 1024,
    concurrency: int = 16,
    do_read: bool = True,
    collection: str = "",
    replication: str = "",
) -> dict:
    """Run write (and optionally read) phases; prints the stats blocks and
    returns {'write': Stats, 'read': Stats|None}."""
    master_grpc = _grpc_addr(master)
    rng = random.Random(0)
    payload_base = bytes(rng.randrange(256) for _ in range(file_size))
    fids: list[str] = []
    fid_lock = threading.Lock()
    counter = iter(range(num_files))
    counter_lock = threading.Lock()

    write_stats = Stats("Write Benchmark")

    def write_worker():
        while True:
            with counter_lock:
                try:
                    i = next(counter)
                except StopIteration:
                    return
            try:
                t0 = time.perf_counter()
                a = assign(master_grpc, collection=collection,
                           replication=replication)
                payload = payload_base[:-4] + i.to_bytes(4, "big")
                upload_data(a.fid_url(), payload, filename=f"bench{i}.bin",
                            jwt=a.auth)
                write_stats.record(time.perf_counter() - t0, file_size)
                with fid_lock:
                    fids.append(a.fid)
            except Exception:
                write_stats.fail()

    write_stats.start = time.time()
    threads = [threading.Thread(target=write_worker) for _ in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    write_stats.end = time.time()
    print(write_stats.report())

    read_stats = None
    if do_read and fids:
        read_stats = Stats("Read Benchmark")
        read_counter = iter(range(len(fids)))

        def read_worker():
            while True:
                with counter_lock:
                    try:
                        i = next(read_counter)
                    except StopIteration:
                        return
                fid = fids[i]
                try:
                    t0 = time.perf_counter()
                    vid = fid.split(",", 1)[0]
                    with urllib.request.urlopen(
                        f"http://{master}/dir/lookup?volumeId={vid}", timeout=10
                    ) as r:
                        import json

                        loc = json.loads(r.read())["locations"][0]["publicUrl"]
                    with urllib.request.urlopen(
                        f"http://{loc}/{fid}", timeout=10
                    ) as r:
                        got = r.read()
                    read_stats.record(time.perf_counter() - t0, len(got))
                except Exception:
                    read_stats.fail()

        read_stats.start = time.time()
        threads = [threading.Thread(target=read_worker) for _ in range(concurrency)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        read_stats.end = time.time()
        print(read_stats.report())

    return {"write": write_stats, "read": read_stats}


def _grpc_addr(master: str) -> str:
    host, port = master.rsplit(":", 1)
    return f"{host}:{int(port) + 10000}"
