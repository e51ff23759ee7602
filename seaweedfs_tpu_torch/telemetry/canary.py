"""Synthetic canary plane: black-box probes that feed the SLO engine — the
port's copy of seaweedfs_tpu/telemetry/canary.py.  On a port volume
server on `cuda`, the ``ec_degraded`` probe's drop-shard read is a decode
on the card.  Port difference: `stop()` joins the probe thread
(``master-canary``); the reference leaves a daemon thread.

Passive metrics say a process is up; they cannot say it is serving the
right bytes at the right speed.  The canary prober (one per master,
probe bytes charged to the shared background-I/O bucket) continuously
runs end-to-end probes and emits the `seaweedfs_canary_*` SLIs the SLO
engine's availability and staleness specs judge — so "process up but
serving garbage or slow" pages:

* ``volume_rt``    — write/read/delete round trip against every volume
  server, byte identity checked (the write path, the read path and the
  delete tombstone per node, per tick);
* ``ec_degraded``  — a drop-shard read through an EC volume's
  reconstruct path via /debug/canary/ec (CRC-gated byte identity), so
  decode-path rot is found by a probe, not by the next real shard loss
  (arXiv:1709.05365's degraded-read tail is exactly the blind spot);
* ``metadata_rt``  — a routed PUT/GET/DELETE through the S3 gateway
  when one is configured, else straight through a registered filer
  (exercises fleet routing + the filer store);
* ``geo_sentinel`` — when the master has `-peerClusters`, a sentinel
  object written through the local filer and read back from a REMOTE
  cluster's filer; the observed payload age is the end-to-end geo lag
  (`seaweedfs_canary_staleness_seconds{probe="geo_sentinel"}`).

Every probe runs under `record_op("canary", probe)`, so its span lands
in the tracer and its latency histogram carries exemplar trace ids —
the availability alert's one-hop link to a stitched timeline.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time

from ..stats.metrics import (
    CANARY_PROBE_SECONDS,
    CANARY_PROBE_TOTAL,
    CANARY_STALENESS,
)
from ..util import connpool, glog
from .middleware import record_op

PAYLOAD_BYTES = int(os.environ.get("SEAWEEDFS_TPU_CANARY_PAYLOAD", "1024"))
TIMEOUT_S = float(os.environ.get("SEAWEEDFS_TPU_CANARY_TIMEOUT_S", "2.0"))

PROBES = ("volume_rt", "ec_degraded", "metadata_rt", "geo_sentinel")


class ProbeSkipped(Exception):
    """Probe target exists but holds nothing to judge (e.g. an empty EC
    volume) — counted `skipped`, never `error`."""


class CanaryProber:
    """Master-resident black-box prober.  `run_once()` is synchronous
    (tests drive it directly); `start()` runs it on `interval_s`."""

    def __init__(self, master, interval_s: float = 0.0,
                 s3_address: str = "", timeout_s: float = TIMEOUT_S):
        self.master = master
        self.interval_s = interval_s
        self.s3_address = s3_address.rstrip("/")
        self.timeout_s = timeout_s
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None
        self._rng = random.Random()
        self._tick = 0
        self._lock = threading.Lock()
        # probe -> {"result", "error", "targets": {target: detail}}
        self._results: dict[str, dict] = {}
        self._last_ok: dict[str, float] = {}
        self._byte_mismatches = 0
        # geo: newest sentinel timestamp observed ON the remote side
        self._geo_seen_ts = 0.0
        self._geo_first_write = 0.0

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        if self.interval_s <= 0 or self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="master-canary")
        self._thread.start()

    def stop(self) -> None:
        """Stop the loop and join it (a probe round in progress ends
        at its next pause or request timeout)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=60.0)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.run_once()
            except Exception as e:  # noqa: BLE001 — the prober must survive
                glog.warning("canary tick failed: %s", e)

    # -- probe plumbing ---------------------------------------------------

    def _charge(self, nbytes: int) -> None:
        """Probe traffic drains the same cluster background-I/O bucket
        as scrub and lifecycle jobs (the PR 9 shared budget) — canaries
        must never compete with clients for foreground bandwidth."""
        lc = getattr(self.master, "lifecycle", None)
        if lc is not None:
            lc.bucket.consume(nbytes, stop=self._stop)

    def _observe(self, probe: str, target: str, fn) -> bool:
        """Run one probe body under a span; count + time it; -> ok.

        One in-probe retry (fresh attempt after a short pause): real
        clients ride the failsafe retry layer, so "available" means
        available WITH a retry — a transient race (a volume sealed
        between topology snapshot and write, a holder cache gone stale
        after a shard move) is not an outage, while a dead node fails
        both attempts and still pages."""
        span = None
        err = ""
        skipped: "ProbeSkipped | None" = None
        try:
            with record_op("canary", probe, target=target) as sp:
                span = sp
                try:
                    fn()
                except ProbeSkipped as e:
                    # swallowed INSIDE the span: a skip is not an error
                    # status (it must not occupy the tracer's bounded
                    # important ring) and not a latency sample (a ~0s
                    # observation would drag the probe p50 toward zero)
                    skipped = e
                except Exception:  # noqa: BLE001 — retry once, fresh
                    if self._stop.wait(0.15):
                        raise
                    try:
                        fn()
                    except ProbeSkipped as e:
                        # the retry's fresh pick found nothing left to
                        # probe (volume sealed away mid-probe): still a
                        # skip, never an error
                        skipped = e
            result = "skipped" if skipped is not None else "ok"
            if skipped is not None:
                err = str(skipped)[:200]
        except Exception as e:  # noqa: BLE001 — a failed probe is data
            result = "error"
            err = f"{type(e).__name__}: {e}"[:200]
        CANARY_PROBE_TOTAL.labels(probe, result).inc()
        if span is not None and skipped is None:
            CANARY_PROBE_SECONDS.labels(probe).observe(
                span.duration, trace_id=span.trace_id)
        with self._lock:
            entry = self._results.setdefault(
                probe, {"targets": {}})
            entry.pop("skipped", None)
            entry["targets"][target or "-"] = {
                "result": result, "error": err,
                "at": round(time.time(), 3),
                "traceId": span.trace_id if span is not None else "",
            }
        return result == "ok"

    def _skip(self, probe: str, reason: str) -> None:
        CANARY_PROBE_TOTAL.labels(probe, "skipped").inc()
        with self._lock:
            self._results[probe] = {
                "targets": {}, "skipped": reason}

    def _prune_targets(self, probe: str, valid: set) -> None:
        """Drop retained per-target results whose target left the
        cluster — a dead node's last error must not read as a live
        failure forever."""
        with self._lock:
            entry = self._results.get(probe)
            if entry is None:
                return
            entry["targets"] = {
                k: v for k, v in entry["targets"].items() if k in valid}

    def _http(self, method: str, url: str, body: bytes = b"",
              headers: "dict | None" = None) -> bytes:
        with connpool.request(method, url, body=body or None,
                              headers=headers or {},
                              timeout=self.timeout_s) as r:
            data = r.read()
            if r.status >= 300:
                raise IOError(f"{method} {url} -> {r.status}")
            return data

    def _payload(self) -> bytes:
        return os.urandom(PAYLOAD_BYTES)

    # -- the probes -------------------------------------------------------

    def _volume_targets(self) -> list[tuple[str, int]]:
        """[(node_id, writable_vid)] — one writable volume per node."""
        out = []
        with self.master.topo.lock:
            for n in self.master.topo.nodes.values():
                vids = sorted(vid for vid, v in n.volumes.items()
                              if not v.read_only)
                if vids:
                    out.append((n.id, vids[self._tick % len(vids)]))
        return out

    def _pick_writable(self, node_id: str) -> "int | None":
        """Fresh writable volume id for ONE node — one short lock, no
        full-topology rescan per attempt."""
        with self.master.topo.lock:
            n = self.master.topo.nodes.get(node_id)
            if n is None:
                return None
            vids = sorted(vid for vid, v in n.volumes.items()
                          if not v.read_only)
        return vids[self._tick % len(vids)] if vids else None

    def probe_volume_rt(self) -> None:
        targets = self._volume_targets()
        if not targets:
            return self._skip("volume_rt", "no node with a writable volume")
        self._prune_targets("volume_rt", {n for n, _v in targets})
        for node_id, _vid in targets:

            def round_trip(node_id=node_id):
                # fresh pick per attempt: the retry must not re-POST to
                # a volume that was sealed/EC-encoded since the first try
                vid = self._pick_writable(node_id)
                if vid is None:
                    raise ProbeSkipped("no writable volume on node")
                payload = self._payload()
                key = self.master.sequencer.next_file_id(1)
                cookie = self._rng.randrange(0, 2 ** 32)
                fid = f"{vid},{key:x}{cookie:08x}"
                auth = self.master.sign_fid(fid)
                headers = {"Content-Type": "application/octet-stream"}
                if auth:
                    headers["Authorization"] = f"BEARER {auth}"
                url = f"http://{node_id}/{fid}"
                self._charge(2 * len(payload))
                self._http("POST", url, body=payload, headers=headers)
                try:
                    got = self._http("GET", url)
                    if got != payload:
                        with self._lock:
                            self._byte_mismatches += 1
                        raise IOError(
                            f"byte identity broken: wrote "
                            f"{len(payload)}B read {len(got)}B")
                finally:
                    # best-effort cleanup even when the read leg failed —
                    # canary objects must not accumulate
                    try:
                        self._http("DELETE", url, headers=headers)
                    except Exception:  # noqa: BLE001
                        pass

            self._observe("volume_rt", node_id, round_trip)

    def _ec_targets(self) -> list[tuple[str, int]]:
        out = []
        with self.master.topo.lock:
            for n in self.master.topo.nodes.values():
                for vid in sorted(n.ec_shards):
                    out.append((n.id, vid))
        return out

    def probe_ec_degraded(self) -> None:
        targets = self._ec_targets()
        if not targets:
            return self._skip("ec_degraded", "no EC volumes in topology")
        node_id, vid = targets[self._tick % len(targets)]

        def drop_shard_read():
            doc = json.loads(self._http(
                "GET", f"http://{node_id}/debug/canary/ec?volume={vid}"))
            if doc.get("empty"):
                raise ProbeSkipped("ec volume holds no live needle")
            if not doc.get("ok"):
                raise IOError(doc.get("error", "canary read failed"))

        self._prune_targets(
            "ec_degraded", {f"{n}/vol{v}" for n, v in targets})
        self._observe("ec_degraded", f"{node_id}/vol{vid}", drop_shard_read)

    def _filer_addresses(self) -> list[str]:
        out = []
        for _name, info in sorted(self.master.clients_snapshot().items()):
            if info.get("type") == "filer" and info.get("http_address"):
                out.append(info["http_address"])
        return out

    def probe_metadata_rt(self) -> None:
        payload = self._payload()
        self._prune_targets(
            "metadata_rt",
            {self.s3_address} if self.s3_address
            else set(self._filer_addresses()))
        if self.s3_address:
            bucket = "seaweedfs-canary"
            obj = f"{bucket}/probe-{self.master.port}"
            base = (self.s3_address if "://" in self.s3_address
                    else f"http://{self.s3_address}")
            self._charge(2 * len(payload))

            def s3_round_trip():
                # bucket create is idempotent on the filer-backed gateway
                try:
                    self._http("PUT", f"{base}/{bucket}")
                except Exception:  # noqa: BLE001 — may already exist
                    pass
                self._http("PUT", f"{base}/{obj}", body=payload)
                try:
                    got = self._http("GET", f"{base}/{obj}")
                    if got != payload:
                        with self._lock:
                            self._byte_mismatches += 1
                        raise IOError("s3 byte identity broken")
                finally:
                    try:
                        self._http("DELETE", f"{base}/{obj}")
                    except Exception:  # noqa: BLE001
                        pass

            self._observe("metadata_rt", self.s3_address, s3_round_trip)
            return
        filers = self._filer_addresses()
        if not filers:
            return self._skip(
                "metadata_rt", "no S3 gateway configured, no filer "
                               "registered")
        filer = filers[self._tick % len(filers)]
        path = f"/.canary/probe-{self.master.port}"
        self._charge(2 * len(payload))

        def filer_round_trip():
            self._http("PUT", f"http://{filer}{path}", body=payload)
            try:
                got = self._http("GET", f"http://{filer}{path}")
                if got != payload:
                    with self._lock:
                        self._byte_mismatches += 1
                    raise IOError("filer byte identity broken")
            finally:
                try:
                    self._http("DELETE", f"http://{filer}{path}")
                except Exception:  # noqa: BLE001
                    pass

        self._observe("metadata_rt", filer, filer_round_trip)

    SENTINEL_PATH = "/.canary/geo-sentinel"

    def probe_geo_sentinel(self) -> None:
        peers = getattr(self.master, "peer_clusters", None) or []
        if not peers:
            return self._skip("geo_sentinel", "no -peerClusters configured")
        filers = self._filer_addresses()
        if not filers:
            return self._skip("geo_sentinel", "no local filer registered")
        now = time.time()
        body = json.dumps({"ts": now, "from": f"{self.master.ip}:"
                                              f"{self.master.port}"}).encode()
        self._charge(len(body))
        try:
            self._http("PUT", f"http://{filers[0]}{self.SENTINEL_PATH}",
                       body=body)
            if self._geo_first_write == 0.0:
                self._geo_first_write = now
        except Exception as e:  # noqa: BLE001
            glog.warning("geo sentinel write failed: %s", e)

        def read_remote(peer):
            doc = json.loads(self._http(
                "GET", f"http://{peer}/cluster/status"))
            remote_filers = [
                f.get("httpAddress") for f in
                (doc.get("Filers") or {}).values() if f.get("httpAddress")]
            if not remote_filers:
                raise IOError(f"peer {peer} reports no filers")
            sent = json.loads(self._http(
                "GET",
                f"http://{remote_filers[0]}{self.SENTINEL_PATH}"))
            ts = float(sent["ts"])
            with self._lock:
                self._geo_seen_ts = max(self._geo_seen_ts, ts)

        for peer in peers:
            self._observe("geo_sentinel", peer,
                          lambda peer=peer: read_remote(peer))
        # staleness = age of the newest sentinel payload the remote side
        # served; before the first successful remote read it grows from
        # the first local write (replication never confirmed)
        anchor = self._geo_seen_ts or self._geo_first_write
        if anchor:
            CANARY_STALENESS.labels("geo_sentinel").set(
                max(0.0, time.time() - anchor))

    # -- tick + surfaces --------------------------------------------------

    def run_once(self) -> dict:
        """One full probe round; returns the status document."""
        self._tick += 1
        for probe, fn in (
            ("volume_rt", self.probe_volume_rt),
            ("ec_degraded", self.probe_ec_degraded),
            ("metadata_rt", self.probe_metadata_rt),
            ("geo_sentinel", self.probe_geo_sentinel),
        ):
            try:
                fn()
            except Exception as e:  # noqa: BLE001 — per-probe isolation
                glog.warning("canary probe %s crashed: %s", probe, e)
            self._refresh_staleness(probe)
        return self.status()

    def _refresh_staleness(self, probe: str) -> None:
        """seaweedfs_canary_staleness_seconds{probe}: seconds since the
        probe last FULLY succeeded (every target ok).  geo_sentinel owns
        its gauge (payload age) inside the probe."""
        if probe == "geo_sentinel":
            return
        with self._lock:
            entry = self._results.get(probe)
            if entry is None or entry.get("skipped"):
                return
            targets = entry.get("targets", {})
            # skipped targets are neutral: the probe is "fully ok" when
            # nothing it could reach errored
            all_ok = bool(targets) and all(
                t["result"] != "error" for t in targets.values())
            now = time.monotonic()
            self._last_ok.setdefault(f"{probe}:first", now)
            if all_ok:
                self._last_ok[probe] = now
            # before any success, staleness grows from the first attempt
            last = self._last_ok.get(probe,
                                     self._last_ok[f"{probe}:first"])
        CANARY_STALENESS.labels(probe).set(round(now - last, 3))

    def status(self) -> dict:
        with self._lock:
            # deep-copy per-target entries: the returned doc is read and
            # json-serialized by HTTP handler threads with no lock, and
            # a live inner dict mutating mid-iteration would 500 the
            # /cluster/alerts an operator is polling mid-incident
            probes = {
                k: {**{kk: vv for kk, vv in v.items() if kk != "targets"},
                    "targets": {t: dict(r)
                                for t, r in v.get("targets", {}).items()}}
                for k, v in self._results.items()
            }
            return {
                "interval_s": self.interval_s,
                "running": self._thread is not None,
                "tick": self._tick,
                "byteMismatches": self._byte_mismatches,
                "probes": probes,
            }
