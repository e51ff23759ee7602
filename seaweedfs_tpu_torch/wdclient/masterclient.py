"""MasterClient: long-lived client keeping a streamed vid->location cache.

The port's copy of seaweedfs_tpu/wdclient/masterclient.py.

Reference: weed/wdclient/masterclient.go:38-154 — a reconnecting
KeepConnected stream against the current leader feeds VolumeLocation deltas
into the vidMap; lookups that miss the cache fall back to a LookupVolume
rpc.  Clients chase the leader hint carried on each VolumeLocation.

Difference from the reference, on purpose: `stop()` cancels the live
KeepConnected call and joins the loop's thread.
"""

from __future__ import annotations

import threading
import time

import grpc

from ..pb import master_pb2
from ..pb import rpc as rpclib
from ..util import failsafe
from .vid_map import Location, VidMap

# how often a registered client (filer) refreshes its stats snapshot on
# the KeepConnected stream — the master's federation fallback data
STATS_INTERVAL_S = 10.0

# typed NOT_LEADER rejection detail emitted by the master's grpc layer —
# the suffix is the leader's grpc address, so a client can re-resolve in
# one hop instead of rotating through the seed list on backoff
NOT_LEADER_PREFIX = "not the leader; leader is "


def parse_leader_hint(err: Exception) -> str:
    """leader grpc address out of a NOT_LEADER grpc error, or ''."""
    details = getattr(err, "details", None)
    detail = details() if callable(details) else str(err)
    if detail and NOT_LEADER_PREFIX in detail:
        hint = detail.split(NOT_LEADER_PREFIX, 1)[1].strip()
        # "None" = the deposed master does not know the new leader yet
        if hint and hint != "None":
            return hint
    return ""


class MasterClient:
    def __init__(self, name: str, master_grpc_addresses: list[str],
                 grpc_port: int = 0, client_type: str = "",
                 http_address: str = ""):
        self.name = name
        self.masters = list(master_grpc_addresses)
        self.grpc_port = grpc_port
        # federation registration: a non-empty client_type announces this
        # process (e.g. a filer) to the master's observability plane with
        # a scrapeable HTTP address + periodic stats snapshots
        self.client_type = client_type
        self.http_address = http_address
        self.vid_map = VidMap()
        self.current_master = ""
        self._leader_hint = ""
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._call = None  # the live KeepConnected call, cancelled on stop
        self._connected = threading.Event()

    # -- lifecycle --------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._keep_connected_loop, daemon=True,
            name=f"masterclient-{self.client_type or 'client'}")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        call = self._call
        if call is not None:
            call.cancel()
        if self._thread is not None:
            self._thread.join(timeout=10.0)

    def wait_until_connected(self, timeout: float = 10.0) -> bool:
        return self._connected.wait(timeout)

    # -- the KeepConnected loop ------------------------------------------

    def _keep_connected_loop(self) -> None:
        i = 0
        backoff = failsafe.Backoff(failsafe.RetryPolicy(
            max_attempts=1 << 30, base_delay=0.25, max_delay=5.0))
        while not self._stop.is_set():
            if self._leader_hint and self._leader_hint in self.masters:
                master = self._leader_hint
                self._leader_hint = ""
            else:
                master = self.masters[i % len(self.masters)]
                i += 1
            try:
                self._stream_from(master)
            except grpc.RpcError as e:
                hint = parse_leader_hint(e)
                if hint and hint in self.masters:
                    self._leader_hint = hint
            if self._connected.is_set():
                backoff.reset()  # the stream was live; reconnect fast
            self._connected.clear()
            if self._leader_hint:
                # deposed leader handed us its successor: reconnect NOW
                # — a fixed backoff here leaves lookups pointed at a
                # follower for a whole rotation cycle after failover
                continue
            self._stop.wait(backoff.next())

    def _registration(self) -> master_pb2.KeepConnectedRequest:
        req = master_pb2.KeepConnectedRequest(
            name=self.name, grpc_port=self.grpc_port,
            client_type=self.client_type, http_address=self.http_address,
        )
        if self.client_type:
            from ..stats.metrics import REGISTRY

            req.stats.captured_at_ms = int(time.time() * 1000)
            for sname, value in REGISTRY.snapshot_samples():
                req.stats.samples.add(name=sname, value=value)
        return req

    def _stream_from(self, master: str) -> None:
        stub = rpclib.master_stub(master)

        def requests():
            yield self._registration()
            # keep the stream open until stopped; registered clients
            # refresh their stats snapshot so the master's federation
            # fallback stays at most STATS_INTERVAL_S stale
            last_stats = time.monotonic()
            while not self._stop.wait(1.0):
                if (self.client_type
                        and time.monotonic() - last_stats
                        >= STATS_INTERVAL_S):
                    last_stats = time.monotonic()
                    yield self._registration()

        self._call = stub.KeepConnected(requests())
        if self._stop.is_set():  # stop() ran before the call existed
            self._call.cancel()
        for loc in self._call:
            if self._stop.is_set():
                return
            self.current_master = master
            self._connected.set()
            self._apply(loc)
            if loc.leader:
                # leader hints carry the HTTP address; grpc = port + 10000
                host, port = loc.leader.rsplit(":", 1)
                leader_grpc = f"{host}:{int(port) + 10000}"
                if leader_grpc != master and leader_grpc in self.masters:
                    # leader moved: break the stream and reconnect there
                    self._leader_hint = leader_grpc
                    return

    def _apply(self, loc: master_pb2.VolumeLocation) -> None:
        location = Location(url=loc.url, public_url=loc.public_url or loc.url)
        for vid in loc.new_vids:
            self.vid_map.add_location(vid, location)
        for vid in loc.deleted_vids:
            self.vid_map.delete_location(vid, loc.url)

    # -- lookups ----------------------------------------------------------

    def lookup_volume(self, vid: int, refresh: bool = False) -> list[Location]:
        """Locations serving vid; `refresh=True` bypasses the cache (used
        after a cached location turned out dead — the volume may have
        moved or been EC-encoded, and the master's answer reflects that).

        A LookupVolume failure rotates to the next master under the
        shared failover policy instead of failing the request."""
        if not refresh:
            locs = self.vid_map.lookup(vid)
            if locs:
                return locs

        def ask(master: str) -> master_pb2.LookupVolumeResponse:
            req = master_pb2.LookupVolumeRequest(
                volume_or_file_ids=[str(vid)])
            try:
                return rpclib.master_stub(
                    master, timeout=10).LookupVolume(req)
            except grpc.RpcError as e:
                hint = parse_leader_hint(e)
                if hint and hint in self.masters and hint != master:
                    # follower named the leader: one extra hop beats
                    # burning a failover round on the rest of the seeds
                    self.current_master = hint
                    self._leader_hint = hint
                    return rpclib.master_stub(
                        hint, timeout=10).LookupVolume(req)
                raise

        try:
            resp = failsafe.call_with_failover(
                lambda _round: self._master_order(), ask,
                op="lookup_volume", retry_type="masterClient",
                policy=failsafe.RPC_POLICY, idempotent=True,
            )
        except (grpc.RpcError, failsafe.CircuitOpenError, OSError):
            # every master refused/errored: a stale cached answer (even
            # the one we bypassed) beats none at all
            return self.vid_map.lookup(vid)
        if refresh:
            self.vid_map.delete_volume(vid)
        for vl in resp.volume_id_locations:
            for l in vl.locations:
                self.vid_map.add_location(
                    vid, Location(l.url, l.public_url or l.url)
                )
        return self.vid_map.lookup(vid)

    def lookup_file_id(self, fid: str, refresh: bool = False) -> list[str]:
        """-> public urls serving this file id."""
        vid = int(fid.split(",", 1)[0])
        return [
            f"http://{l.public_url or l.url}/{fid}"
            for l in self.lookup_volume(vid, refresh=refresh)
        ]

    def invalidate_location(self, vid: int, url_or_netloc: str) -> None:
        """Evict one cached location of vid — called when a connection to
        that server was REFUSED (the process is gone; waiting out a TTL
        would keep routing reads into a dead peer)."""
        from ..util.http_util import netloc

        server = netloc(url_or_netloc)
        for loc in list(self.vid_map.lookup(vid)):
            if server in (loc.url, loc.public_url):
                self.vid_map.delete_location(vid, loc.url)

    def _master_order(self) -> list[str]:
        if self.current_master:
            rest = [m for m in self.masters if m != self.current_master]
            return [self.current_master, *rest]
        return list(self.masters)
