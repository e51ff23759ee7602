"""Per-path filer configuration (storage rules by location prefix).

The port's copy of seaweedfs_tpu/filer/filer_conf.py.

Reference: weed/filer/filer_conf.go — rules stored INSIDE the filer at
/etc/seaweedfs/filer.conf; each rule assigns collection/replication/ttl
to writes under a path prefix, longest prefix wins.  The reference keeps
a ptrie and jsonpb text; here rules live in a JSON document and matching
is a linear longest-prefix scan (rule counts are tiny).
"""

from __future__ import annotations

import json
import time

CONF_DIR = "/etc/seaweedfs"
CONF_NAME = "filer.conf"
CONF_PATH = f"{CONF_DIR}/{CONF_NAME}"


class PathConf(dict):
    """A rule: {locationPrefix, collection, replication, ttl}."""

    @property
    def location_prefix(self) -> str:
        return self.get("locationPrefix", "")


class FilerConf:
    def __init__(self, rules: list[dict] | None = None):
        self.rules = [PathConf(r) for r in (rules or [])
                      if r.get("locationPrefix")]

    @classmethod
    def from_bytes(cls, raw: bytes) -> "FilerConf":
        try:
            doc = json.loads(raw) if raw else {}
        except ValueError:
            doc = {}
        if not isinstance(doc, dict):
            doc = {}
        rules = doc.get("locations", [])
        if not isinstance(rules, list):
            rules = []
        return cls([r for r in rules if isinstance(r, dict)])

    def to_bytes(self) -> bytes:
        return json.dumps({"locations": self.rules}, indent=2).encode()

    def upsert(self, rule: dict) -> None:
        self.delete(rule.get("locationPrefix", ""))
        self.rules.append(PathConf(rule))

    def delete(self, location_prefix: str) -> None:
        self.rules = [r for r in self.rules
                      if r.location_prefix != location_prefix]

    def match(self, path: str) -> PathConf | None:
        """Longest matching locationPrefix rule for a write path."""
        best = None
        for r in self.rules:
            p = r.location_prefix
            if path.startswith(p) and \
                    (best is None or len(p) > len(best.location_prefix)):
                best = r
        return best


class FilerConfHolder:
    """Lazily (re)loads the conf through a `read_fn(path) -> bytes|None`
    with a small TTL — rule edits through fs.configure take effect within
    `refresh_seconds` on every filer write path."""

    def __init__(self, read_fn, refresh_seconds: float = 2.0):
        self.read_fn = read_fn
        self.refresh_seconds = refresh_seconds
        self._conf = FilerConf()
        self._loaded_at = 0.0

    def get(self) -> FilerConf:
        now = time.monotonic()
        if now - self._loaded_at > self.refresh_seconds:
            try:
                raw = self.read_fn(CONF_PATH) or b""
            except Exception:
                raw = b""
            self._conf = FilerConf.from_bytes(raw)
            self._loaded_at = now
        return self._conf

    def match(self, path: str) -> PathConf | None:
        return self.get().match(path)
