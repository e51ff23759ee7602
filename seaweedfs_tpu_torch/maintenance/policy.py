"""Declarative per-collection lifecycle policies — the port's copy of
seaweedfs_tpu/maintenance/policy.py.

One `LifecyclePolicy` names the thresholds for every transition the
controller can decide; a `PolicySet` maps collection names to policies
with a `"*"` default.  The JSON shape (policy file / `volume.lifecycle
-policy=` / the master's `-lifecyclePolicy`) is a dict of collection ->
field overrides:

    {
      "*":      {"seal_full_percent": 95, "vacuum_garbage_ratio": 0.3},
      "photos": {"ec_cooldown_seconds": 3600,
                 "tier_backend": "s3.cold", "tier_idle_seconds": 86400}
    }

Disabled-by-default transitions: EC encode (no cooldown configured),
tier (no backend configured), rebalance (skew 0).  Seal, vacuum and TTL
expiry default on — they only ever act on volumes whose own state
(fullness, garbage, expired TTL) already demands it.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, fields


@dataclass
class LifecyclePolicy:
    # seal: freeze a volume once it is this full (percent of the cluster
    # volume size limit); 0 disables.  seal_age_seconds additionally
    # seals quiet volumes older than this even if not full (0 = off).
    seal_full_percent: float = 95.0
    seal_age_seconds: float = 0.0
    # EC encode sealed volumes after this long with no writes; negative
    # disables (the cool-down gate from arXiv:1709.05365)
    ec_cooldown_seconds: float = -1.0
    ec_codec: str = ""  # "" = the volume server's default codec
    # tier the sealed .dat to this backend ("s3.cold") after this long
    # idle; "" disables.  keep_local_dat keeps the local copy too.
    tier_backend: str = ""
    tier_idle_seconds: float = 0.0
    keep_local_dat: bool = False
    # vacuum volumes whose garbage ratio exceeds this; 0 disables
    vacuum_garbage_ratio: float = 0.3
    # delete whole volumes whose TTL has expired (volume-granularity TTL,
    # the reference's TTL volume semantics)
    ttl_expire: bool = True
    # plan volume moves when max-min per-node volume counts exceeds this;
    # 0 disables
    rebalance_skew: int = 0

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "LifecyclePolicy":
        known = {f.name for f in fields(cls)}
        bad = set(d) - known
        if bad:
            raise ValueError(
                f"unknown lifecycle policy fields {sorted(bad)}; "
                f"known: {sorted(known)}")
        return cls(**d)


class PolicySet:
    """collection name -> LifecyclePolicy, with a '*' default."""

    def __init__(self, policies: dict[str, LifecyclePolicy] | None = None):
        self.policies = dict(policies or {})
        self.policies.setdefault("*", LifecyclePolicy())

    @classmethod
    def parse(cls, doc: "dict | str | None") -> "PolicySet":
        """From the JSON dict shape (or its serialized string)."""
        if doc is None:
            return cls()
        if isinstance(doc, str):
            doc = json.loads(doc)
        if not isinstance(doc, dict):
            raise ValueError("lifecycle policy must be a JSON object")
        out = {}
        for coll, overrides in doc.items():
            if not isinstance(overrides, dict):
                raise ValueError(
                    f"policy for collection {coll!r} must be an object")
            out[coll] = LifecyclePolicy.from_dict(overrides)
        return cls(out)

    def for_collection(self, collection: str) -> LifecyclePolicy:
        return self.policies.get(collection) or self.policies["*"]

    def to_dict(self) -> dict:
        return {c: p.to_dict() for c, p in sorted(self.policies.items())}

    def dumps(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)
