"""Cluster metrics federation: merge per-node Prometheus expositions — the
port's copy of seaweedfs_tpu/telemetry/federation.py.

The master's /cluster/metrics scrapes every known node's /metrics over
the keep-alive pool (bounded per-node deadline, concurrent fan-out) and
re-serves one exposition with `instance="ip:port"` and `type="volume" |
"filer" | "master"` labels injected into every sample — the shape
Prometheus's own /federate endpoint produces, so one scrape config
covers a whole cluster.  Nodes a live scrape cannot reach fall back to
the compact gauge/counter snapshot their last heartbeat carried, marked
with `seaweedfs_federation_stale{instance} 1` and a snapshot-age sample
so dashboards can grey them out instead of silently flat-lining.

The merge is family-grouped (the text format requires all samples of a
family contiguous): each node's exposition is parsed into families +
samples, HELP/TYPE are deduplicated (first node wins; identical
codebase, so they agree), and samples append under their family with the
extra labels injected ahead of the node's own.
"""

from __future__ import annotations

from ..stats.metrics import REGISTRY, escape_label_value

# synthesized federation meta-families (rendered here, not registered in
# the process registry: they describe the scrape, not this process)
FED_UP = "seaweedfs_federation_up"
FED_STALE = "seaweedfs_federation_stale"
FED_AGE = "seaweedfs_federation_snapshot_age_seconds"
FED_SCRAPE_SECONDS = "seaweedfs_federation_scrape_seconds"

_META_FAMILIES = {
    FED_UP: ("gauge", "live federation scrape succeeded for this node"),
    FED_STALE: ("gauge",
                "serving a heartbeat snapshot because the live scrape "
                "failed"),
    FED_AGE: ("gauge", "age of the heartbeat snapshot being served"),
    FED_SCRAPE_SECONDS: ("gauge", "wall time of the live scrape"),
}


def inject_labels(sample_name: str, extra: dict) -> str:
    """`name{a="b"}` + {instance: i, type: t} -> `name{instance="i",...}`.

    Extra labels go FIRST so a node-side label can never mask them; the
    node's own label text is preserved verbatim (it is already escaped).
    """
    pairs = ",".join(
        f'{k}="{escape_label_value(v)}"' for k, v in extra.items())
    if not pairs:
        return sample_name
    brace = sample_name.find("{")
    if brace < 0:
        return f"{sample_name}{{{pairs}}}"
    inner = sample_name[brace + 1:-1]
    if inner:
        return f"{sample_name[:brace]}{{{pairs},{inner}}}"
    return f"{sample_name[:brace]}{{{pairs}}}"


def parse_exposition(text: str):
    """-> (families, samples): families[name] = (kind, help);
    samples = [(family, sample_name_with_labels, value_text)].

    A sample whose family has no TYPE line files under its own name with
    kind "untyped".  Histogram samples (`_bucket`/`_sum`/`_count`) file
    under their base family so regrouping keeps them contiguous."""
    families: dict[str, tuple[str, str]] = {}
    helps: dict[str, str] = {}
    samples: list[tuple[str, str, str]] = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# HELP "):
            name, _, help_ = line[len("# HELP "):].partition(" ")
            helps[name] = help_
            continue
        if line.startswith("# TYPE "):
            name, _, kind = line[len("# TYPE "):].partition(" ")
            families[name] = (kind.strip(), helps.get(name, ""))
            continue
        if line.startswith("#"):
            continue
        brace = line.find("{")
        if brace >= 0:
            close = line.rfind("}")
            if close < 0:
                continue  # malformed; drop rather than corrupt the merge
            name, sample_name = line[:brace], line[: close + 1]
            value = line[close + 1:].strip().split(" ")[0]
        else:
            space = line.find(" ")
            if space < 0:
                continue
            name = sample_name = line[:space]
            value = line[space + 1:].strip().split(" ")[0]
        family = _family_of(name, families)
        samples.append((family, sample_name, value))
    return families, samples


def _family_of(sample_name: str, families: dict) -> str:
    if sample_name in families:
        return sample_name
    for suffix in ("_bucket", "_sum", "_count"):
        if sample_name.endswith(suffix):
            base = sample_name[: -len(suffix)]
            if families.get(base, ("",))[0] == "histogram":
                return base
    return sample_name


class FederatedExposition:
    """Accumulates per-node expositions/snapshots into one rendering.

    `family_prefixes` (the /cluster/metrics ?family= filter) drops
    non-matching families at merge time; the federation meta-families
    (up/stale/age/scrape) always render, so a filtered scrape still
    shows which nodes answered."""

    def __init__(self, family_prefixes: "list[str] | None" = None):
        self._families: dict[str, tuple[str, str]] = dict(_META_FAMILIES)
        self._prefixes = family_prefixes
        # family -> [rendered sample line]; insertion order = output order
        self._samples: dict[str, list[str]] = {}

    def _wanted(self, family: str) -> bool:
        if self._prefixes is None or family in _META_FAMILIES:
            return True
        return any(family.startswith(p) for p in self._prefixes)

    def _add_sample(self, family: str, line: str) -> None:
        if not self._wanted(family):
            return
        self._samples.setdefault(family, []).append(line)

    def _meta(self, name: str, node: dict, value) -> None:
        labels = {"instance": node["instance"], "type": node["type"]}
        self._add_sample(name, f"{inject_labels(name, labels)} {value}")

    def add_live(self, node: dict, text: str, scrape_seconds: float) -> None:
        """One successfully scraped node: `node` has instance + type."""
        extra = {"instance": node["instance"], "type": node["type"]}
        families, samples = parse_exposition(text)
        for name, info in families.items():
            self._families.setdefault(name, info)
        for family, sample_name, value in samples:
            self._add_sample(
                family, f"{inject_labels(sample_name, extra)} {value}")
        self._meta(FED_UP, node, 1)
        self._meta(FED_STALE, node, 0)
        self._meta(FED_SCRAPE_SECONDS, node, round(scrape_seconds, 6))

    def add_snapshot(self, node: dict, samples, age_seconds: float) -> None:
        """One unreachable node, served from its heartbeat snapshot:
        `samples` = [(sample_name_with_labels, value)].  Family kinds
        come from this process's registry (same codebase => same
        families); unknown names render as untyped."""
        extra = {"instance": node["instance"], "type": node["type"]}
        for sample_name, value in samples:
            name = sample_name.partition("{")[0]
            family = name
            m = REGISTRY.family(name)
            if m is not None:
                family = m.name
                self._families.setdefault(family, (m.kind, m.help))
            else:
                self._families.setdefault(family, ("untyped", ""))
            self._add_sample(
                family, f"{inject_labels(sample_name, extra)} {value}")
        self._meta(FED_UP, node, 0)
        self._meta(FED_STALE, node, 1)
        self._meta(FED_AGE, node, round(age_seconds, 3))

    def add_down(self, node: dict) -> None:
        """Unreachable and no snapshot either — still visible as down."""
        self._meta(FED_UP, node, 0)
        self._meta(FED_STALE, node, 0)

    def render(self) -> str:
        out: list[str] = []
        for family, lines in self._samples.items():
            kind, help_ = self._families.get(family, ("untyped", ""))
            out.append(f"# HELP {family} {help_}")
            out.append(f"# TYPE {family} {kind}")
            out.extend(lines)
        return "\n".join(out) + "\n"
