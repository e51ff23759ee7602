"""TOML configuration tier.

Reference: weed/util/config.go:20-48 — config files named <name>.toml are
discovered in the working directory, then ~/.seaweedfs/, then
/usr/local/etc/seaweedfs/, then /etc/seaweedfs/; flags stay the primary
knob and the TOML tier supplies the structured parts (security certs,
store backends, maintenance scripts).

Python's stdlib tomllib replaces viper; keys are accessed with the same
dotted-path convention ("grpc.ca", "jwt.signing.key") the reference uses.

The port's copy of seaweedfs_tpu/util/config.py.
"""

from __future__ import annotations

import os

try:  # stdlib on 3.11+; gated so 3.10 hosts still run (a missing TOML
    # parser only matters when a .toml file is actually present)
    import tomllib
except ImportError:  # pragma: no cover - environment-dependent
    try:
        import tomli as tomllib  # the 3.10 backport, if installed
    except ImportError:
        tomllib = None

SEARCH_PATHS = (
    ".",
    os.path.expanduser("~/.seaweedfs"),
    "/usr/local/etc/seaweedfs",
    "/etc/seaweedfs",
)


class Configuration:
    """A loaded TOML document with dotted-key access."""

    def __init__(self, data: dict | None = None, path: str = ""):
        self.data = data or {}
        self.path = path  # file it came from ("" = not found)

    @property
    def loaded(self) -> bool:
        return bool(self.path)

    def get(self, dotted_key: str, default=None):
        node = self.data
        for part in dotted_key.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def get_string(self, key: str, default: str = "") -> str:
        v = self.get(key, default)
        return v if isinstance(v, str) else default

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self.get(key, default)
        return v if isinstance(v, bool) else default

    def get_int(self, key: str, default: int = 0) -> int:
        v = self.get(key, default)
        return v if isinstance(v, int) and not isinstance(v, bool) else default

    def get_float(self, key: str, default: float = 0.0) -> float:
        v = self.get(key, default)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return float(v)
        return default

    def get_list(self, key: str, default: list | None = None) -> list:
        v = self.get(key)
        return v if isinstance(v, list) else (default or [])


def load_configuration(
    name: str, required: bool = False, search_paths=SEARCH_PATHS
) -> Configuration:
    """Find and parse <name>.toml along the search path."""
    for d in search_paths:
        path = os.path.join(d, f"{name}.toml")
        if os.path.isfile(path):
            if tomllib is None:
                raise RuntimeError(
                    f"found {path} but no TOML parser is available "
                    "(python < 3.11 without the tomli backport)")
            with open(path, "rb") as f:
                return Configuration(tomllib.load(f), path=path)
    if required:
        raise FileNotFoundError(
            f"{name}.toml not found in {', '.join(search_paths)}; generate "
            f"a default with: weed scaffold -config={name} -output=."
        )
    return Configuration()
