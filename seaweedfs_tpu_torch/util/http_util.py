"""Shared HTTP plumbing for the http.server-based servers.

The port's copy of the part of seaweedfs_tpu/util/http_util.py that the
volume server's replica fan-out and operation/upload.py use:
`trace_headers` and `netloc`.

Reference analogue: weed/util/http_util.go (request helpers shared by
every server).
"""

from __future__ import annotations


def trace_headers(headers: dict | None = None) -> dict:
    """Copy of `headers` with the active W3C `traceparent` injected.

    The one helper every outgoing HTTP request in the framework routes
    through, so a client write yields a connected trace across
    filer -> master -> volume -> replication hops."""
    from ..telemetry import trace

    out = dict(headers or {})
    trace.inject_headers(out)
    return out


def netloc(url: str) -> str:
    """host:port of a URL (or of a bare host:port string) — the breaker /
    location-cache key every failover path shares."""
    import urllib.parse

    if "//" not in url:
        return url.split("/", 1)[0]
    return urllib.parse.urlsplit(url).netloc
