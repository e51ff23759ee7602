"""Shared HTTP plumbing for the http.server-based servers.

The port's copy of the part of seaweedfs_tpu/util/http_util.py that the
volume server's replica fan-out uses: `trace_headers`.

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
