"""Minimal per-server HTML status pages.

The port's copy of seaweedfs_tpu/util/ui.py.

Reference: weed/server/*_ui/ — each process serves /ui/index.html with
its live status.  One shared renderer keeps every server's page
consistent; values come from the same dicts the JSON status endpoints
return.
"""

from __future__ import annotations

import html

_STYLE = """
body{font-family:system-ui,sans-serif;margin:2em;color:#222}
h1{font-size:1.3em} h2{font-size:1.05em;margin-top:1.4em}
table{border-collapse:collapse;margin-top:.4em}
td,th{border:1px solid #ccc;padding:.25em .6em;text-align:left;
font-size:.9em} th{background:#f2f2f2}
.k{color:#666}
"""


def _render_value(v) -> str:
    if isinstance(v, dict):
        rows = "".join(
            f"<tr><td class=k>{html.escape(str(k))}</td>"
            f"<td>{_render_value(x)}</td></tr>" for k, x in v.items())
        return f"<table>{rows}</table>"
    if isinstance(v, list):
        if v and isinstance(v[0], dict):
            keys = list(v[0].keys())
            head = "".join(f"<th>{html.escape(str(k))}</th>" for k in keys)
            rows = "".join(
                "<tr>" + "".join(
                    f"<td>{_render_value(row.get(k, ''))}</td>"
                    for k in keys) + "</tr>"
                for row in v)
            return f"<table><tr>{head}</tr>{rows}</table>"
        return html.escape(", ".join(str(x) for x in v))
    return html.escape(str(v))


def render_status_page(title: str, sections: dict[str, object]) -> bytes:
    parts = [f"<!doctype html><html><head><meta charset=utf-8>"
             f"<title>{html.escape(title)}</title>"
             f"<style>{_STYLE}</style></head><body>"
             f"<h1>{html.escape(title)}</h1>"]
    for name, data in sections.items():
        parts.append(f"<h2>{html.escape(name)}</h2>")
        parts.append(_render_value(data))
    parts.append("</body></html>")
    return "".join(parts).encode()
