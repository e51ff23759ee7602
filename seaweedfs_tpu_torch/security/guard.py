"""IP whitelist guard for HTTP surfaces.

The port's copy of seaweedfs_tpu/security/guard.py.

Reference: weed/security/guard.go:43 — requests from addresses outside the
whitelist are rejected; an empty whitelist admits everyone.
"""

from __future__ import annotations

import ipaddress


class Guard:
    def __init__(self, whitelist: list[str] | None = None):
        self.networks: list = []
        for item in whitelist or []:
            item = item.strip()
            if not item:
                continue
            try:
                if "/" in item:
                    self.networks.append(ipaddress.ip_network(item, strict=False))
                else:
                    self.networks.append(ipaddress.ip_network(f"{item}/32"))
            except ValueError:
                continue

    def allows(self, remote_ip: str) -> bool:
        if not self.networks:
            return True
        try:
            addr = ipaddress.ip_address(remote_ip)
        except ValueError:
            return False
        return any(addr in net for net in self.networks)
