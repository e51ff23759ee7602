"""Cluster client library: MasterClient, the vidMap location cache and the
EC shard locations' tiered cache — the port's copy of
seaweedfs_tpu/wdclient.

Reference surface: weed/wdclient (masterclient.go, vid_map.go).
"""

from .masterclient import MasterClient
from .vid_map import Location, VidMap

__all__ = ["MasterClient", "VidMap", "Location"]
