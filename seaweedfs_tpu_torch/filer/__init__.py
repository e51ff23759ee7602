"""Filer: the path -> chunks metadata plane — the port's copy of
seaweedfs_tpu/filer.

Reference surface: weed/filer (filer.go:30, filerstore.go:18-41,
filechunks.go) + weed/server/filer_server*.go.  Not ported yet (ROADMAP
A-7): the meta aggregator (filer peers), the filer fleet's ring, router
and fleet client, and the store kinds with external servers.
"""

from .filer import Filer
from .filerstore import FilerStore

__all__ = ["Filer", "FilerStore"]
