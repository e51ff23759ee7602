"""`python -m seaweedfs_tpu_torch <subcommand>` — the `weed` binary equivalent
(reference: weed/weed.go:39).

The port's copy of seaweedfs_tpu/__main__.py.  The call is guarded, so a
walk that imports every module of the package does not run the CLI.
"""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
