"""Security: JWT write tokens and the IP whitelist guard.

The port's copy of seaweedfs_tpu/security/__init__.py, without the gRPC
mTLS half (security/tls.py): the port's servers do not load
`security.toml` yet.

Reference surface: weed/security (jwt.go, guard.go).
"""

from .jwt import decode_jwt, encode_jwt, gen_write_jwt, verify_write_jwt
from .guard import Guard

__all__ = [
    "encode_jwt", "decode_jwt", "gen_write_jwt", "verify_write_jwt", "Guard",
]
