"""Security: JWT write tokens, IP whitelist guard, gRPC mTLS.

The port's copy of seaweedfs_tpu/security/__init__.py.

Reference surface: weed/security (jwt.go, guard.go, tls.go).
"""

from .jwt import decode_jwt, encode_jwt, gen_write_jwt, verify_write_jwt
from .guard import Guard
from .tls import (
    generate_dev_certs,
    load_client_credentials,
    load_server_credentials,
)

__all__ = [
    "encode_jwt", "decode_jwt", "gen_write_jwt", "verify_write_jwt", "Guard",
    "load_server_credentials", "load_client_credentials",
    "generate_dev_certs",
]
