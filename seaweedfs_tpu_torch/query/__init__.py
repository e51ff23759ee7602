"""SQL-on-blob SELECT evaluation for the volume Query rpc.

The port's copy of seaweedfs_tpu/query/__init__.py.

Reference: weed/query/ (json/, sqltypes/) + volume_grpc_query.go:12.
"""

from .engine import query_csv_lines, query_json_lines

__all__ = ["query_json_lines", "query_csv_lines"]
