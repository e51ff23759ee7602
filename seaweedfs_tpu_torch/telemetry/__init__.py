"""Tracing of the port (its own copy of what it needs from
seaweedfs_tpu/telemetry)."""
