"""Utilities of the port (its own copies of what it needs from
seaweedfs_tpu/util)."""
