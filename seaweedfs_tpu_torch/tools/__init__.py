"""Operator tools — the part of seaweedfs_tpu/tools the port needs."""
