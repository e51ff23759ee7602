"""Placement rules of the port (seaweedfs_tpu/topology/)."""
