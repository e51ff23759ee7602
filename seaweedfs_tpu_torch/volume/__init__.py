"""The port's volume server: its gRPC side (seaweedfs_tpu/volume/)."""
