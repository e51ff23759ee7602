"""Client-side location caches of the port (seaweedfs_tpu/wdclient/)."""
