"""The messages of volume_server.proto (package `volume_server_pb`), from the port's
private DescriptorPool (see seaweedfs_tpu_torch/pb/__init__.py)."""

from . import message_classes

globals().update(message_classes("volume_server.proto"))
