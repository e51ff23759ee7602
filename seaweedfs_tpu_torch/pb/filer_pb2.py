"""The messages of filer.proto (package `filer_pb`), from the port's
private DescriptorPool (see seaweedfs_tpu_torch/pb/__init__.py)."""

from . import message_classes

globals().update(message_classes("filer.proto"))
