"""The port's protobuf messages, in a private DescriptorPool.

master.proto, volume_server.proto and volume_info.proto are added to
`POOL`, a `descriptor_pool.DescriptorPool()` of this package's own, and
their classes are built with `message_factory.GetMessageClass`.  Package
and message names are the reference's (`master_pb`, `volume_server_pb`),
so the bytes on the wire are the same and either side parses the other's.

Never protobuf's default pool: the reference's generated `*_pb2.py` add
the same file names there (`descriptor_pool.Default().AddSerializedFile`),
and a process that imports both packages would fail on the second
registration.  Every message the port adds later goes into `POOL` too.

`master_pb2`, `volume_server_pb2` and `volume_info_pb2` expose each file's
top-level message classes as module attributes, as generated modules do.
"""

from __future__ import annotations

from google.protobuf import descriptor_pool, message_factory

from . import descriptors

POOL = descriptor_pool.DescriptorPool()
for _blob in (descriptors.VOLUME_INFO_PROTO, descriptors.MASTER_PROTO,
              descriptors.VOLUME_SERVER_PROTO):
    POOL.AddSerializedFile(_blob)
del _blob


def message_classes(file_name: str) -> dict:
    """-> {message name: class} for the top-level messages of a file in
    POOL; nested messages are attributes of their parent's class."""
    fd = POOL.FindFileByName(file_name)
    return {name: message_factory.GetMessageClass(desc)
            for name, desc in fd.message_types_by_name.items()}
