"""Multi-device EC over a mesh of torch devices — the port of
seaweedfs_tpu/parallel/: sharded batch encode, the psum decode
(mesh.py), the file-level flows on them (batch.py) and the dry run
(dryrun.py)."""

from .mesh import (  # noqa: F401
    Mesh,
    batch_apply_sharded,
    batch_encode_sharded,
    distributed_reconstruct,
    make_mesh,
    train_step,
)
