"""One-shot cluster operations: assign, upload, delete.

Reference surface: weed/operation (assign_file_id.go, upload_content.go:69,
delete_content.go).

The port's copy of seaweedfs_tpu/operation/__init__.py.
"""

from .assign import AssignResult, assign
from .delete import delete_file_id, delete_file_ids
from .upload import UploadResult, download, upload_data

__all__ = [
    "AssignResult",
    "assign",
    "UploadResult",
    "upload_data",
    "download",
    "delete_file_id",
    "delete_file_ids",
]
