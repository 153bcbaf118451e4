"""Atomic bundles and checkpoints of the port (``checkpoint.manager``)."""
from .manager import (  # noqa: F401
    CheckpointManager, atomic_dir, bundle_manifest, file_digest,
    verify_bundle,
)

__all__ = ["CheckpointManager", "atomic_dir", "bundle_manifest",
           "file_digest", "verify_bundle"]
