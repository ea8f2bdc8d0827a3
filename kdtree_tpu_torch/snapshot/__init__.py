"""Index snapshots: versioned on-disk serialization of the built
serving structure, the replica fleet's cold-start and blue/green
primitive. The port of ``kdtree_tpu/snapshot``, with the same on-disk
format."""

from kdtree_tpu_torch.snapshot.follower import DEFAULT_POLL_S, SnapshotFollower
from kdtree_tpu_torch.snapshot.store import (
    MANIFEST_NAME,
    SNAPSHOT_SCHEMA,
    SnapshotCorruptError,
    SnapshotError,
    SnapshotSchemaError,
    collect_plan_profiles,
    list_versions,
    load_snapshot,
    plan_keys_for,
    read_manifest,
    resolve_dir,
    save_snapshot,
    seed_plan_store,
)

__all__ = [
    "DEFAULT_POLL_S",
    "MANIFEST_NAME",
    "SNAPSHOT_SCHEMA",
    "SnapshotCorruptError",
    "SnapshotError",
    "SnapshotFollower",
    "SnapshotSchemaError",
    "collect_plan_profiles",
    "list_versions",
    "load_snapshot",
    "plan_keys_for",
    "read_manifest",
    "resolve_dir",
    "save_snapshot",
    "seed_plan_store",
]
