"""Blue/green snapshot following for read replicas.

The port of ``kdtree_tpu/snapshot/follower.py``. A secondary replica
serves one epoch's snapshot while the shard primary compacts the next; when the primary's epoch rebuilder emits a fresh
snapshot (``mutable/engine.py`` → ``snapshot/store.py``), the follower
notices the manifest's ``version`` change, loads the new tree (checksum
verified, mmap-read), pre-warms its batch shapes OFF the serving path,
and swaps it into the engine atomically between batches — the same
zero-downtime handoff the in-process epoch rebuilder uses, stretched
across processes. ``/healthz`` then reports the adopted epoch, which is
how a fleet's convergence is observed.

The poll loop never raises: a torn manifest mid-write reads as "nothing
new yet" (the writer replaces it atomically, so the next poll sees a
complete one), and a corrupt segment counts a
``kdtree_snapshot_load_errors_total`` and keeps the CURRENT epoch
serving — a replica must degrade to stale, never to down.
"""

from __future__ import annotations

import threading
from typing import Optional

from kdtree_tpu_torch import obs
from kdtree_tpu_torch.obs import flight
from kdtree_tpu_torch.snapshot.store import (
    SnapshotError,
    load_snapshot,
    read_manifest,
    resolve_dir,
    seed_plan_store,
)

DEFAULT_POLL_S = 2.0


class SnapshotFollower:
    """Poll a snapshot directory and blue/green-swap new versions into
    a :class:`~kdtree_tpu_torch.mutable.engine.MutableEngine`.

    ``start_version`` is the manifest version the engine already serves
    (the one the process booted from), so the first poll doesn't
    re-adopt it. ``on_adopt(manifest)`` runs after each successful swap
    — the server uses it to surface the live snapshot version on
    ``/healthz``. The tree loads onto the device the engine serves from.
    """

    def __init__(
        self,
        engine,
        dirpath: str,
        poll_s: float = DEFAULT_POLL_S,
        start_version: int = 0,
        on_adopt=None,
    ) -> None:
        self.engine = engine
        self.dir = resolve_dir(dirpath)
        self.poll_s = max(float(poll_s), 0.05)
        self.version = int(start_version)
        # a version whose load FAILED (corrupt at rest): skip it until
        # the manifest changes — re-verifying hundreds of MB of
        # segments every poll tick would burn disk bandwidth retrying
        # an outcome that cannot change without a new save
        self._failed_version: Optional[int] = None
        self._on_adopt = on_adopt
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._g_version = obs.get_registry().gauge(
            "kdtree_snapshot_follow_version")
        self._g_version.set(self.version)
        self._adopts = obs.get_registry().counter(
            "kdtree_snapshot_adoptions_total")

    # -- one poll tick (public for tests: deterministic, no thread) ---------

    def poll_once(self) -> bool:
        """Check the manifest and adopt a changed version; True when a
        swap happened. Never raises."""
        try:
            man = read_manifest(self.dir)
            if man is None:
                return False
            version = int(man.get("version", 0))
            if version == self.version or version == self._failed_version:
                return False
            return self._adopt(version)
        except Exception as e:  # the loop must outlive any single tick
            flight.record("snapshot.follow_error", dir=self.dir,
                          error=repr(e)[:200])
            return False

    def _adopt(self, version: int) -> bool:
        try:
            tree, man = load_snapshot(self.dir,
                                      device=self.engine.tree.device)
        except SnapshotError:
            # counted + flight-recorded by the store; keep serving the
            # current epoch. Latch the failed version so the next tick
            # doesn't re-checksum the same broken segment set — only a
            # NEW save (version bump) re-arms the attempt.
            self._failed_version = version
            return False
        except Exception as e:
            # anything past the store's own checks (device transfer
            # OOM, a CUDA error) is just as unchangeable until a new
            # save — latch it too, or the replica re-streams the full
            # verify pass every tick retrying an outcome that cannot
            # change (the exact loop the latch exists to prevent)
            self._failed_version = version
            flight.record("snapshot.follow_error", dir=self.dir,
                          version=version, error=repr(e)[:200])
            return False
        # the version ACTUALLY loaded: load_snapshot re-reads the
        # manifest, so a save landing between the poll and the load is
        # already the one adopted here — recording the stale poll
        # version would re-adopt the identical snapshot next tick (and
        # under-report the serving version on the gauge)
        version = int(man.get("version", version))
        epoch = int(man.get("epoch", 0))
        try:
            # seed the local plan store from the manifest's pre-shipped
            # profiles before the pre-warm below (fill-misses-only —
            # seed_plan_store never overwrites local knowledge, and never
            # raises past its own store tolerance)
            seeded = seed_plan_store(man)
            # pre-warm + swap: adopt_tree runs the new epoch's batch
            # shapes on THIS thread before the atomic handoff, so serving
            # never dispatches a first-use shape (the epoch rebuilder's
            # own discipline)
            self.engine.adopt_tree(tree, epoch=epoch)
        except Exception as e:
            self._failed_version = version
            flight.record("snapshot.follow_error", dir=self.dir,
                          version=version, error=repr(e)[:200])
            return False
        self._failed_version = None
        self.version = version
        self._g_version.set(version)
        self._adopts.inc()
        flight.record("snapshot.follow_swap", dir=self.dir,
                      version=version, epoch=epoch,
                      n=int(tree.n_real), plans_seeded=seeded)
        if self._on_adopt is not None:
            try:
                self._on_adopt(man)
            except Exception:
                pass  # observer hooks must not stall the follower
        return True

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name="kdtree-snapshot-follower", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.poll_once()
            self._stop.wait(self.poll_s)

    def stop(self, timeout_s: float = 30.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=timeout_s)
        self._thread = None
