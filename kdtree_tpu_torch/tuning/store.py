"""Persistent tiled-query plan store: JSON profiles keyed by a quantized
problem signature.

The port of ``kdtree_tpu/tuning/store.py``. A settled launch plan (tile,
cmax, seeds) is written as one small JSON profile under a cache dir, keyed
by :class:`PlanSignature`: (Q-bucket, D, n-bucket, k, bucket size,
num-buckets, backend, device count), Q and n rounded up to the next power
of two.

The port keeps its own namespace, so a profile settled on a TPU can never
warm a plan on the card: the ``KDTREE_TPU_TORCH_PLAN_CACHE`` environment
variable (default ``$XDG_CACHE_HOME/kdtree_tpu_torch/plans``;
``none``/``off``/``0``/empty disables the store), and a backend that is
the port device's type (``"cuda"``/``"cpu"``).

Profiles are advisory, never correctness inputs: the tiled engine's
overflow retry guards every batch. Corrupt files, unknown versions and
out-of-range values read as a miss. Writes are atomic (tmp +
``os.replace``) and never raise into the run they observe.

What reads the store: ``plan_tiled`` (through
:func:`kdtree_tpu_torch.tuning.lookup`), the recall dial's calibration
(:func:`kdtree_tpu_torch.tuning.profile_for`) and the snapshot manifest's
``plan_profiles`` payload (:mod:`kdtree_tpu_torch.snapshot.store`). What
writes it: the per-run feedback (:mod:`~kdtree_tpu_torch.tuning.feedback`),
the ``tune`` sweep and the recall harness, all through
:meth:`PlanStore.record`.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import NamedTuple, Optional

from kdtree_tpu_torch import obs
from kdtree_tpu_torch.serve.engine import _pow2_ceil

PROFILE_VERSION = 1

ENV_CACHE_DIR = "KDTREE_TPU_TORCH_PLAN_CACHE"
_DISABLED_VALUES = ("", "0", "none", "off")

# the launch knobs a profile must carry to be usable; everything else
# (prune_rate, occupancy_p90, ...) is observability payload
_REQUIRED_INT_FIELDS = ("tile", "cmax", "seeds")


class PlanSignature(NamedTuple):
    """Quantized problem signature — the plan-store key."""

    q_bucket: int
    dim: int
    n_bucket: int
    k: int
    bucket_size: int
    num_buckets: int
    backend: str
    devices: int

    @property
    def key(self) -> str:
        return (
            f"q{self.q_bucket}-d{self.dim}-n{self.n_bucket}-k{self.k}"
            f"-b{self.bucket_size}-nb{self.num_buckets}"
            f"-{self.backend}-p{self.devices}"
        )


def make_signature(
    Q: int, D: int, n: int, k: int, bucket_size: int, num_buckets: int,
    devices: int = 1, backend: Optional[str] = None,
) -> PlanSignature:
    """Signature for one tiled-query problem shape. ``backend`` defaults to
    the type of the device the port runs on (``"cuda"``, or ``"cpu"``
    when asked for), so a profile never crosses backends."""
    if backend is None:
        from kdtree_tpu_torch import resolve_device

        backend = resolve_device(None).type
    return PlanSignature(
        q_bucket=_pow2_ceil(Q),
        dim=int(D),
        n_bucket=_pow2_ceil(n),
        k=int(k),
        bucket_size=int(bucket_size),
        num_buckets=int(num_buckets),
        backend=str(backend),
        devices=int(devices),
    )


# In-process read memo: {profile path: (mtime_ns, size, validated profile)}.
# A stat() is enough to stay coherent with other processes (any writer
# replaces the file, changing mtime/size), so a repeated read costs one
# stat instead of a parse.
_read_memo: dict = {}


def default_cache_dir() -> Optional[str]:
    """Resolve the cache dir from the environment; None = store disabled."""
    raw = os.environ.get(ENV_CACHE_DIR)
    if raw is not None:
        return None if raw.strip().lower() in _DISABLED_VALUES else raw
    base = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache"
    )
    return os.path.join(base, "kdtree_tpu_torch", "plans")


class PlanStore:
    """File-backed plan profiles; every operation is failure-tolerant (a
    broken cache dir degrades to the heuristic path, never to an error)."""

    def __init__(self, cache_dir: Optional[str] = None) -> None:
        self.cache_dir = cache_dir if cache_dir is not None else default_cache_dir()

    @property
    def enabled(self) -> bool:
        return self.cache_dir is not None

    def path_for(self, sig: PlanSignature) -> str:
        return os.path.join(self.cache_dir or "", f"plan-{sig.key}.json")

    def get(self, sig: PlanSignature) -> Optional[dict]:
        """The validated profile for ``sig``, or None on miss / corrupt
        file / stale version / unusable launch knobs."""
        return self._validate(self.get_raw(sig))

    def get_raw(self, sig: PlanSignature) -> Optional[dict]:
        """The version-checked profile for ``sig`` WITHOUT the
        launch-knob requirement — for advisory payload (the recall
        calibration) in a profile no tuner has settled launch knobs into,
        and what the snapshot seeding checks for a key the local store
        already holds. LAUNCHING from a profile goes through :meth:`get`."""
        if not self.enabled:
            return None
        path = self.path_for(sig)
        try:
            st = os.stat(path)
        except OSError:
            _read_memo.pop(path, None)
            return None
        memo = _read_memo.get(path)
        if memo is not None and memo[0] == st.st_mtime_ns and \
                memo[1] == st.st_size:
            return memo[2]
        try:
            with open(path) as f:
                prof = json.load(f)
        except ValueError:
            prof = None  # corrupt file: memoize the miss too, or a
            # permanently broken profile re-pays the parse every call
        except OSError:
            return None  # transient read error: retry next call
        else:
            prof = self._version_check(prof)
        _read_memo[path] = (st.st_mtime_ns, st.st_size, prof)
        return prof

    def raw_for_key(self, key: str) -> Optional[dict]:
        """Version-checked raw profile by signature KEY — for consumers
        that hold key strings rather than signatures (the snapshot
        manifest's ``plan_profiles`` payload ships profiles under their
        keys). One implementation of the file naming and version gate,
        shared with the signature-keyed read path; no memo (callers are
        once-per-save, not per-query)."""
        if not self.enabled:
            return None
        try:
            with open(os.path.join(self.cache_dir,
                                   f"plan-{key}.json")) as f:
                prof = json.load(f)
        except (OSError, ValueError):
            return None
        return self._version_check(prof)

    @staticmethod
    def _version_check(prof) -> Optional[dict]:
        if not isinstance(prof, dict):
            return None
        if prof.get("version") != PROFILE_VERSION:
            return None  # stale format: treat as a miss, never guess
        return prof

    @classmethod
    def _validate(cls, prof) -> Optional[dict]:
        prof = cls._version_check(prof)
        if prof is None:
            return None
        for field in _REQUIRED_INT_FIELDS:
            v = prof.get(field)
            if not isinstance(v, int) or isinstance(v, bool) or v < 1:
                return None
        return prof

    def put(self, sig: PlanSignature, profile: dict) -> bool:
        """Atomically write ``profile`` (version stamp + timestamp added).
        Returns False (without raising) when the store is disabled or the
        write fails — plan persistence must never fail the run."""
        if not self.enabled:
            return False
        rec = dict(profile)
        rec["version"] = PROFILE_VERSION
        rec["signature"] = sig._asdict()
        rec["updated_unix"] = time.time()
        path = self.path_for(sig)
        # pid AND thread id: concurrent same-shape queries from a threaded
        # serving process must not interleave into one tmp file and
        # os.replace a corrupt profile into place
        tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
        try:
            os.makedirs(self.cache_dir, exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(rec, f, indent=2, sort_keys=True)
                f.write("\n")
            os.replace(tmp, path)
            st = os.stat(path)
            _read_memo[path] = (st.st_mtime_ns, st.st_size,
                                self._version_check(rec))
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return False
        obs.get_registry().counter("kdtree_plan_cache_writes_total").inc()
        return True

    def scan(self):
        """Yield ``(signature dict, raw profile dict)`` for every readable
        profile in the store — the cross-signature view for consumers that
        match on parts of a signature. Unreadable files and profiles
        without a signature are skipped, never raised."""
        if not self.enabled:
            return
        try:
            names = sorted(os.listdir(self.cache_dir))
        except OSError:
            return
        for fname in names:
            if not (fname.startswith("plan-") and fname.endswith(".json")):
                continue
            try:
                with open(os.path.join(self.cache_dir, fname)) as f:
                    prof = json.load(f)
            except (OSError, ValueError):
                continue
            if not isinstance(prof, dict) or \
                    prof.get("version") != PROFILE_VERSION:
                continue
            sig = prof.get("signature")
            if not isinstance(sig, dict):
                continue
            yield sig, prof

    def record(self, sig: PlanSignature, **fields) -> bool:
        """Merge ``fields`` into the profile for ``sig``, writing only when
        something other than the timestamp changed — a serving loop that
        re-observes the same settled plan on every call must not rewrite
        the file each time. The merge is over the RAW profile, so an
        advisory-only profile (a recall calibration written before any
        tuner settled launch knobs) is never erased by later feedback."""
        if not self.enabled:
            return False
        existing = self.get_raw(sig) or {}
        base = {
            k: v for k, v in existing.items()
            if k not in ("version", "signature", "updated_unix")
        }
        merged = dict(base)
        merged.update(fields)
        if merged == base:
            return False
        return self.put(sig, merged)


def default_store() -> PlanStore:
    """A store bound to the current environment's cache dir. Constructed
    per call (it holds only the resolved path) so env changes — tests,
    operator overrides — take effect without process-global state."""
    return PlanStore()
