"""Open-loop arrival schedules: seeded, precomputed, response-blind.

The port of ``kdtree_tpu/loadgen/schedule.py``, copied as it is: the same
seed gives the reference's schedule, arrival by arrival.

The whole point of an open-loop generator is that arrival times are a
function of the *offered* rate and the seed — never of how the service
responded. This module makes that property structural instead of
behavioral: the complete schedule (every arrival's time offset, op, and
payload) is computed **before the first request is sent**, from one
seeded ``numpy`` generator. The runner then merely replays it. Two runs
with the same seed produce byte-identical schedules; a service that
slows down cannot slow the schedule down with it — latency measured
from the intended send time therefore includes every second of queueing
the service caused (the coordinated-omission correction, built in
rather than patched on).

Shapes:

- **steps** (default): a rate ladder — each entry of ``rates`` holds
  for ``step_seconds`` of homogeneous Poisson arrivals. This is the
  capacity-sweep shape: one latency-vs-offered-load curve point per
  rung.
- **diurnal**: the same ladder, with each rung's rate sinusoidally
  modulated (``rate * (1 + amp * sin)``) via Lewis-Shedler thinning —
  still exactly reproducible from the seed, still open-loop.

Op mix: each arrival independently draws query/upsert/delete by the
configured weights. Upserts mint fresh ids above ``write_base`` (past
the served index, so they never collide with existing rows); deletes
target an id some *earlier* arrival in the schedule upserted — chosen
at build time, so even the delete targets are response-independent. A
delete drawn before any upsert exists becomes an upsert (there is
nothing of ours to delete yet).

Query geometry is Zipf-skewed over spatial regions: ``regions`` seeded
centers in the unit cube, region ranks weighted ``1/rank^s``, query
points jittered around the drawn center. Real query traffic is never
uniform — hot regions are what make cache/plan behavior and per-bucket
load interesting under load.

Stdlib + numpy only; deliberately no torch (the generator is a client
process).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["Arrival", "MixSpec", "Schedule", "build_schedule",
           "parse_mix", "parse_recall_mix", "parse_verb_mix"]

OPS = ("query", "upsert", "delete")
# the read verbs a QUERY arrival can carry (docs/SERVING.md "Query
# verbs"); "knn" is the default and the only verb pre-verb schedules
# ever drew
QUERY_VERBS = ("knn", "radius", "range", "count")
DEFAULT_REGIONS = 64
DEFAULT_ZIPF_S = 1.1
_JITTER_STD = 0.05  # query scatter around its region center (unit cube)


class MixSpec:
    """Operation weights, normalized. ``MixSpec(query=1.0)`` is a pure
    read load; the default serving mix is read-heavy with a real write
    tail."""

    __slots__ = ("query", "upsert", "delete")

    def __init__(self, query: float = 0.9, upsert: float = 0.08,
                 delete: float = 0.02) -> None:
        weights = {"query": float(query), "upsert": float(upsert),
                   "delete": float(delete)}
        if any(w < 0 for w in weights.values()):
            raise ValueError(f"mix weights must be >= 0, got {weights}")
        total = sum(weights.values())
        if total <= 0:
            raise ValueError("mix weights must not all be zero")
        self.query = weights["query"] / total
        self.upsert = weights["upsert"] / total
        self.delete = weights["delete"] / total

    def probs(self) -> List[float]:
        return [self.query, self.upsert, self.delete]

    def describe(self) -> Dict[str, float]:
        return {"query": self.query, "upsert": self.upsert,
                "delete": self.delete}


def parse_mix(raw: str) -> MixSpec:
    """``"query:0.9,upsert:0.08,delete:0.02"`` → :class:`MixSpec`.
    Unknown op names are an error — a typo'd ``upsrt`` silently running
    a pure-read load would make a write-path drill vacuously green (the
    fault-spec grammar's lesson, applied here)."""
    weights = {"query": 0.0, "upsert": 0.0, "delete": 0.0}
    for clause in raw.split(","):
        clause = clause.strip()
        if not clause:
            continue
        if ":" not in clause:
            raise ValueError(
                f"bad mix clause {clause!r}: expected op:weight"
            )
        op, val = (part.strip() for part in clause.split(":", 1))
        if op not in OPS:
            raise ValueError(
                f"unknown mix op {op!r}: expected one of {', '.join(OPS)}"
            )
        try:
            weights[op] = float(val)
        except ValueError:
            raise ValueError(
                f"bad mix weight {val!r} in {clause!r}: must be a number"
            ) from None
    return MixSpec(**weights)


def parse_recall_mix(raw: Optional[str]):
    """``--recall-target`` → ``[(target | None, weight), ...]``.

    Accepts a single value (``"0.99"`` — every query carries it;
    ``"exact"``/``"1"`` — the pure-exact default) or a weighted mix
    (``"exact:0.5,0.99:0.3,0.9:0.2"``) so capacity curves can be
    driven per gear. Weights normalize; a typo'd target is an error,
    never a silently-exact run (the fault-spec grammar's lesson)."""
    if raw is None or not raw.strip():
        return None

    def one_target(tok: str) -> Optional[float]:
        tok = tok.strip()
        if tok.lower() in ("exact", "1", "1.0"):
            return None
        try:
            t = float(tok)
        except ValueError:
            raise ValueError(
                f"bad recall target {tok!r}: expected 'exact' or a "
                "number in (0, 1)"
            ) from None
        if not (0.0 < t < 1.0):
            raise ValueError(
                f"recall target {t:g} must be in (0, 1) — use 'exact' "
                "for 1.0"
            )
        return t

    if ":" not in raw:
        target = one_target(raw)
        return None if target is None else [(target, 1.0)]
    out = []
    for clause in raw.split(","):
        clause = clause.strip()
        if not clause:
            continue
        tok, _, w = clause.rpartition(":")
        try:
            weight = float(w)
        except ValueError:
            raise ValueError(
                f"bad recall-mix weight {w!r} in {clause!r}: must be a "
                "number"
            ) from None
        if weight < 0:
            raise ValueError(f"recall-mix weight {weight:g} in "
                             f"{clause!r} must be >= 0")
        out.append((one_target(tok), weight))
    total = sum(w for _, w in out)
    if total <= 0:
        raise ValueError("recall-mix weights must not all be zero")
    return [(t, w / total) for t, w in out]


def parse_verb_mix(raw: Optional[str]):
    """``--verb-mix`` → ``[(verb, weight), ...]`` or None (pure knn).

    ``"knn:0.7,radius:0.2,count:0.1"`` draws each QUERY arrival's read
    verb by the normalized weights — still seeded, still
    response-blind, and the extra rng draw happens only when a mix is
    configured, so an unmixed schedule stays byte-identical to what
    pre-verb loadgen built from the same seed. Unknown verb names are
    an error, never a silently-pure-knn run (the fault-spec grammar's
    lesson)."""
    if raw is None or not raw.strip():
        return None
    weights: Dict[str, float] = {}
    for clause in raw.split(","):
        clause = clause.strip()
        if not clause:
            continue
        if ":" not in clause:
            raise ValueError(
                f"bad verb-mix clause {clause!r}: expected verb:weight"
            )
        verb, val = (part.strip() for part in clause.split(":", 1))
        if verb not in QUERY_VERBS:
            raise ValueError(
                f"unknown verb {verb!r}: expected one of "
                f"{', '.join(QUERY_VERBS)}"
            )
        try:
            weight = float(val)
        except ValueError:
            raise ValueError(
                f"bad verb-mix weight {val!r} in {clause!r}: must be a "
                "number"
            ) from None
        if weight < 0:
            raise ValueError(f"verb-mix weight {weight:g} in "
                             f"{clause!r} must be >= 0")
        weights[verb] = weights.get(verb, 0.0) + weight
    total = sum(weights.values())
    if total <= 0:
        raise ValueError("verb-mix weights must not all be zero")
    return [(v, weights[v] / total) for v in QUERY_VERBS
            if v in weights]


class Arrival:
    """One scheduled request: when (offset seconds from run start),
    what (op + payload + the query's recall target, None = exact, and
    its read verb — knn/radius/range/count), and which rate step it
    belongs to."""

    __slots__ = ("t", "step", "op", "point", "gid", "recall", "verb")

    def __init__(self, t: float, step: int, op: str,
                 point: Optional[np.ndarray] = None,
                 gid: Optional[int] = None,
                 recall: Optional[float] = None,
                 verb: str = "knn") -> None:
        self.t = float(t)
        self.step = int(step)
        self.op = op
        self.point = point
        self.gid = gid
        self.recall = recall
        self.verb = verb

    def key(self):
        """Comparable identity for determinism tests: timing, step, op,
        payload — everything the runner acts on."""
        return (
            round(self.t, 9), self.step, self.op, self.gid,
            None if self.point is None
            else tuple(round(float(x), 9) for x in self.point),
            self.recall, self.verb,
        )


class Schedule:
    """A fully materialized open-loop schedule plus its build facts."""

    def __init__(self, arrivals: List[Arrival], rates: List[float],
                 step_seconds: float, seed: int, mix: MixSpec,
                 dim: int, write_base: int, shape: str,
                 recall_mix=None, verb_mix=None) -> None:
        self.arrivals = arrivals
        self.rates = [float(r) for r in rates]
        self.step_seconds = float(step_seconds)
        self.seed = int(seed)
        self.mix = mix
        self.dim = int(dim)
        self.write_base = int(write_base)
        self.shape = shape
        self.recall_mix = recall_mix
        self.verb_mix = verb_mix

    @property
    def duration_s(self) -> float:
        return self.step_seconds * len(self.rates)

    def keys(self):
        return [a.key() for a in self.arrivals]

    def describe(self) -> Dict:
        ops = {op: 0 for op in OPS}
        for a in self.arrivals:
            ops[a.op] += 1
        out = {
            "arrivals": len(self.arrivals),
            "rates": self.rates,
            "step_seconds": self.step_seconds,
            "seed": self.seed,
            "shape": self.shape,
            "mix": self.mix.describe(),
            "ops": ops,
            "dim": self.dim,
            "write_base": self.write_base,
        }
        if self.recall_mix:
            out["recall_mix"] = [
                ["exact" if t is None else t, w]
                for t, w in self.recall_mix
            ]
        if self.verb_mix:
            out["verb_mix"] = [[v, w] for v, w in self.verb_mix]
            verbs = {v: 0 for v, _ in self.verb_mix}
            for a in self.arrivals:
                if a.op == "query":
                    verbs[a.verb] = verbs.get(a.verb, 0) + 1
            out["verbs"] = verbs
        return out


def _zipf_weights(regions: int, s: float) -> np.ndarray:
    ranks = np.arange(1, regions + 1, dtype=np.float64)
    w = 1.0 / np.power(ranks, s)
    return w / w.sum()


def build_schedule(
    rates: Sequence[float],
    step_seconds: float,
    seed: int,
    dim: int,
    mix: Optional[MixSpec] = None,
    regions: int = DEFAULT_REGIONS,
    zipf_s: float = DEFAULT_ZIPF_S,
    shape: str = "steps",
    diurnal_amp: float = 0.3,
    write_base: int = 10_000_000,
    recall_mix=None,
    verb_mix=None,
) -> Schedule:
    """Materialize the whole schedule from the seed — see the module
    docstring for the open-loop rationale.

    ``rates`` are offered request rates (req/s) per ladder step;
    ``write_base`` is the first id upserts mint (pick it above the
    served index's id range so writes never collide with real rows —
    the CLI derives it from ``/healthz``). ``recall_mix`` (from
    :func:`parse_recall_mix`) draws each QUERY arrival's
    ``recall_target`` from a weighted set — still seeded, still
    response-blind — so capacity curves can be driven per serving
    gear; ``None`` keeps every query exact. ``verb_mix`` (from
    :func:`parse_verb_mix`) likewise draws each query arrival's read
    verb (knn/radius/range/count); ``None`` keeps every query a knn
    lookup AND skips the draw entirely, so unmixed schedules stay
    byte-identical to pre-verb ones from the same seed."""
    if not rates or any(r <= 0 for r in rates):
        raise ValueError(f"rates must be positive, got {list(rates)}")
    if step_seconds <= 0:
        raise ValueError(f"step_seconds must be > 0, got {step_seconds}")
    if dim < 1:
        raise ValueError(f"dim must be >= 1, got {dim}")
    if regions < 1:
        raise ValueError(f"regions must be >= 1, got {regions}")
    if shape not in ("steps", "diurnal"):
        raise ValueError(f"shape must be 'steps' or 'diurnal', got {shape!r}")
    if not (0.0 <= diurnal_amp < 1.0):
        raise ValueError(f"diurnal amp must be in [0, 1), got {diurnal_amp}")
    mix = mix if mix is not None else MixSpec()
    rng = np.random.default_rng(int(seed))
    centers = rng.random((regions, dim))
    region_p = _zipf_weights(regions, zipf_s)
    probs = mix.probs()
    recall_targets = recall_probs = None
    if recall_mix:
        recall_targets = [t for t, _ in recall_mix]
        recall_probs = [w for _, w in recall_mix]
    verb_names = verb_probs = None
    if verb_mix:
        verb_names = [v for v, _ in verb_mix]
        verb_probs = [w for _, w in verb_mix]

    arrivals: List[Arrival] = []
    upserted: List[int] = []  # gids minted so far, in schedule order
    next_gid = int(write_base)
    for step, rate in enumerate(rates):
        t0 = step * step_seconds
        t1 = t0 + step_seconds
        # homogeneous Poisson at the envelope rate; diurnal thins it
        # down to the modulated instantaneous rate (Lewis-Shedler)
        env_rate = rate * (1.0 + diurnal_amp) if shape == "diurnal" \
            else rate
        t = t0
        while True:
            t += float(rng.exponential(1.0 / env_rate))
            if t >= t1:
                break
            if shape == "diurnal":
                inst = rate * (
                    1.0 + diurnal_amp
                    * np.sin(2.0 * np.pi * (t - t0) / step_seconds)
                )
                if rng.random() * env_rate > max(inst, 0.0):
                    continue  # thinned: this envelope arrival never fires
            op = OPS[int(rng.choice(3, p=probs))]
            if op == "delete" and not upserted:
                # nothing of ours exists to delete yet; minting a fresh
                # row keeps the write fraction honest instead of
                # silently shrinking it
                op = "upsert"
            if op == "query":
                center = centers[int(rng.choice(regions, p=region_p))]
                point = np.clip(
                    center + rng.normal(0.0, _JITTER_STD, dim), 0.0, 1.0
                ).astype(np.float32)
                recall = None
                if recall_targets is not None:
                    recall = recall_targets[
                        int(rng.choice(len(recall_targets),
                                       p=recall_probs))
                    ]
                verb = "knn"
                if verb_names is not None:
                    verb = verb_names[
                        int(rng.choice(len(verb_names), p=verb_probs))
                    ]
                arrivals.append(Arrival(t, step, "query", point=point,
                                        recall=recall, verb=verb))
            elif op == "upsert":
                gid = next_gid
                next_gid += 1
                upserted.append(gid)
                point = rng.random(dim).astype(np.float32)
                arrivals.append(
                    Arrival(t, step, "upsert", point=point, gid=gid)
                )
            else:
                # target an id an EARLIER arrival upserted — decided at
                # build time, so delete targets are response-blind too
                pick = int(rng.integers(len(upserted)))
                gid = upserted.pop(pick)
                arrivals.append(Arrival(t, step, "delete", gid=gid))
    return Schedule(arrivals, list(rates), step_seconds, seed, mix, dim,
                    write_base, shape, recall_mix=recall_mix,
                    verb_mix=verb_mix)
