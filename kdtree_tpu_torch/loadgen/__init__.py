"""kdtree_tpu_torch.loadgen — the production load harness.

The port of ``kdtree_tpu/loadgen/``, host code copied as it is.

A closed-loop client keeps one request in flight: throughput =
1/latency, and a queue that can never form. Production traffic is the opposite — arrivals come from the
*world*, not from the previous response — and the difference is exactly
the regime where SLOs, shedding, hedging, and the mutable write path
earn their keep. This package drives the serve/route HTTP API the way
production would:

- :mod:`~kdtree_tpu_torch.loadgen.schedule` — a **precomputed, seeded**
  arrival schedule: Poisson arrivals at each rung of a rate ladder
  (optionally diurnally modulated), a configurable query/upsert/delete
  mix, and Zipf-skewed query geometry over spatial regions. The entire
  schedule exists before the first request is sent, which is the
  open-loop guarantee in mechanical form: response latency *cannot*
  influence when the next request fires (no coordinated omission).
- :mod:`~kdtree_tpu_torch.loadgen.runner` — the runner: dispatches the
  schedule against a live ``serve``/``route`` process, measures latency
  from each arrival's **intended** send time (queueing the service
  caused is charged to the service, even if the client itself fell
  behind), classifies outcomes (ok/shed/degraded/partial/error/
  timeout), scrapes the target's ``/metrics`` for the new write-path
  histograms, and emits a ``capacity`` block: one curve point per rate
  step plus the **knee** — the highest offered rate that still meets
  the latency SLO with an acceptable bad fraction.

The capacity block rides in the telemetry sidecar
(``python -m kdtree_tpu_torch --metrics-out ... loadgen``) and in the
standalone ``--out`` artifact, the reference's format, so the
reference's ``trend`` diffs knee rates of either package's runs.

Host-only: this package uses no torch and never touches a device — the
load generator is a client, and it must cost the machine nothing
the service under test would notice.
"""

from kdtree_tpu_torch.loadgen.schedule import (
    Arrival,
    MixSpec,
    Schedule,
    build_schedule,
)

__all__ = ["Arrival", "MixSpec", "Schedule", "build_schedule"]
