"""The port's cost ledger (``kdtree_tpu_torch/obs/costs.py``) against the
reference's: the same sequence of ``attribute_batch`` /
``attribute_request`` / ``attribute_correction`` / ``count_bytes`` /
``count_write`` / ``count_rebuild`` calls, over history rings sampled at
the same fixed times, gives equal counters, ``report()``, ``headroom()``
and ``window_costs()``; the row shares sum exactly to each span. The duty
cycle runs a real CPU capture window, publishes the busy gauge and removes
its artifact, and skips a window while another capture is open."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from kdtree_tpu.obs import costs as jcosts
from kdtree_tpu.obs import history as jhist
from kdtree_tpu.obs import registry as jreg
from kdtree_tpu_torch.obs import costs as tcosts
from kdtree_tpu_torch.obs import history as thist
from kdtree_tpu_torch.obs import profile as tprof
from kdtree_tpu_torch.obs import registry as treg

torch.set_num_threads(1)

VERBS = ("knn", "radius", "range", "count_radius", "count_box", "bogus")
GEARS = (None, "exact", "approx:0.9", "brute-deadline", "weird")
OUTCOMES = ("ok", "degraded", None, "strange")


def _drive(ledger, counts_mod, reg, hist, seed: int) -> None:
    """One seeded call sequence, sampled into ``hist`` every step at
    fixed times 100, 110, ..."""
    rng = np.random.default_rng(seed)
    hist.record(reg.snapshot(), ts=100.0)
    for step in range(12):
        for _ in range(int(rng.integers(1, 4))):
            members = [(int(rng.integers(1, 1000)), float(rng.uniform(0, 5)),
                        OUTCOMES[int(rng.integers(len(OUTCOMES)))])
                       for _ in range(int(rng.integers(1, 6)))]
            ledger.attribute_batch(
                verb=VERBS[int(rng.integers(len(VERBS)))],
                gear=GEARS[int(rng.integers(len(GEARS)))],
                span_ms=round(float(rng.uniform(0, 40)), 3), members=members,
                retries=int(rng.integers(0, 3)),
                visits_per_row=int(rng.integers(0, 64)))
        ledger.attribute_request(
            verb="knn", gear="exact", span_ms=float(rng.uniform(0, 9)),
            rows=int(rng.integers(1, 2000)), queue_ms=1.5, outcome="degraded")
        ledger.attribute_correction(float(rng.uniform(0, 3)), int(rng.integers(1, 64)))
        ledger.count_bytes(verb=VERBS[step % len(VERBS)], gear=GEARS[step % len(GEARS)],
                           outcome="ok", bytes_in=int(rng.integers(0, 9000)),
                           bytes_out=int(rng.integers(0, 90000)))
        counts_mod.count_write("upsert" if step % 3 else "delete",
                               float(rng.uniform(0, 2)), registry=reg)
        if step % 5 == 4:
            counts_mod.count_rebuild(float(rng.uniform(100, 900)), registry=reg)
        if step == 6:
            reg.gauge("kdtree_device_busy_frac").set(0.37)
        hist.record(reg.snapshot(), ts=110.0 + 10.0 * step)


def _pair(seed: int):
    jr, tr = jreg.MetricsRegistry(), treg.MetricsRegistry()
    jh, th = jhist.MetricHistory(), thist.MetricHistory()
    jl, tl = jcosts.CostLedger(registry=jr), tcosts.CostLedger(registry=tr)
    _drive(jl, jcosts, jr, jh, seed)
    _drive(tl, tcosts, tr, th, seed)
    return (jl, jr, jh), (tl, tr, th)


def _strip(rep: dict) -> dict:
    return {k: v for k, v in rep.items() if k not in ("generated_unix", "pid")}


@pytest.mark.parametrize("seed", range(4))
def test_same_calls_same_ledger(seed):
    (jl, jr, jh), (tl, tr, th) = _pair(seed)
    assert tr.snapshot()["counters"] == jr.snapshot()["counters"]
    now = 220.0
    for window in (30.0, 60.0, 500.0):
        assert tl.window_costs(window, th, now=now) == jl.window_costs(window, jh, now=now)
        assert tl.headroom(window, th, now=now) == jl.headroom(window, jh, now=now)
        assert _strip(tl.report(window, th, now=now)) == \
            _strip(jl.report(window, jh, now=now))
    assert tl.class_rows() == jl.class_rows()
    hr = tl.headroom(60.0, th, now=now)
    assert hr["data"] and hr["busy_frac"] == 0.37
    tl.publish(history=th, now=now)
    jl.publish(history=jh, now=now)
    assert tr.snapshot()["gauges"] == jr.snapshot()["gauges"]


@pytest.mark.parametrize("seed", range(6))
def test_row_shares_sum_exactly(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        rows = [int(r) for r in rng.integers(0, 5000, int(rng.integers(1, 30)))]
        span = round(float(rng.uniform(0, 500)), 3)
        shares = tcosts.amortize_span_ms(span, rows)
        assert shares == jcosts.amortize_span_ms(span, rows)
        want = int(round(span * 1000)) if sum(rows) else 0
        assert sum(int(round(s * 1000)) for s in shares) == want
        ledger = tcosts.CostLedger(registry=treg.MetricsRegistry())
        got = ledger.attribute_batch(verb="knn", gear=None, span_ms=span,
                                     members=[(r, 0.0, "ok") for r in rows])
        assert got == shares


def test_idle_ledger_reports_no_data():
    tl = tcosts.CostLedger(registry=treg.MetricsRegistry())
    jl = jcosts.CostLedger(registry=jreg.MetricsRegistry())
    th, jh = thist.MetricHistory(), jhist.MetricHistory()
    assert tl.window_costs(60.0, th, now=1.0) is None
    assert tl.headroom(60.0, th, now=1.0) == jl.headroom(60.0, jh, now=1.0)
    assert tl.headroom(60.0, th, now=1.0)["data"] is False


def test_duty_env_knobs_match(monkeypatch):
    monkeypatch.setenv("KDTREE_TPU_PROFILE_DUTY_PERIOD_S", "5")
    monkeypatch.setenv("KDTREE_TPU_PROFILE_DUTY_WINDOW_S", "garbage")
    assert tcosts.duty_period_s() == jcosts.duty_period_s() == 5.0
    assert tcosts.duty_window_s() == jcosts.duty_window_s() == 2.0


def _cpu_window(seconds, log_dir):
    return tprof.capture_for(seconds, log_dir, "cpu")


def test_duty_window_publishes_and_cleans_up(tmp_path):
    reg = treg.get_registry()
    duty = tcosts.ProfileDutyCycle(log_dir=str(tmp_path), period_s=60.0,
                                   window_s=0.05, capture_for=_cpu_window)
    windows = reg.counter("kdtree_profile_duty_windows_total").value
    a = torch.rand(64, 64)
    rep = None
    for _ in range(3):  # an empty window on a quiet process has no slices
        rep = duty.run_window()
        (a @ a).sum()
    assert rep is not None and rep["device"]["kind"] == "cpu"
    assert reg.counter("kdtree_profile_duty_windows_total").value == windows + 3
    assert reg.gauge("kdtree_device_busy_frac").value == rep["device"]["busy_frac"]
    assert not list(tmp_path.glob("*.json")), "the window's trace was not removed"


def test_duty_window_skips_while_a_capture_is_open(tmp_path):
    reg = treg.get_registry()
    skipped = reg.counter("kdtree_profile_duty_skipped_total").value
    duty = tcosts.ProfileDutyCycle(log_dir=str(tmp_path / "d"), period_s=60.0,
                                   window_s=0.01, capture_for=_cpu_window)
    with tprof.capture(str(tmp_path / "m"), device="cpu"):
        assert duty.run_window() is None
    assert reg.counter("kdtree_profile_duty_skipped_total").value == skipped + 1


def test_duty_thread_starts_and_stops(monkeypatch):
    monkeypatch.setenv("KDTREE_TPU_PROFILE_DUTY", "1")  # off by default
    duty = tcosts.ProfileDutyCycle(period_s=60.0, window_s=0.01, capture_for=_cpu_window)
    duty.start()
    assert duty.running
    duty.stop()
    assert not duty.running


@pytest.mark.parametrize("value, on", [
    (None, False), ("", False), ("0", False), ("off", False), ("none", False),
    ("garbage", False), ("1", True), ("on", True), ("TRUE", True), ("yes", True),
])
def test_duty_cycle_is_opt_in(monkeypatch, value, on):
    """The port's duty cycle runs only when ``KDTREE_TPU_PROFILE_DUTY``
    asks for it (the reference's runs unless it is 0/off/none): each
    window pauses the batch worker."""
    if value is None:
        monkeypatch.delenv("KDTREE_TPU_PROFILE_DUTY", raising=False)
    else:
        monkeypatch.setenv("KDTREE_TPU_PROFILE_DUTY", value)
    assert tcosts.duty_enabled() is on
    duty = tcosts.ProfileDutyCycle(period_s=60.0, window_s=0.01, capture_for=_cpu_window)
    assert duty.enabled is on
    duty.start()
    try:
        assert duty.running is on
    finally:
        duty.stop()


def test_duty_cycle_needs_a_capture_function():
    """No window opened by the duty thread itself: the caller says how."""
    with pytest.raises(TypeError):
        tcosts.ProfileDutyCycle(period_s=60.0, window_s=0.01)
