"""The port's profiling helpers (``utils/profiling.py``) on the CPU, where the
host clock stands in for CUDA events: the adaptive two-point slope on a fake
loop of known cost (it escalates while the difference is under its floor and
divides by the gap it measured), the latency tracker against the JAX
package's, the chained and queued timers, and a ``torch.profiler`` trace
written as a Chrome trace. The CUDA-event paths run on the card
(``chip_smoke.py`` phase 10, through ``utils/roofline.py``).
"""

import json
import time

import numpy as np
import pytest
import torch

from traversability_estimation_tpu.utils.profiling import LatencyTracker as JaxTracker
from traversability_estimation_tpu_torch.utils import profiling

COST_S = 1e-3  # the fake loop's cost per iteration


class _FakeClock:
    """The host timer ``profiling`` reads, advanced only by the fake loop:
    a loop of k iterations takes exactly k * COST_S, whatever the host's
    load (a sleep's jitter under parallel test workers exceeds the bars)."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now


@pytest.fixture
def clock(monkeypatch):
    fake = _FakeClock()
    monkeypatch.setattr(profiling, "time", fake)
    return fake


def _fake_loop(clock):
    def make(k):
        def run(_):
            clock.now += k * COST_S
        return run
    return make


@pytest.mark.parametrize("max_escalations, gap", [(3, 64), (1, 4), (0, 1)])
def test_adaptive_slope_escalates_and_divides_by_the_measured_gap(clock, max_escalations, gap):
    logs = []
    s = profiling.adaptive_slope_stats(_fake_loop(clock), torch.zeros(1), 1, 2, min_diff_s=20e-3,
                                       reps=3, max_escalations=max_escalations, log=logs.append)
    # K quadruples from (1, 2) while the difference (K2 - K1) * 1 ms is under
    # 20 ms: (4, 8), (16, 32), (64, 128); each escalation logs once
    assert s["k_gap"] == gap
    assert len(logs) == max_escalations
    assert s["n"] == 3 and s["lo_s"] <= s["median_s"] <= s["hi_s"]
    # a difference of one iteration is within the sleep's jitter, and the
    # paired (median) slope needs the longest loops
    if gap >= 4:
        assert s["slope_s"] == pytest.approx(COST_S, rel=0.25)
    if gap >= 64:
        assert s["median_s"] == pytest.approx(COST_S, rel=0.25)


def test_adaptive_slope_is_the_stats_slope(clock):
    got = profiling.adaptive_slope(_fake_loop(clock), torch.zeros(1), 8, 16, min_diff_s=1e-3)
    assert got == pytest.approx(COST_S, rel=0.25)


def test_latency_tracker_equals_jax():
    rng = np.random.default_rng(0)
    samples = rng.exponential(0.004, 137).tolist()
    mine, theirs = profiling.LatencyTracker(max_samples=100), JaxTracker(max_samples=100)
    for s in samples:
        mine.record(s)
        theirs.record(s)
    assert mine.samples == theirs.samples and len(mine.samples) == 100
    assert mine.summary() == theirs.summary()
    assert profiling.LatencyTracker().summary() == {}
    with mine.timed():
        time.sleep(1e-3)
    assert mine.samples[-1] >= 1e-3


def test_timed_device_and_chained_device_time_on_cpu():
    x = torch.ones(64, 64)
    t, out = profiling.timed_device(lambda a, b: a * b + 1.0, x, x, reps=4)
    assert t > 0.0 and torch.equal(out, torch.full((64, 64), 2.0))
    calls = []

    def fn(a):
        calls.append(a)
        return {"y": a * 2.0}

    t = profiling.chained_device_time(fn, x, iters=5)
    assert t >= 0.0 and len(calls) == 10  # one warm-up chain and one timed chain
    # each call's input carries the previous output: 1 + 1e-18 * 2 rounds to 1
    assert all(torch.equal(c, x) for c in calls)


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with profiling.device_trace(str(tmp_path)):
        torch.ones(32, 32).matmul(torch.ones(32, 32))
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert trace["traceEvents"]
