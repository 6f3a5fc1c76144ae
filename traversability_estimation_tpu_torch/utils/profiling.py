"""Profiling and runtime statistics: per-tick latency percentiles for online
loops, ``torch.profiler`` traces, and device timing with CUDA events.

Device times come from ``torch.cuda.Event`` pairs recorded on the current
stream around the work, read after the end event has completed. Where the
work runs on CPU tensors, ``time.perf_counter`` around the work stands in for
the events (PyTorch's CPU ops return when they are done), so the same code
measures both; a CPU time is the CPU's, never the card's.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from dataclasses import dataclass, field
from typing import Dict, List

import torch


@dataclass
class LatencyTracker:
    """Rolling latency stats for an online loop (config-4 style)."""

    samples: List[float] = field(default_factory=list)
    max_samples: int = 10_000

    def record(self, seconds: float):
        self.samples.append(seconds)
        if len(self.samples) > self.max_samples:
            del self.samples[: len(self.samples) - self.max_samples]

    @contextlib.contextmanager
    def timed(self):
        t0 = time.perf_counter()
        yield
        self.record(time.perf_counter() - t0)

    def summary(self) -> Dict[str, float]:
        if not self.samples:
            return {}
        s = sorted(self.samples)
        n = len(s)
        return {
            "n": n,
            "p50_ms": 1e3 * s[n // 2],
            "p90_ms": 1e3 * s[min(n - 1, int(0.9 * n))],
            "p99_ms": 1e3 * s[min(n - 1, int(0.99 * n))],
            "mean_ms": 1e3 * statistics.fmean(s),
            "max_ms": 1e3 * s[-1],
        }


def _on_cuda(obj) -> bool:
    """Whether `obj` (a tensor, or a list / tuple / dict holding tensors)
    holds a CUDA tensor."""
    if isinstance(obj, torch.Tensor):
        return obj.is_cuda
    if isinstance(obj, dict):
        return any(_on_cuda(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return any(_on_cuda(v) for v in obj)
    return False


def _timed_call(fn, arg, cuda: bool) -> float:
    """Seconds of ``fn(arg)``: CUDA events on the current stream around it
    when `cuda`, else the host clock."""
    if not cuda:
        t0 = time.perf_counter()
        fn(arg)
        return time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn(arg)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


@contextlib.contextmanager
def device_trace(out_dir: str):
    """Trace the enclosed work with ``torch.profiler`` (CPU activity, and
    CUDA activity where a card is present) and write it as a Chrome trace,
    ``<out_dir>/trace.json`` (chrome://tracing or Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))


def timed_device(fn, *args, reps: int = 10, **kwargs):
    """Mean seconds per call of ``fn(*args, **kwargs)`` over `reps` calls
    queued back to back after one warm-up call, and the last output. On CUDA
    arguments, CUDA events on the current stream around the calls (the
    device's time for the queue, which includes the host's issue time
    wherever issuing is slower than the device); on CPU arguments, the host
    clock."""
    cuda = _on_cuda(args) or _on_cuda(kwargs)
    out = fn(*args, **kwargs)
    if cuda:
        torch.cuda.synchronize()
    outs = []

    def run(_):
        outs.extend(fn(*args, **kwargs) for _ in range(reps))

    return _timed_call(run, None, cuda) / reps, outs[-1]


def _first_element(out) -> torch.Tensor:
    """A float32 scalar from the first element of the first tensor in `out`."""
    if isinstance(out, torch.Tensor):
        return out.reshape(-1)[0].to(torch.float32)
    if isinstance(out, dict):
        out = list(out.values())
    for v in out:
        if isinstance(v, (torch.Tensor, dict, list, tuple)):
            return _first_element(v)
    raise TypeError("chained_device_time: fn returned no tensor")


def chained_device_time(fn, x: torch.Tensor, iters: int = 16, rtt: float = 0.0) -> float:
    """Seconds per call of ``fn(x)`` over `iters` DATA-CHAINED calls: each
    call's input is the previous input plus 1e-18 times the first element of
    the previous output, so no call can start before the one before it has
    finished, and none can be skipped. The calls run between two CUDA events
    on the current stream (the host clock on a CPU tensor), after one
    unmeasured warm-up chain; `rtt`, a fixed cost of the measurement itself,
    is subtracted."""
    cuda = x.is_cuda

    def chain(a):
        for _ in range(iters):
            a = a + 1e-18 * _first_element(fn(a)).to(a.dtype)
        return a

    chain(x)
    if cuda:
        torch.cuda.synchronize()
    return max(_timed_call(chain, x, cuda) - rtt, 0.0) / iters


def adaptive_slope(
    make_loop,
    arg,
    k1: int,
    k2: int,
    min_diff_s: float = 10e-3,
    reps: int = 3,
    max_escalations: int = 3,
    log=None,
) -> float:
    """Seconds per iteration from the two-point loop-length slope, with
    ADAPTIVE loop lengths: ``adaptive_slope_stats(...)["slope_s"]``.

    ``make_loop(k)`` returns a function that runs `k` iterations of the work
    on `arg`. The slope cancels every cost the two loop lengths share
    (launch, synchronisation, warm-up), but the timer's jitter rides on the
    t(K2) - t(K1) difference, so the difference must dominate it: if it
    lands under ``min_diff_s``, both K quadruple and the measurement
    repeats. The slope always divides by the K gap THAT WAS MEASURED.
    """
    return adaptive_slope_stats(
        make_loop, arg, k1, k2, min_diff_s, reps, max_escalations, log
    )["slope_s"]


def adaptive_slope_stats(
    make_loop,
    arg,
    k1: int,
    k2: int,
    min_diff_s: float = 10e-3,
    reps: int = 5,
    max_escalations: int = 3,
    log=None,
) -> dict:
    """``adaptive_slope`` with the spread over its repeats. Each loop is
    timed by CUDA events on the current stream when `arg` holds a CUDA
    tensor, else by the host clock.

    Returns a dict:
      slope_s   — (min(t2s) - min(t1s)) / the K gap (min against min is
                  the noise-floor pair)
      median_s  — median over per-repeat PAIRED slopes (t2s[r]-t1s[r])/gap;
                  paired differencing keeps each repeat's drift common-mode,
                  so the spread of these is the honest uncertainty
      lo_s/hi_s — min/max of the paired slopes
      n         — number of repeats, k_gap — the gap actually measured
    """
    cuda = _on_cuda(arg)
    diff, gap = 1e-9, k2 - k1
    t1s, t2s = [1e-9], [2e-9]
    for attempt in range(max_escalations + 1):
        f1, f2 = make_loop(k1), make_loop(k2)
        _timed_call(f1, arg, cuda)
        _timed_call(f2, arg, cuda)  # warm both
        t1s, t2s = [], []
        for _ in range(reps):
            t1s.append(_timed_call(f1, arg, cuda))
            t2s.append(_timed_call(f2, arg, cuda))
        diff = min(t2s) - min(t1s)
        gap = k2 - k1
        if diff >= min_diff_s or attempt == max_escalations:
            break
        k1, k2 = k1 * 4, k2 * 4
        if log is not None:
            log(
                f"slope below timing resolution ({diff*1e3:.2f} ms); "
                f"retrying with K={k1}/{k2}"
            )
    paired = sorted(max(t2 - t1, 1e-9) / gap for t1, t2 in zip(t1s, t2s))
    n = len(paired)
    median = (
        paired[n // 2] if n % 2 else 0.5 * (paired[n // 2 - 1] + paired[n // 2])
    )
    return {
        "slope_s": max(diff, 1e-9) / gap,
        "median_s": median,
        "lo_s": paired[0],
        "hi_s": paired[-1],
        "n": n,
        "k_gap": gap,
    }
