"""Tracing and profiling hooks. Port of ``multiview_tpu/utils/profiling.py``.

The reference has only wall timers and Ceres' progress prints (SURVEY.md
5); here: a stage timer registry printed like the reference's wall-timer
lines (texture_processing.cc:282-288), a ``torch.profiler`` trace around
any pipeline stage written as a Chrome trace (chrome://tracing, Perfetto),
and named regions inside such a trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Dict, List

import torch

from multiview_tpu_torch.utils.device import resolve_device

_STAGES: List[tuple] = []


@contextlib.contextmanager
def stage(name: str, verbose: bool = True):
    """Wall-clock a pipeline stage: ``with profiling.stage("triangulation"):``.
    Work queued on a card inside the block is timed only as far as the
    block waits for it."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    _STAGES.append((name, dt))
    if verbose:
        print(f"{name} took {dt:.6g} seconds")


def stage_times() -> Dict[str, float]:
    """Seconds per stage name, summed over every time it ran since ``reset``."""
    out: Dict[str, float] = {}
    for name, dt in _STAGES:
        out[name] = out.get(name, 0.0) + dt
    return out


def reset():
    _STAGES.clear()


@contextlib.contextmanager
def device_trace(logdir: str, with_host: bool = True, device=None):
    """``torch.profiler`` trace of the block, written into ``logdir`` as a
    Chrome trace (``trace_<pid>_<ms>.json``). ``device`` (None: the first
    CUDA card, an error when there is none; "cpu" traces a run on the CPU)
    selects CUDA activity; ``with_host`` adds the CPU side (operators and
    launches). Yields the profiler, whose ``key_averages()`` sums the time by
    kernel::

        with profiling.device_trace("/tmp/trace"):
            solver(cam0, pts)
    """
    from torch.profiler import ProfilerActivity, profile

    device = resolve_device(device)
    activities = [ProfilerActivity.CUDA] if device.type == "cuda" else []
    if with_host or device.type == "cpu":
        activities.append(ProfilerActivity.CPU)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    with prof:
        yield prof
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(str(Path(logdir) / f"trace_{os.getpid()}_"
                                 f"{int(time.time() * 1000)}.json"))


def annotate(name: str):
    """A named region inside a trace (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)
