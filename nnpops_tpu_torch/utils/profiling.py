"""Step timing, tracing and MD observability (port of
``nnpops_tpu.utils.profiling``).

* :class:`StepTimer`: steady-state per-call latency with warm-up. A call
  whose outputs lie on the card is timed by CUDA events with a
  synchronize after each call (the counterpart of
  ``jax.block_until_ready``: PyTorch returns before the card finishes); a
  call whose outputs lie on the CPU by ``time.perf_counter``.
* :func:`trace`: a context manager over ``torch.profiler`` (CPU activity,
  and CUDA activity where a card is present) that writes a Chrome trace
  into ``log_dir``.
* :class:`EnergyDriftMonitor`: the MD loop's health counter, the total
  energy's drift per picosecond against a tolerance.
* :func:`span`: a named range of the port's own (``nnpops.<name>``) in
  the ``torch.profiler`` trace, on the profiler's clock beside the device
  activity; with no profiler running it does nothing.
* :data:`COUNTERS`: the port's host-to-device uploads (count and bytes),
  builds of a model's device tables, CFConv, PaiNN and MACE lanes, MACE
  contractions, always counted;
  :func:`reset_counters` zeroes them.
* :func:`recording`: a spy on a module's function that keeps every call's
  arguments, so a check can replay a kernel on the inputs a path gives it.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, List, Optional

import numpy as np
import torch

# Since the process started or since :func:`reset_counters`: host-to-device
# uploads made through ``ops.aev_blocked.upload``, builds of a model's
# device tables (``ANIModel._device_arrays``, once per model and device),
# the lanes (rows x K, read from host shapes) of every convolution
# through ``ops.cfconv.cfconv_masked``, of every PaiNN message through
# ``ops.painn.painn_message`` and of every MACE message through
# ``ops.mace.mace_message``, and the atom-channel pairs (N x F) of every
# MACE symmetric contraction (``ops.mace.symmetric_contraction``).
COUNTERS = {'uploads': 0, 'upload_bytes': 0, 'selection_table_builds': 0,
            'cfconv_lanes': 0, 'painn_lanes': 0, 'mace_lanes': 0,
            'mace_contractions': 0}

_NO_SPAN = contextlib.nullcontext()


def reset_counters() -> None:
    for key in COUNTERS:
        COUNTERS[key] = 0


def span(name: str):
    """``torch.profiler.record_function('nnpops.' + name)`` while a
    profiler (``torch.profiler``, or ``emit_nvtx`` under Nsight) is
    running, else one shared no-op context: the check is one C call, and
    it allocates, syncs and launches nothing. A span's device work is
    joined to it by the trace's correlation ids."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function('nnpops.' + name)


@contextlib.contextmanager
def recording(module, name: str, calls: list):
    """Wrap ``module.name`` for the enclosed block so that every call's
    ``(args, kwargs)`` is appended to ``calls``; the wrapped function still
    runs, and the original is put back on exit, also when the block
    raises."""
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    setattr(module, name, spy)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def _cuda_device(out) -> Optional[torch.device]:
    """The CUDA device of the first tensor in ``out`` (nested tuples,
    lists and dicts), or None if no tensor of it lies on a card."""
    if isinstance(out, torch.Tensor):
        return out.device if out.device.type == 'cuda' else None
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (tuple, list)):
        for item in out:
            dev = _cuda_device(item)
            if dev is not None:
                return dev
    return None


class StepTimer:
    """Measure the steady-state per-call latency of ``fn``."""

    def __init__(self, fn: Callable, warmup: int = 3):
        self.fn = fn
        self.warmup = warmup

    def measure(self, *args, iters: int = 20) -> dict:
        out = None
        for _ in range(self.warmup):
            out = self.fn(*args)
        device = _cuda_device((out, args))
        if device is not None:
            torch.cuda.synchronize(device)
        times = []
        for _ in range(iters):
            if device is None:
                t0 = time.perf_counter()
                self.fn(*args)
                times.append(time.perf_counter() - t0)
                continue
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            self.fn(*args)
            end.record()
            torch.cuda.synchronize(device)
            times.append(start.elapsed_time(end) * 1e-3)
        times = np.asarray(times)
        return {
            'mean_us': float(times.mean() * 1e6),
            'median_us': float(np.median(times) * 1e6),
            'p10_us': float(np.percentile(times, 10) * 1e6),
            'p90_us': float(np.percentile(times, 90) * 1e6),
            'iters': iters,
        }


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block with ``torch.profiler`` and write its
    Chrome trace to ``log_dir/trace.json``; yields the profiler (its
    ``key_averages()`` hold the sums by operator and kernel)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))


class EnergyDriftMonitor:
    """Track the total-energy drift of an MD trajectory.

    Feed (time_ps, total_energy) samples; ``drift_per_ps`` is the slope of
    the least-squares line, the standard MD health metric. ``check``
    raises if the drift exceeds the tolerance."""

    def __init__(self, tolerance_per_ps: Optional[float] = None):
        self.times: List[float] = []
        self.energies: List[float] = []
        self.tolerance = tolerance_per_ps

    def record(self, time_ps: float, total_energy: float) -> None:
        if not np.isfinite(total_energy):
            raise RuntimeError(
                f'non-finite total energy at t={time_ps} ps: {total_energy}')
        self.times.append(float(time_ps))
        self.energies.append(float(total_energy))

    @property
    def drift_per_ps(self) -> float:
        if len(self.times) < 2:
            return 0.0
        slope, _ = np.polyfit(self.times, self.energies, 1)
        return float(slope)

    def check(self) -> None:
        if self.tolerance is not None and abs(self.drift_per_ps) > self.tolerance:
            raise RuntimeError(
                f'energy drift {self.drift_per_ps:.3g}/ps exceeds tolerance '
                f'{self.tolerance:.3g}/ps')
