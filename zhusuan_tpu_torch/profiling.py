"""Tracing, profiling and throughput meters (port of
``zhusuan_tpu/profiling.py``).

- :func:`named_scope`: ``torch.profiler.record_function``; annotate model
  functions and loops so a trace names them.
- :func:`trace`: a context manager around ``torch.profiler.profile`` over
  the CPU and, where there is one, the card, writing a trace that
  TensorBoard's profiler plugin or Perfetto loads (``*.pt.trace.json``)
  into ``log_dir``.
- :class:`SpeedMeter`: steps/sec and items/sec meter for training loops.
- :func:`ess_per_sec`: effective samples per second for a chain tensor and
  its wall-clock.
"""

from __future__ import annotations

import contextlib
import time

import torch

__all__ = ["named_scope", "trace", "SpeedMeter", "ess_per_sec"]

named_scope = torch.profiler.record_function


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block into ``log_dir`` (one
    ``<host>_<pid>.<time>.pt.trace.json`` a block). Yields the
    ``torch.profiler.profile`` object, whose ``key_averages()`` tabulates
    the ops after the block."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)) as prof:
        yield prof


class SpeedMeter:
    """Throughput meter: call :meth:`tick` once per step."""

    def __init__(self, items_per_step: int = 1):
        self.items_per_step = items_per_step
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._steps = 0

    def tick(self, n_steps: int = 1):
        self._steps += n_steps

    @property
    def steps_per_sec(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._steps / dt if dt > 0 else float("inf")

    @property
    def items_per_sec(self) -> float:
        return self.steps_per_sec * self.items_per_step

    def __repr__(self):
        return "<SpeedMeter {:.1f} steps/s, {:.1f} items/s>".format(
            self.steps_per_sec, self.items_per_sec)


def ess_per_sec(samples, wall_seconds: float) -> float:
    """Total effective samples per second for stacked chain output: the
    smallest ESS over each chain's dims, summed over chains, over
    ``wall_seconds``. The ESS is computed on the samples' device
    (:func:`~zhusuan_tpu_torch.diagnostics.ess_batch_device`); one host
    read.

    :param samples: ``[n_iters, n_chains, dim]`` (or ``[n_iters, dim]``).
    :param wall_seconds: wall-clock of the sampling phase.
    """
    from zhusuan_tpu_torch.diagnostics import ess_batch_device

    samples = torch.as_tensor(samples)
    if samples.ndim == 2:
        samples = samples[:, None, :]
    t, c, d = samples.shape
    ess = ess_batch_device(samples.reshape(t, c * d)).reshape(c, d)
    return float(torch.amin(ess, dim=1).sum()) / wall_seconds
