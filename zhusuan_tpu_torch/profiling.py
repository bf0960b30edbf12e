"""Tracing, profiling and throughput meters (port of
``zhusuan_tpu/profiling.py``).

- :func:`named_scope`: ``torch.profiler.record_function``; annotate model
  functions and loops so a trace names them.
- :func:`span`: the program's own annotation, a ``record_function`` only
  while a profiler records and a shared no-op otherwise, so it can sit in
  the run loops and kernel wrappers. Its ``zs.*`` spans (run loop,
  adaptation, transitions, kernel launches, host reads) land in the trace
  :func:`trace` writes.
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

__all__ = ["named_scope", "span", "trace", "SpeedMeter", "ess_per_sec"]

named_scope = torch.profiler.record_function

# The flag torch.profiler sets while it records (on start, off on stop):
# one attribute read, where entering a record_function costs a call into
# torch whether or not anything records.
_autograd_profiler = torch.autograd.profiler


class _NoSpan:
    """The span of a run that nothing profiles: enters and exits doing
    nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def span(name: str):
    """A context manager naming the enclosed block ``name`` in a profiler
    trace (a ``user_annotation`` on the clock of the device operations it
    launches; nested spans nest). While no ``torch.profiler`` records it
    is one shared no-op: it reads one flag, allocates nothing and calls
    nothing of torch's."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch.profiler.record_function(name)


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
