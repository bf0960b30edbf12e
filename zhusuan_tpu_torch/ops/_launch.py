"""The one launch path of the kernel wrappers.

Every ``csrc/*.cu`` entry has the form ``int zs_<name>(..., void* stream)``
and returns the CUDA error code of its launch. :func:`launch_kernel` calls
one on the current stream of the tensors' device and does what every wrapper
owes a launch: a non-zero code raises with the CUDA error string, a launch
that went through adds one to the wrapper's ``launches`` and records its
float check inside :func:`~.checks.checked` (:func:`~.checks.record_kernel`).
Nothing synchronises and nothing is caught. Each launch is a ``zs.launch``
span (:func:`~zhusuan_tpu_torch.profiling.span`), so a profiler's trace
gives the host's time per launch.

It is kept light, because a small kernel's back-to-back time is the host's
time to launch it: the typed ctypes function is looked up once per entry,
the raw stream is read without building a ``torch.cuda.Stream``, and the
device is switched only when it is not the current one.
"""

from __future__ import annotations

import torch

from zhusuan_tpu_torch.ops.checks import record_kernel
from zhusuan_tpu_torch.profiling import span

__all__ = ["launch_kernel", "current_stream_pointer"]

# (kernel_library, entry name) -> (the entry, the library's error-string
# function); filled at an entry's first launch.
_ENTRIES = {}


def current_stream_pointer(index: int) -> int:
    """The ``cudaStream_t`` of device ``index``'s current stream, as an
    int."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(index)
    return torch.cuda.current_stream(index).cuda_stream


def _entry(kernel_library, name):
    fns = _ENTRIES.get((kernel_library, name))
    if fns is None:
        lib, _ = kernel_library()
        fns = (getattr(lib, name), lib.zs_cuda_error_string)
        _ENTRIES[(kernel_library, name)] = fns
    return fns


def launch_kernel(wrapper, kernel_library, entry: str, device, *args,
                  inputs=(), outputs=()):
    """Call ``entry(*args, stream)`` of the library that ``kernel_library()``
    returns (``(cdll, build_record)``, argument types already set), on
    ``device``'s current stream.

    :param wrapper: the public function the launch is counted on
        (``wrapper.launches``) and named after in an error.
    :param device: the CUDA ``torch.device`` of the tensors in ``args``.
    :param inputs, outputs: the tensors the kernel reads and writes (None
        entries skipped), for :func:`~.checks.record_kernel`.
    :raises RuntimeError: when the entry returns a non-zero CUDA error code.
    """
    with span("zs.launch"):
        fn, error_string = _entry(kernel_library, entry)
        current = torch.cuda.current_device()
        index = current if device.index is None else device.index
        if index == current:
            rc = fn(*args, current_stream_pointer(index))
        else:
            with torch.cuda.device(index):
                rc = fn(*args, current_stream_pointer(index))
        if rc != 0:
            raise RuntimeError("{} launch failed: CUDA error {} ({})."
                               .format(wrapper.__name__, rc,
                                       error_string(rc).decode()))
        wrapper.launches += 1
        record_kernel(wrapper.__name__, inputs, outputs)
