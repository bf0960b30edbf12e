"""Tests of zhusuan_tpu_torch/ops/_launch.py (the kernel wrappers' one
launch path) on the CPU, with a stub object in place of the ``ctypes.CDLL``
and the two CUDA look-ups (current device, raw stream) replaced: the entry
is resolved and cached once, the arguments reach it unchanged with the
stream last, a non-zero return raises with the library's error string, only
a launch that went through is counted, and nothing is caught.

Imports no jax, so its ``cuda`` test also runs on a GPU host:
``python3 -m pytest --noconftest -m cuda tests/test_torch_ops_launch.py``.
"""

import pytest
import torch

from zhusuan_tpu_torch.ops import _launch

STREAM = 0xABCDEF


class _StubLibrary:
    """Stands for a loaded ``csrc`` library: ``zs_stub`` records its call
    and returns ``self.rc``; every attribute look-up is counted."""

    def __init__(self, rc=0):
        self.rc = rc
        self.calls = []
        self.lookups = []

    def __getattr__(self, name):
        self.lookups.append(name)
        if name == "zs_stub":
            def entry(*args):
                self.calls.append(args)
                return self.rc
            return entry
        if name == "zs_boom":
            def boom(*args):
                raise KeyError("from inside the entry")
            return boom
        if name == "zs_cuda_error_string":
            return lambda code: "stub error {}".format(code).encode()
        raise AttributeError(name)


def _library_of(lib):
    """A ``kernel_library`` function as the wrappers have one, counting its
    calls."""
    def kernel_library():
        kernel_library.calls += 1
        return lib, {"path": "stub"}

    kernel_library.calls = 0
    return kernel_library


def _wrapper():
    def fused_stub():
        pass

    fused_stub.launches = 0
    return fused_stub


@pytest.fixture
def on_device_zero(monkeypatch):
    """Device 0 current, its stream ``STREAM``; entering another device
    is recorded."""
    entered = []

    class _Device:
        def __init__(self, index):
            self.index = index

        def __enter__(self):
            entered.append(self.index)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device", _Device)
    monkeypatch.setattr(_launch, "current_stream_pointer",
                        lambda index: STREAM + index)
    return entered


def test_resolves_the_entry_once_and_passes_arguments_through(
        on_device_zero):
    lib = _StubLibrary()
    kernel_library, wrapper = _library_of(lib), _wrapper()
    dev = torch.device("cuda", 0)
    _launch.launch_kernel(wrapper, kernel_library, "zs_stub", dev, 11, None,
                          2.5)
    _launch.launch_kernel(wrapper, kernel_library, "zs_stub", dev, 12)
    _launch.launch_kernel(wrapper, kernel_library, "zs_stub", dev)
    assert lib.calls == [(11, None, 2.5, STREAM), (12, STREAM), (STREAM,)]
    assert kernel_library.calls == 1
    assert lib.lookups == ["zs_stub", "zs_cuda_error_string"]
    assert wrapper.launches == 3
    assert on_device_zero == []  # the current device is not entered again


def test_each_library_and_entry_has_its_own_cache_line(on_device_zero):
    lib_a, lib_b = _StubLibrary(), _StubLibrary()
    ka, kb, wrapper = _library_of(lib_a), _library_of(lib_b), _wrapper()
    dev = torch.device("cuda", 0)
    _launch.launch_kernel(wrapper, ka, "zs_stub", dev, 1)
    _launch.launch_kernel(wrapper, kb, "zs_stub", dev, 2)
    _launch.launch_kernel(wrapper, ka, "zs_stub", dev, 3)
    assert lib_a.calls == [(1, STREAM), (3, STREAM)]
    assert lib_b.calls == [(2, STREAM)]
    assert (ka.calls, kb.calls) == (1, 1)


@pytest.mark.parametrize("device,entered,stream", [
    (torch.device("cuda"), [], STREAM),  # no index: the current device
    (torch.device("cuda", 0), [], STREAM),
    (torch.device("cuda", 1), [1], STREAM + 1),
])
def test_another_device_is_entered_and_its_stream_used(
        on_device_zero, device, entered, stream):
    lib = _StubLibrary()
    _launch.launch_kernel(_wrapper(), _library_of(lib), "zs_stub", device, 5)
    assert on_device_zero == entered
    assert lib.calls == [(5, stream)]


@pytest.mark.parametrize("rc", [1, 700])
def test_a_failed_launch_raises_with_the_error_string(on_device_zero, rc):
    lib = _StubLibrary(rc=rc)
    kernel_library, wrapper = _library_of(lib), _wrapper()
    with pytest.raises(RuntimeError) as err:
        _launch.launch_kernel(wrapper, kernel_library, "zs_stub",
                              torch.device("cuda", 0), 1)
    message = str(err.value)
    assert "fused_stub" in message and "CUDA error {}".format(rc) in message
    assert "stub error {}".format(rc) in message
    assert wrapper.launches == 0  # a refused launch is not counted
    lib.rc = 0
    _launch.launch_kernel(wrapper, kernel_library, "zs_stub",
                          torch.device("cuda", 0), 1)
    assert wrapper.launches == 1


def test_nothing_is_swallowed(on_device_zero):
    lib, wrapper = _StubLibrary(), _wrapper()
    dev = torch.device("cuda", 0)
    with pytest.raises(KeyError, match="from inside the entry"):
        _launch.launch_kernel(wrapper, _library_of(lib), "zs_boom", dev, 1)
    with pytest.raises(AttributeError, match="zs_missing"):
        _launch.launch_kernel(wrapper, _library_of(lib), "zs_missing", dev)

    def failing_library():
        raise OSError("nvcc not found")

    with pytest.raises(OSError, match="nvcc not found"):
        _launch.launch_kernel(wrapper, failing_library, "zs_stub", dev)
    # A library that failed to load is asked for again, not cached.
    with pytest.raises(OSError, match="nvcc not found"):
        _launch.launch_kernel(wrapper, failing_library, "zs_stub", dev)
    assert wrapper.launches == 0


def test_the_stream_pointer_falls_back_to_the_public_call(monkeypatch):
    class _Stream:
        cuda_stream = 77

    monkeypatch.delattr(torch._C, "_cuda_getCurrentRawStream",
                        raising=False)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda index: _Stream)
    assert _launch.current_stream_pointer(0) == 77
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 1000 + index, raising=False)
    assert _launch.current_stream_pointer(3) == 1003


WRAPPER_MODULES = ["hmc_step", "chees_step", "leapfrog", "nuts_step",
                   "sgld_step", "psgld_step", "sghmc_step", "sgnht_step",
                   "advi_step", "linalg", "random"]


@pytest.mark.parametrize("name", WRAPPER_MODULES)
def test_every_wrapper_launches_through_the_helper(name):
    """No wrapper keeps a launch path of its own: none reads a stream,
    enters a device, counts a launch or reads an error string itself, and
    none has a ``try`` (a CUDA tensor launches the kernel or raises)."""
    import importlib
    import inspect

    module = importlib.import_module("zhusuan_tpu_torch.ops." + name)
    source = inspect.getsource(module)
    assert "launch_kernel(" in source
    for banned in ("current_stream", "torch.cuda.device(", ".launches += 1",
                   "zs_cuda_error_string(rc)", "try:"):
        assert banned not in source, (name, banned)


@pytest.mark.cuda
def test_on_the_card_the_raw_stream_is_the_current_stream():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert _launch.current_stream_pointer(0) == \
        torch.cuda.current_stream(0).cuda_stream
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        assert _launch.current_stream_pointer(0) == side.cuda_stream
