"""``zhusuan_tpu_torch.ops.checks.checked`` against
``zhusuan_tpu/ops/checks.py::checked`` (``tests/test_ops.py``'s checked
tests, translated): a failing ``check_numerics`` site and a NaN made inside
``fn`` raise with their messages when the call returns; a clean call
returns ``fn``'s output unchanged. Kernels keep running inside the call,
and each launch records its own float check (checked here through
``launch_kernel`` with a stub entry in place of a CUDA kernel).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zhusuan_tpu_torch as zt
from zhusuan_tpu.ops.checks import check_numerics as jax_check_numerics
from zhusuan_tpu.ops.checks import checked as jax_checked
from zhusuan_tpu_torch.mcmc.hmc import use_kernel
from zhusuan_tpu_torch.ops import _launch
from zhusuan_tpu_torch.ops.checks import (
    check_numerics,
    checked,
    float_checks,
    user_checks,
)


def _jax_message(fn, x):
    with pytest.raises(Exception) as e:
        jax_checked(fn)(jnp.asarray(x))
    return str(e.value)


def test_checked_raises_deterministically_with_jax_message():
    g = checked(lambda x: check_numerics(x, "probe") * 2)
    with pytest.raises(FloatingPointError, match="probe") as e:
        g(torch.tensor([1.0, math.nan]))
    want = _jax_message(lambda x: jax_check_numerics(x, "probe") * 2,
                        [1.0, np.nan])
    assert str(e.value) in want
    x = torch.tensor([1.0, 2.0])
    assert torch.equal(g(x), torch.tensor([2.0, 4.0]))


def test_checked_loop_reports_the_first_failing_site():
    """The counterpart of checkify under ``lax.scan``: a loop of sites,
    the second and third failing; the first failing one is reported."""

    def body(xs):
        c = torch.zeros(())
        for i, x in enumerate(xs):
            c = c + check_numerics(x, "elt-{}".format(i))
        return c

    h = checked(body)
    with pytest.raises(FloatingPointError, match="elt-1"):
        h(torch.tensor([1.0, math.nan, math.inf]))
    assert float(h(torch.tensor([1.0, 2.0]))) == 3.0


def test_sites_are_read_once_at_return():
    """Inside ``checked`` a failing site does not stop ``fn``: the flag is
    read when it returns."""
    reached = []

    def fn(x):
        y = check_numerics(x, "early")
        reached.append(True)
        return y + 1

    with pytest.raises(FloatingPointError, match="early"):
        checked(fn)(torch.tensor(math.inf))
    assert reached == [True]
    with pytest.raises(FloatingPointError, match="early"):
        fn(torch.tensor(math.inf))  # outside checked: at once
    assert reached == [True]


def test_float_checks_catch_produced_nan():
    g = checked(lambda x: torch.log(x))  # log(-1) -> nan, no user check
    with pytest.raises(FloatingPointError, match="nan") as e:
        g(torch.tensor(-1.0))
    assert "log" in str(e.value)
    with pytest.raises(Exception, match="nan"):
        jax_checked(lambda x: jnp.log(x))(jnp.asarray(-1.0))
    assert float(g(torch.tensor(1.0))) == 0.0


def test_float_checks_in_place_and_inside_a_larger_fn():
    def fn(x):
        y = torch.exp(x) - 1.0
        z = y.clone()
        z.log_()  # NaN made in place where y < 0
        return z.sum() + 1

    with pytest.raises(FloatingPointError, match="log_"):
        checked(fn)(torch.tensor([-1.0, 2.0]))
    np.testing.assert_allclose(float(checked(fn)(torch.tensor([1.0, 2.0]))),
                               float(fn(torch.tensor([1.0, 2.0]))))


def test_propagated_nan_and_nan_fill_are_not_flagged():
    """A NaN that came in with the inputs, a NaN fill value (the samplers'
    cache sentinel) and uninitialised memory are not made by the op."""

    def fn(x):
        s = torch.full_like(x, float("nan"))
        torch.empty(1000)
        return x * 2, s

    out, s = checked(fn, errors=float_checks)(torch.tensor([math.nan, 1.0]))
    assert torch.isnan(out[0]) and out[1] == 2.0 and torch.isnan(s).all()


def test_error_sets():
    both = lambda x: check_numerics(torch.log(x), "site")  # noqa: E731
    x = torch.tensor(-1.0)
    with pytest.raises(FloatingPointError, match="nan generated"):
        checked(both, errors=float_checks)(x)
    with pytest.raises(FloatingPointError, match="site"):
        checked(both, errors=user_checks)(x)
    # the float check's op comes first in the call
    with pytest.raises(FloatingPointError, match="nan generated"):
        checked(both)(x)
    assert torch.isnan(checked(both, errors=frozenset())(x))
    with pytest.raises(ValueError, match="subset"):
        checked(both, errors={"div"})


def test_clean_call_returns_identical_output():
    torch.manual_seed(0)
    x = torch.randn(16, 8, dtype=torch.float64)

    def fn(x):
        y = torch.softmax(x @ x.T, -1)
        return check_numerics(y, "softmax") * torch.tanh(x.sum())

    assert torch.equal(checked(fn)(x), fn(x))


def test_hmc_under_checked_raises_on_a_bad_start():
    """HMC's own ``check_numerics`` site records inside ``checked`` and the
    call raises with the sampler's message when it returns."""
    hmc = zt.HMC(step_size=0.1, n_leapfrogs=2, check_numerics=True)

    def lj(obs):
        return torch.sum(-0.5 * obs["x"] ** 2 - torch.log(obs["x"]), -1)

    state = hmc.init({"x": -torch.ones(3, 2, dtype=torch.float64)},
                     n_chain_dims=1)
    with pytest.raises(FloatingPointError, match="old_log_prob"):
        checked(lambda s: hmc.sample(lj, {}, s, (0, 1)),
                errors=user_checks)(state)
    good = hmc.init({"x": torch.ones(3, 2, dtype=torch.float64)},
                    n_chain_dims=1)
    a, _ = checked(lambda s: hmc.sample(lj, {}, s, (0, 1)))(good)
    b, _ = hmc.sample(lj, {}, good, (0, 1))
    assert torch.equal(a.q["x"], b.q["x"])


class _CardTensor:
    is_cuda = True


def test_kernel_gates_are_unchanged_inside_checked():
    q = {"x": _CardTensor()}
    for flag in ("auto", True):
        assert use_kernel(flag, q, lambda: None)
        assert checked(lambda f=flag: use_kernel(f, q, lambda: None))()


class _StubKernel:
    """Stands for a loaded library whose ``zs_stub`` entry "writes" the
    kernel's output: ``fill`` into ``out``."""

    def __init__(self, out, fill):
        self.out, self.fill = out, fill

    def zs_stub(self, *args):
        self.out.fill_(self.fill)
        return 0

    @staticmethod
    def zs_cuda_error_string(code):
        return b"stub"


def _stub_launch(monkeypatch, fill, inputs):
    """One ``launch_kernel`` through a stub entry on "device 0" (the CUDA
    look-ups replaced) whose output is ``fill`` everywhere; returns the
    output."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(_launch, "current_stream_pointer", lambda i: 0)
    monkeypatch.setattr(_launch, "_ENTRIES", {})
    out = torch.zeros(3, 4)
    lib = _StubKernel(out, fill)

    def fused_stub():
        pass

    fused_stub.launches = 0
    _launch.launch_kernel(fused_stub, lambda: (lib, {}), "zs_stub",
                          torch.device("cuda", 0), inputs=inputs,
                          outputs=(out, torch.zeros(3, dtype=torch.int32)))
    assert fused_stub.launches == 1
    return out


def test_a_kernel_launch_records_its_float_check(monkeypatch):
    clean = (torch.ones(3, 4), None)
    with pytest.raises(FloatingPointError,
                       match="nan generated by kernel: fused_stub"):
        checked(lambda: _stub_launch(monkeypatch, math.nan, clean))()
    # A NaN the inputs brought, a clean output, the user checks alone and
    # no checked() call: no error.
    nan_in = (torch.tensor([1.0, math.nan]),)
    assert torch.isnan(checked(
        lambda: _stub_launch(monkeypatch, math.nan, nan_in))()).all()
    assert torch.equal(checked(
        lambda: _stub_launch(monkeypatch, 2.0, clean))(),
        torch.full((3, 4), 2.0))
    assert torch.isnan(checked(
        lambda: _stub_launch(monkeypatch, math.nan, clean),
        errors=user_checks)()).all()
    assert torch.isnan(_stub_launch(monkeypatch, math.nan, clean)).all()


def test_exported_from_ops():
    assert zt.ops.checked is checked
    assert zt.ops.check_numerics is check_numerics
