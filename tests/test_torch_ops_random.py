"""Tests of zhusuan_tpu_torch/ops/random.py (the standalone samplers K12:
``gpu_normal`` and ``gpu_uniform``, and their plain versions) on the CPU.

Imports no jax, so its ``cuda`` tests also run on a GPU host:
``python3 -m pytest --noconftest -m cuda tests/test_torch_ops_random.py``.
On the CPU the wrappers run the plain versions (the torch Philox), which are
held here to the contract of ``tests/test_ops_random.py`` (shape, dtype,
range, moments, determinism per key, decorrelation between keys), to
Philox4x32-10's published test vectors and to the separation of the
package's streams; the CUDA kernels are held to the plain versions on the
card (the ``cuda`` tests below, and ``chip_smoke.py`` phase 16). The JAX
functions they replace read the TPU's hardware PRNG and have no CPU
lowering, so there is no draw-for-draw parity to hold.
"""

import numpy as np
import pytest
import torch

from zhusuan_tpu_torch.ops import _random
from zhusuan_tpu_torch.ops import random as zrandom

torch.set_num_threads(1)

KEY = (0x01234567, 0x89ABCDEF)
SAMPLERS = {"normal": (zrandom.gpu_normal, zrandom.gpu_normal_reference),
            "uniform": (zrandom.gpu_uniform, zrandom.gpu_uniform_reference)}


def test_philox_known_answers():
    """Random123's kat_vectors for philox4x32-10."""
    def run(counter, key):
        words = _random.philox4x32_10(
            *(torch.tensor(c, dtype=torch.int64) for c in counter), *key)
        return [int(w) for w in words]

    assert run((0, 0, 0, 0), (0, 0)) == [
        0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    assert run((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF)) == [
        0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]
    assert run((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
               (0xA4093822, 0x299F31D0)) == [
        0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]


@pytest.mark.parametrize("kind", ["normal", "uniform"])
@pytest.mark.parametrize("shape", [(256, 512), (1000, 37), (3, 5), (1, 1)])
def test_shape_dtype_and_determinism(kind, shape):
    fn, ref = SAMPLERS[kind]
    x = fn(KEY, shape, "cpu")
    assert tuple(x.shape) == shape and x.dtype == torch.float32
    assert torch.isfinite(x).all()
    assert torch.equal(x, fn(KEY, shape, "cpu"))  # one key repeats
    assert torch.equal(x, ref(KEY, shape, "cpu"))
    if x.numel() > 1:
        assert not torch.equal(x, fn((7, 8), shape, "cpu"))  # two differ


def test_normal_moments():
    """bench.py:225-227's gates at its 1024 x 1024."""
    x = zrandom.gpu_normal(KEY, (1024, 1024), "cpu").double()
    assert abs(float(x.mean())) < 0.005
    assert abs(float(x.std()) - 1.0) < 0.005
    # Both Box-Muller outputs of a pair are used: skewness and kurtosis too.
    assert abs(float((x ** 3).mean())) < 0.02
    assert abs(float((x ** 4).mean()) - 3.0) < 0.05
    # u1 is clamped at 1e-7: |x| <= sqrt(-2 log 1e-7) = 5.68.
    assert float(x.abs().max()) <= 5.7


def test_uniform_moments_and_range():
    """bench.py:228-230's gates at its 1024 x 1024."""
    u = zrandom.gpu_uniform(KEY, (1024, 1024), "cpu")
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    u = u.double()
    assert abs(float(u.mean()) - 0.5) < 0.002
    assert abs(float(u.var()) - 1.0 / 12.0) < 0.001


def test_rows_and_columns_are_uncorrelated():
    x = zrandom.gpu_normal(KEY, (4096, 64), "cpu").double()
    corr = np.corrcoef(x.numpy(), rowvar=False)
    off = corr - np.eye(64)
    assert np.abs(off).max() < 0.08  # 4096 rows: sd 1/64, 5 sd
    lag = float((x[:-1] * x[1:]).mean())
    assert abs(lag) < 0.01


def test_a_value_depends_on_its_position_alone():
    """No block grid: a smaller array is the corner of a larger one when
    the widths fill the same groups of 4 columns."""
    big = zrandom.gpu_normal(KEY, (64, 40), "cpu")
    assert torch.equal(zrandom.gpu_normal(KEY, (10, 40), "cpu"), big[:10])
    assert torch.equal(zrandom.gpu_normal(KEY, (64, 37), "cpu"), big[:, :37])
    big = zrandom.gpu_uniform(KEY, (64, 40), "cpu")
    assert torch.equal(zrandom.gpu_uniform(KEY, (64, 37), "cpu"),
                       big[:, :37])


# Widths on both of the kernel's store paths (a multiple of 4: one 16-byte
# store a group; else 4-byte stores) and at their edges.
STORE_PATH_SHAPES = [(5, 4), (7, 8), (2, 1028), (1, 1), (3, 5), (6, 1027)]


@pytest.mark.parametrize("kind", ["normal", "uniform"])
@pytest.mark.parametrize("shape", STORE_PATH_SHAPES)
def test_a_draw_is_the_leading_columns_of_a_wider_draw(kind, shape):
    """Group by group: element (row, col) is word ``col % 4`` of the Philox
    call counted ``(0, row, col // 4, stream)``, whatever the width, so a
    ``[rows, cols]`` draw equals the leading columns of a draw padded to
    the next multiple of 4, of a much wider one, and of a taller one."""
    fn, _ = SAMPLERS[kind]
    rows, cols = shape
    x = fn(KEY, shape, "cpu")
    padded = fn(KEY, (rows, 4 * ((cols + 3) // 4)), "cpu")
    assert torch.equal(x, padded[:, :cols])
    wide = fn(KEY, (rows + 3, cols + 64), "cpu")
    assert torch.equal(x, wide[:rows, :cols])
    for g in range((cols + 3) // 4):  # each group on its own
        lo, hi = 4 * g, min(4 * g + 4, cols)
        assert torch.equal(x[:, lo:hi], wide[:rows, lo:hi])


@pytest.mark.parametrize("kind", ["normal", "uniform"])
@pytest.mark.parametrize("cols", [4, 8, 1028, 5, 1027])
def test_moments_on_both_store_path_widths(kind, cols):
    fn, _ = SAMPLERS[kind]
    x = fn(KEY, (40000 // cols * 8 + 8, cols), "cpu").double()
    sd = 1.0 / np.sqrt(x.numel())
    if kind == "normal":
        assert abs(float(x.mean())) < 5 * sd
        assert abs(float(x.std()) - 1.0) < 5 * sd
    else:
        assert abs(float(x.mean()) - 0.5) < 5 * sd * 0.29
        assert float(x.min()) >= 0.0 and float(x.max()) < 1.0


def test_streams_are_separate():
    streams = {name: getattr(_random, name) for name in _random.__all__
               if name.startswith("STREAM_")}
    assert len(set(streams.values())) == len(streams), streams
    assert streams["STREAM_ADVI_NOISE"] == 0x300
    assert streams["STREAM_RANDOM_NORMAL"] == 0x400
    assert streams["STREAM_RANDOM_UNIFORM"] == 0x401
    shape = (32, 8)
    normal = zrandom.gpu_normal(KEY, shape, "cpu")
    for stream in (_random.STREAM_ADVI_NOISE, _random.STREAM_SGMCMC_NOISE,
                   _random.STREAM_RANDOM_UNIFORM):
        other = _random.philox_normal(KEY, 0, shape, stream, "cpu")
        assert not torch.equal(normal, other)
        assert abs(float((normal * other).mean())) < 0.25
    uniform = zrandom.gpu_uniform(KEY, shape, "cpu")
    assert torch.equal(uniform, _random.philox_uniform_rows(
        KEY, 0, shape, _random.STREAM_RANDOM_UNIFORM, "cpu"))


@pytest.mark.parametrize("kind", ["normal", "uniform"])
@pytest.mark.parametrize("shape", [(4,), (2, 3, 4), (0, 4), (4, 0), ()])
def test_only_2d_shapes(kind, shape):
    fn, _ = SAMPLERS[kind]
    assert not zrandom.random_supported(shape)
    with pytest.raises(ValueError, match="2-D shape"):
        fn(KEY, shape, "cpu")


def test_cpu_calls_do_not_count_as_launches():
    before = (zrandom.gpu_normal.launches, zrandom.gpu_uniform.launches)
    zrandom.gpu_normal(KEY, (3, 5), "cpu")
    zrandom.gpu_uniform(KEY, (3, 5), "cpu")
    assert (zrandom.gpu_normal.launches,
            zrandom.gpu_uniform.launches) == before
    assert zrandom.random_supported((1024, 1024))


# --------------------------------------------------------------------- #
# On the card: the kernels against the plain versions
# --------------------------------------------------------------------- #
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["normal", "uniform"])
@pytest.mark.parametrize("shape", [(1024, 1024), (1000, 37), (3, 5), (1, 1),
                                   (5, 4099), (5, 4), (7, 8), (2, 1028),
                                   (6, 1027), (300000, 4), (2049, 2048)])
def test_kernel_matches_plain_version_bit_for_bit(kind, shape):
    dev = _cuda()
    fn, ref = SAMPLERS[kind]
    before = fn.launches
    got = fn(KEY, shape)  # the card is the default device
    assert fn.launches == before + 1
    assert got.device.type == "cuda" and got.dtype == torch.float32
    want = ref(KEY, shape, dev)
    assert int((got != want).sum()) == 0
    # The card's libm against the CPU's: the same bits through log, sqrt,
    # sin and cos need not round alike, so this side is held at 1e-6.
    np.testing.assert_allclose(got.cpu().numpy(),
                               ref(KEY, shape, "cpu").numpy(), atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["normal", "uniform"])
def test_kernel_store_paths_agree_on_the_card(kind):
    """A width that is a multiple of 4 (16-byte stores) and one that is not
    (4-byte stores) hold the same leading columns."""
    _cuda()
    fn, _ = SAMPLERS[kind]
    wide = fn(KEY, (33, 1028))
    assert torch.equal(fn(KEY, (33, 1027)), wide[:, :1027])
    assert torch.equal(fn(KEY, (33, 1024)), wide[:, :1024])


@pytest.mark.cuda
def test_kernel_moments_on_the_card():
    _cuda()
    n = zrandom.gpu_normal((7, 0), (1024, 1024)).double()
    u = zrandom.gpu_uniform((8, 0), (1024, 1024))
    assert abs(float(n.mean())) < 0.005 and abs(float(n.std()) - 1) < 0.005
    assert abs(float(u.double().mean()) - 0.5) < 0.002
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
