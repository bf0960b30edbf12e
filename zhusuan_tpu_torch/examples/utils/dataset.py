"""Regression data for the port's examples.

The port's own copies of what its examples need from
``examples/utils/dataset.py`` (the file-or-synthetic UCI loaders, the
scikit-learn diabetes set, ``standardize``) and from
``baseline_ref/configs_protocol.py:56-93`` (the synthetic splits of the
measured SVGP recipe). Everything is numpy; nothing is downloaded: the UCI
files are read from ``ZS_DATA_DIR`` when present, else replaced by
deterministic synthetic data of the same shapes.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = [
    "synthetic_regression", "standardize", "regression_splits",
    "load_uci_boston_housing", "load_uci_diabetes", "load_uci_protein_data",
]


def synthetic_regression(n, d, seed):
    """Deterministic synthetic regression data (``configs_protocol.py:60``,
    the same generator as ``examples/utils/dataset.py``'s fallback)."""
    rng = np.random.RandomState(seed)
    w1 = rng.randn(d, 32)
    w2 = rng.randn(32)
    x = rng.randn(n, d)
    y = np.tanh(x @ w1) @ w2 + 0.3 * rng.randn(n)
    return x.astype(np.float32), y.astype(np.float32)


def standardize(data_train, data_test):
    """Standardize train/test by train statistics (reference
    ``examples/utils/dataset.py:20-36``); returns ``(train, test, mean,
    std)``."""
    std = np.std(data_train, 0, keepdims=True)
    std[std == 0] = 1
    mean = np.mean(data_train, 0, keepdims=True)
    return ((data_train - mean) / std, (data_test - mean) / std,
            np.squeeze(mean, 0), np.squeeze(std, 0))


def regression_splits(cfg):
    """``configs_protocol.py:81-93``: synthetic data, the last 10% as the
    test set, standardized; returns ``(x_train, y_train, x_test, y_test,
    std_y)`` in float32."""
    x, y = synthetic_regression(cfg["n_train_raw"], cfg["x_dim"],
                                cfg["data_seed"])
    n_test = max(1, int(0.1 * len(x)))
    x_train, x_test = x[:-n_test], x[-n_test:]
    y_train, y_test = y[:-n_test], y[-n_test:]
    x_train, x_test, _, _ = standardize(x_train, x_test)
    y_train, y_test, _, std_y = standardize(y_train, y_test)
    return (x_train.astype(np.float32), y_train.astype(np.float32),
            x_test.astype(np.float32), y_test.astype(np.float32),
            float(std_y))


def _data_dir():
    return os.environ.get("ZS_DATA_DIR",
                          os.path.expanduser("~/.zhusuan_tpu/data"))


def _split(x, y, seed):
    rng = np.random.RandomState(seed)
    perm = rng.permutation(x.shape[0])
    x, y = x[perm], y[perm]
    n = x.shape[0]
    n_train, n_valid = int(0.8 * n), int(0.1 * n)
    return (x[:n_train], y[:n_train], x[n_train:n_train + n_valid],
            y[n_train:n_train + n_valid], x[n_train + n_valid:],
            y[n_train + n_valid:])


def load_uci_boston_housing(path=None, seed=0):
    """Boston housing (506 x 13; reference ``dataset.py:321-344``) from
    ``housing.data`` under ``ZS_DATA_DIR`` when present, else synthetic.

    :return: ``(x_train, y_train, x_valid, y_valid, x_test, y_test,
        synthetic)``.
    """
    base = path or os.path.join(_data_dir(), "housing.data")
    if os.path.exists(base):
        data = np.loadtxt(base)
        synthetic = False
    else:
        x, y = synthetic_regression(506, 13, seed=42)
        data = np.concatenate([x, y[:, None]], axis=1)
        synthetic = True
    return (*_split(data[:, :-1], data[:, -1], seed), synthetic)


def load_uci_diabetes(path=None, seed=0):
    """Diabetes regression (Efron et al. 2004; 442 x 10): real data bundled
    with scikit-learn, so it needs no file and no download
    (``examples/utils/dataset.py:193-220``). Same return contract as
    :func:`load_uci_boston_housing`; ``synthetic`` is always False. Raises
    ``ImportError`` with the reason where scikit-learn is not installed.
    """
    del path
    try:
        from sklearn.datasets import load_diabetes
    except ImportError as e:
        raise ImportError(
            "The diabetes dataset ships with scikit-learn, which is not "
            "installed here; use -dataset boston_housing or protein_data, "
            "or run where scikit-learn is available.") from e
    raw = load_diabetes()
    return (*_split(raw.data.astype(np.float64),
                    raw.target.astype(np.float64), seed), False)


def load_uci_protein_data(path=None, seed=0):
    """Protein structure (45730 x 9; reference ``dataset.py:347-370``) from
    ``protein.data`` under ``ZS_DATA_DIR`` when present (first column the
    target), else synthetic."""
    base = path or os.path.join(_data_dir(), "protein.data")
    if os.path.exists(base):
        data = np.loadtxt(base, delimiter=",", skiprows=1)
        y, x = data[:, 0], data[:, 1:]
        synthetic = False
    else:
        x, y = synthetic_regression(45730, 9, seed=7)
        synthetic = True
    return (*_split(x, y, seed), synthetic)
