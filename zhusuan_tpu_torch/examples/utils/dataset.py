"""Data for the port's examples.

The port's own copies of what its examples need from
``examples/utils/dataset.py`` (the file-or-synthetic MNIST and UCI loaders,
the semi-supervised MNIST split, the scikit-learn diabetes set, German
credits, ``standardize``, CIFAR-10, the UCI bag-of-words corpora and
MovieLens-1M) and from
``baseline_ref/configs_protocol.py:56-93`` (the synthetic splits of the
measured SVGP recipe). Everything is numpy; nothing is downloaded: the UCI
files are read from ``ZS_DATA_DIR`` when present, else replaced by
deterministic synthetic data of the same shapes.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

__all__ = [
    "data_dir", "synthetic_regression", "standardize", "regression_splits",
    "load_uci_boston_housing", "load_uci_diabetes", "diabetes_arrays",
    "save_uci_diabetes", "load_uci_protein_data", "load_uci_german_credits", "load_mnist_realval", "load_binary_mnist",
    "to_one_hot", "load_mnist_semi_supervised", "epoch_batches",
    "load_cifar10", "load_uci_bow", "load_movielens1m",
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


def data_dir():
    """Where the loaders look for data files: ``ZS_DATA_DIR``, else
    ``~/.zhusuan_tpu/data`` (the JAX package's ``data_dir``)."""
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
    base = path or os.path.join(data_dir(), "housing.data")
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
    with scikit-learn, so it needs no download
    (``examples/utils/dataset.py:193-220``). Read from ``diabetes.npz``
    under ``ZS_DATA_DIR`` when present (the same arrays, written by
    :func:`save_uci_diabetes` where scikit-learn is installed), else from
    scikit-learn. Same return contract as :func:`load_uci_boston_housing`;
    ``synthetic`` is always False. Raises ``ImportError`` with the reason
    where neither is there.
    """
    data, target = diabetes_arrays(path)
    return (*_split(data, target, seed), False)


def diabetes_arrays(path=None):
    """The raw diabetes arrays ``(data [442, 10], target [442])`` in
    float64: from ``path`` or ``diabetes.npz`` under ``ZS_DATA_DIR`` when
    present, else from scikit-learn (see :func:`load_uci_diabetes`)."""
    base = path or os.path.join(data_dir(), "diabetes.npz")
    if os.path.exists(base):
        with np.load(base) as f:
            data, target = f["data"], f["target"]
    else:
        data, target = _sklearn_diabetes()
    return data.astype(np.float64), target.astype(np.float64)


def save_uci_diabetes(path):
    """Write scikit-learn's diabetes arrays to ``path`` (``.npz``), for a
    host without scikit-learn (see :func:`load_uci_diabetes`)."""
    data, target = _sklearn_diabetes()
    np.savez(path, data=data, target=target)


def _sklearn_diabetes():
    try:
        from sklearn.datasets import load_diabetes
    except ImportError as e:
        raise ImportError(
            "The diabetes dataset ships with scikit-learn, which is not "
            "installed here; use -dataset boston_housing or protein_data, "
            "put a diabetes.npz from save_uci_diabetes under ZS_DATA_DIR, "
            "or run where scikit-learn is available.") from e
    raw = load_diabetes()
    return raw.data, raw.target


def load_uci_protein_data(path=None, seed=0):
    """Protein structure (45730 x 9; reference ``dataset.py:347-370``) from
    ``protein.data`` under ``ZS_DATA_DIR`` when present (first column the
    target), else synthetic."""
    base = path or os.path.join(data_dir(), "protein.data")
    if os.path.exists(base):
        data = np.loadtxt(base, delimiter=",", skiprows=1)
        y, x = data[:, 0], data[:, 1:]
        synthetic = False
    else:
        x, y = synthetic_regression(45730, 9, seed=7)
        synthetic = True
    return (*_split(x, y, seed), synthetic)


def load_uci_german_credits(path=None, n_train=700, seed=0):
    """German credits binary classification (1000 x 24; reference
    ``dataset.py:301``, ``examples/utils/dataset.py:322-341``) from
    ``german.data-numeric`` under ``ZS_DATA_DIR`` when present, else the
    deterministic synthetic logistic data of the same shape.

    :return: ``(x_train, y_train, x_test, y_test, synthetic)``.
    """
    base = path or os.path.join(data_dir(), "german.data-numeric")
    if os.path.exists(base):
        data = np.loadtxt(base)
        x, y = data[:, :-1], data[:, -1] - 1
        synthetic = False
    else:
        rng = np.random.RandomState(seed)
        x = rng.randn(1000, 24)
        w = rng.randn(24)
        y = (1 / (1 + np.exp(-(x @ w))) > rng.rand(1000)).astype(np.float64)
        synthetic = True
    x = x.astype(np.float32)
    y = y.astype(np.int32)
    return x[:n_train], y[:n_train], x[n_train:], y[n_train:], synthetic


def _read_idx_images(path):
    with gzip.open(path, "rb") as f:
        _, n, rows, cols = struct.unpack(">IIII", f.read(16))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(n, rows * cols).astype(np.float32) / 255.0


def _read_idx_labels(path):
    with gzip.open(path, "rb") as f:
        _ = struct.unpack(">II", f.read(8))
        return np.frombuffer(f.read(), dtype=np.uint8).astype(np.int32)


def _synthetic_mnist(n_train=50000, n_valid=10000, n_test=10000, seed=1234):
    """Deterministic MNIST-shaped synthetic digits (``examples/utils/
    dataset.py:82-107``): blurred random strokes per class template, values
    in [0, 1], 784 features, 10 classes."""
    rng = np.random.RandomState(seed)
    templates = rng.rand(10, 28, 28) ** 3
    for _ in range(2):
        templates = (
            templates
            + np.roll(templates, 1, -1) + np.roll(templates, -1, -1)
            + np.roll(templates, 1, -2) + np.roll(templates, -1, -2)
        ) / 5.0
    templates /= templates.max(axis=(1, 2), keepdims=True)

    def make(n):
        labels = rng.randint(0, 10, size=n)
        base = templates[labels]
        noise = rng.rand(n, 28, 28) * 0.3
        imgs = np.clip(base * 0.9 + noise - 0.15, 0.0, 1.0)
        return imgs.reshape(n, 784).astype(np.float32), labels.astype(np.int32)

    x_train, t_train = make(n_train)
    x_valid, t_valid = make(n_valid)
    x_test, t_test = make(n_test)
    return x_train, t_train, x_valid, t_valid, x_test, t_test


def load_mnist_realval(path=None):
    """MNIST with real-valued pixels in [0, 1] (``examples/utils/
    dataset.py:110-137``; reference ``dataset.py:102-142``) from the IDX
    files under ``ZS_DATA_DIR``/mnist when present, else
    :func:`_synthetic_mnist`.

    :return: ``(x_train, t_train, x_valid, t_valid, x_test, t_test,
        synthetic)``.
    """
    base = path or os.path.join(data_dir(), "mnist")
    files = [
        "train-images-idx3-ubyte.gz",
        "train-labels-idx1-ubyte.gz",
        "t10k-images-idx3-ubyte.gz",
        "t10k-labels-idx1-ubyte.gz",
    ]
    paths = [os.path.join(base, f) for f in files]
    if all(os.path.exists(p) for p in paths):
        x = _read_idx_images(paths[0])
        t = _read_idx_labels(paths[1])
        x_test = _read_idx_images(paths[2])
        t_test = _read_idx_labels(paths[3])
        return (x[:-10000], t[:-10000], x[-10000:], t[-10000:], x_test,
                t_test, False)
    return (*_synthetic_mnist(), True)


def load_binary_mnist(path=None, seed=0):
    """Binarized MNIST (Bernoulli-sampled pixels, ``RandomState(seed)``),
    the VAE benchmark's input (``examples/utils/dataset.py:140-151``).

    :return: ``(x_train, x_valid, x_test, synthetic)`` with values in
        {0, 1}, float32.
    """
    x_train, _, x_valid, _, x_test, _, synthetic = load_mnist_realval(path)
    rng = np.random.RandomState(seed)
    return (
        (rng.rand(*x_train.shape) < x_train).astype(np.float32),
        (rng.rand(*x_valid.shape) < x_valid).astype(np.float32),
        (rng.rand(*x_test.shape) < x_test).astype(np.float32),
        synthetic,
    )


def to_one_hot(x, depth):
    """Integer labels -> one-hot int32 rows (``examples/utils/
    dataset.py:62-66``; reference ``dataset.py:39-50``)."""
    ret = np.zeros((x.shape[0], depth), dtype=np.int32)
    ret[np.arange(x.shape[0]), x] = 1
    return ret


def load_mnist_semi_supervised(path=None, n_labeled=100, seed=1234):
    """MNIST split into a small class-balanced labeled set (the first
    ``n_labeled // 10`` rows of each class) and the rest unlabeled, the
    semi-supervised VAE's input (``examples/utils/dataset.py:248-266``).
    ``seed`` is kept for the JAX signature and unused there too.

    :return: ``(x_labeled, t_labeled_onehot float32, x_unlabeled, x_test,
        t_test, synthetic)``.
    """
    x_train, t_train, _, _, x_test, t_test, synthetic = \
        load_mnist_realval(path)
    per_class = n_labeled // 10
    labeled_idx = np.concatenate(
        [np.where(t_train == c)[0][:per_class] for c in range(10)])
    x_labeled = x_train[labeled_idx]
    t_labeled = to_one_hot(t_train[labeled_idx], 10).astype(np.float32)
    x_unlabeled = np.delete(x_train, labeled_idx, axis=0)
    return x_labeled, t_labeled, x_unlabeled, x_test, t_test, synthetic


def epoch_batches(n_rows, batch_size, epoch, max_batches=None):
    """One epoch's batches of the training examples' loops: row indices
    ``[n_batches, batch_size]``, a permutation by ``RandomState(epoch)``
    cut into ``n_rows // batch_size`` batches (at most ``max_batches``);
    the rows that fill no batch are left out."""
    n = n_rows // batch_size
    if max_batches is not None:
        n = min(n, max_batches)
    perm = np.random.RandomState(epoch).permutation(n_rows)
    return perm[:n * batch_size].reshape(n, batch_size)


def load_cifar10(path=None, normalize=True, one_hot=True, seed=0):
    """CIFAR-10 (``examples/utils/dataset.py:269-318``; reference
    ``dataset.py:198``): the pickled batches under ``ZS_DATA_DIR`` when
    present, else a deterministic synthetic 32x32x3 set (``RandomState(seed)``
    draws, equal to the JAX package's).

    :return: ``(x_train, t_train, x_test, t_test, synthetic)``.
    """
    import pickle as _pickle
    import tarfile

    base = path or os.path.join(data_dir(), "cifar-10-python.tar.gz")
    if os.path.exists(base):
        xs, ts, xs_test, ts_test = [], [], [], []
        with tarfile.open(base) as tar:
            for member in tar.getmembers():
                name = os.path.basename(member.name)
                if name.startswith("data_batch") or name == "test_batch":
                    d = _pickle.load(tar.extractfile(member),
                                     encoding="bytes")
                    data = d[b"data"].reshape(-1, 3, 32, 32).transpose(
                        0, 2, 3, 1
                    )
                    if name == "test_batch":
                        xs_test.append(data)
                        ts_test.extend(d[b"labels"])
                    else:
                        xs.append(data)
                        ts.extend(d[b"labels"])
        x_train = np.concatenate(xs).astype(np.float32)
        x_test = np.concatenate(xs_test).astype(np.float32)
        t_train = np.asarray(ts, np.int32)
        t_test = np.asarray(ts_test, np.int32)
        synthetic = False
    else:
        rng = np.random.RandomState(seed)
        base_imgs = rng.rand(10, 32, 32, 3)
        t_train = rng.randint(0, 10, 50000).astype(np.int32)
        t_test = rng.randint(0, 10, 10000).astype(np.int32)
        x_train = (base_imgs[t_train] * 0.7
                   + 0.3 * rng.rand(50000, 32, 32, 3)) * 255
        x_test = (base_imgs[t_test] * 0.7
                  + 0.3 * rng.rand(10000, 32, 32, 3)) * 255
        x_train = x_train.astype(np.float32)
        x_test = x_test.astype(np.float32)
        synthetic = True
    if normalize:
        x_train /= 255.0
        x_test /= 255.0
    if one_hot:
        t_train = to_one_hot(t_train, 10)
        t_test = to_one_hot(t_test, 10)
    return x_train, t_train, x_test, t_test, synthetic


def load_uci_bow(data_name="nips", path=None, n_docs=1500, n_vocab=1000,
                 seed=0):
    """UCI bag-of-words corpus (``examples/utils/dataset.py:339-371``;
    reference ``dataset.py:373,422``); the synthetic LDA-like fallback
    (``RandomState(seed)`` draws) equals the JAX package's.

    :return: ``(doc_word_counts [n_docs, n_vocab] float32, vocab list,
        synthetic)``.
    """
    base = path or os.path.join(data_dir(),
                                "docword.{}.txt".format(data_name))
    vocab_path = os.path.join(data_dir(), "vocab.{}.txt".format(data_name))
    if os.path.exists(base):
        with open(base) as f:
            n_docs = int(f.readline())
            n_vocab = int(f.readline())
            f.readline()  # nnz
            X = np.zeros((n_docs, n_vocab), np.float32)
            for line in f:
                d, w, c = map(int, line.split())
                X[d - 1, w - 1] = c
        if os.path.exists(vocab_path):
            with open(vocab_path) as f:
                vocab = [line.strip() for line in f]
        else:
            vocab = [str(i) for i in range(n_vocab)]
        return X, vocab, False
    rng = np.random.RandomState(seed)
    n_topics = 25
    phi = rng.dirichlet(np.full(n_vocab, 0.05), n_topics)
    theta = rng.dirichlet(np.full(n_topics, 0.2), n_docs)
    doc_word = theta @ phi
    lengths = rng.poisson(150, n_docs) + 30
    X = np.stack([
        rng.multinomial(n, p) for n, p in zip(lengths, doc_word)
    ]).astype(np.float32)
    vocab = ["w{}".format(i) for i in range(n_vocab)]
    return X, vocab, True


def load_movielens1m(path=None, seed=0):
    """MovieLens-1M ratings (``examples/utils/dataset.py:374-426``;
    reference ``dataset.py:466,528``); the synthetic low-rank fallback
    (``RandomState(seed)`` draws) equals the JAX package's.

    :return: ``(n_users, n_movies, (user_idx, movie_idx, rating) train,
        same valid, same test, synthetic)``.
    """
    base = path or os.path.join(data_dir(), "ml-1m", "ratings.dat")
    if os.path.exists(base):
        rows = []
        with open(base, encoding="latin-1") as f:
            for line in f:
                u, m, r, _ = line.strip().split("::")
                rows.append((int(u) - 1, int(m) - 1, float(r)))
        arr = np.asarray(rows)
        synthetic = False
    else:
        rng = np.random.RandomState(seed)
        n_users, n_movies, n_obs = 6040, 3706, 1000209
        u_f = rng.randn(n_users, 8)
        m_f = rng.randn(n_movies, 8)
        ui = rng.randint(0, n_users, n_obs)
        mi = rng.randint(0, n_movies, n_obs)
        r = np.clip(
            np.round(2.5 + 0.8 * np.sum(u_f[ui] * m_f[mi], -1) / 8 * 5
                     + 0.5 * rng.randn(n_obs)),
            1, 5,
        )
        arr = np.stack([ui, mi, r], axis=1)
        synthetic = True
    rng = np.random.RandomState(seed + 1)
    perm = rng.permutation(arr.shape[0])
    arr = arr[perm]
    n = arr.shape[0]
    n_tr, n_va = int(0.85 * n), int(0.05 * n)
    n_users = int(arr[:, 0].max()) + 1
    n_movies = int(arr[:, 1].max()) + 1

    def unpack(a):
        return (a[:, 0].astype(np.int32), a[:, 1].astype(np.int32),
                a[:, 2].astype(np.float32))

    return (
        n_users, n_movies,
        unpack(arr[:n_tr]), unpack(arr[n_tr:n_tr + n_va]),
        unpack(arr[n_tr + n_va:]), synthetic,
    )
