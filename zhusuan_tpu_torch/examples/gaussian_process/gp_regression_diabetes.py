"""The library-level GP API on real data: exact GP, SGPR and SVGP on the
diabetes regression set (Efron et al. 2004; 442 x 10).

Port of ``examples/gaussian_process/gp_regression_diabetes.py``: exact
type-II maximum likelihood regression, the collapsed Titsias bound with
learned inducing inputs and the whitened SVGP bound
(:mod:`zhusuan_tpu_torch.gp`), each fit by its own loop of
``torch.optim.Adam`` steps. The file's own 90/10 split
(``np.random.default_rng(seed).permutation``) standardized by the
training statistics. The raw arrays come from ``diabetes.npz`` under
``ZS_DATA_DIR`` (or ``--data``) when present, else from scikit-learn (see
:func:`~zhusuan_tpu_torch.examples.utils.dataset.diabetes_arrays`).

Run (on the card; ``--device cpu`` for the CPU)::

    python -m zhusuan_tpu_torch.examples.gaussian_process.gp_regression_diabetes
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from zhusuan_tpu_torch import gp
from zhusuan_tpu_torch.examples.utils.cli import add_device_arg, resolve_device
from zhusuan_tpu_torch.examples.utils.dataset import diabetes_arrays

__all__ = ["load_diabetes", "fit", "metrics", "run", "main"]


def load_diabetes(seed=0, path=None):
    """The 90/10 split of ``seed``'s permutation, standardized by the
    training statistics: ``(x_tr, y_tr, x_te, y_te, y_scale)``, float64
    numpy."""
    x, y = diabetes_arrays(path)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(y))
    x, y = x[perm], y[perm]
    n_train = int(0.9 * len(y))
    x_tr, x_te = x[:n_train], x[n_train:]
    y_tr, y_te = y[:n_train], y[n_train:]
    xm, xs = x_tr.mean(0), x_tr.std(0) + 1e-8
    ym, ys = y_tr.mean(), y_tr.std()
    return ((x_tr - xm) / xs, (y_tr - ym) / ys,
            (x_te - xm) / xs, (y_te - ym) / ys, ys)


def fit(loss_fn, params, n_iters=800, lr=0.03):
    """``n_iters`` Adam steps on ``loss_fn(params)`` (a dict of leaf
    tensors, possibly nested one level in an ``SVGPState``); returns the
    parameters and the last step's loss (one host read)."""
    opt = torch.optim.Adam(list(_leaves(params)), lr=lr)
    val = None
    for _ in range(int(n_iters)):
        opt.zero_grad(set_to_none=True)
        val = loss_fn(params)
        val.backward()
        opt.step()
    return params, float(val.detach())


def _leaves(params):
    for v in params.values():
        if isinstance(v, torch.Tensor):
            yield v
        else:
            yield from v


def metrics(post, y_te, y_scale, noise_var):
    """Test RMSE and NLL in the target's units (numpy float64)."""
    mean = post.mean.detach().cpu().double().numpy()
    var = post.var.detach().cpu().double().numpy() + noise_var
    rmse = float(np.sqrt(np.mean((mean - y_te) ** 2)) * y_scale)
    nll = float(np.mean(
        0.5 * np.log(2 * np.pi * var) + (y_te - mean) ** 2 / (2 * var)
    ) + np.log(y_scale))
    return rmse, nll


def _kern(p):
    return gp.RBF(lengthscale=torch.exp(p["log_ell"]),
                  variance=torch.exp(p["log_var"]))


def _hyper(d, dtype, device, **extra):
    p = {"log_ell": torch.zeros(d, dtype=dtype, device=device),
         "log_var": torch.tensor(0.0, dtype=dtype, device=device),
         "log_noise": torch.tensor(-1.0, dtype=dtype, device=device)}
    p = {k: v.requires_grad_(True) for k, v in p.items()}
    p.update(extra)
    return p


def run(device, n_iters=800, m_inducing=50, seed=0, svgp_n_iters=None,
        dtype=torch.float32, data_path=None, verbose=True):
    """The three fits and their test metrics on ``device`` in ``dtype``:
    ``((rmse, nll) exact, (rmse, nll) SGPR, (rmse, nll) SVGP)``."""
    device = torch.device(device)
    x_tr, y_tr, x_te, y_te, y_scale = load_diabetes(seed, data_path)
    d = x_tr.shape[1]

    def dev(a):  # a copy: Adam steps in place, z0 serves two fits
        return torch.tensor(a, dtype=dtype, device=device)

    xt, yt, xs = dev(x_tr), dev(y_tr), dev(x_te)

    # Exact GP, type-II maximum likelihood.
    p_ex, _ = fit(lambda p: -gp.gp_log_marginal(
        _kern(p), xt, yt, torch.exp(p["log_noise"])),
        _hyper(d, dtype, device), n_iters=n_iters)
    with torch.no_grad():
        noise = float(torch.exp(p_ex["log_noise"]))
        post = gp.gp_regression(_kern(p_ex), xt, yt, xs, noise)
    r_ex = metrics(post, y_te, y_scale, noise)

    # SGPR: the collapsed bound with learned inducing inputs.
    rng = np.random.default_rng(seed)
    z0 = x_tr[rng.choice(len(y_tr), m_inducing, replace=False)]
    p_sg, _ = fit(lambda p: -gp.sgpr_elbo(
        _kern(p), xt, yt, p["z"], torch.exp(p["log_noise"])),
        _hyper(d, dtype, device, z=dev(z0).requires_grad_(True)),
        n_iters=n_iters)
    with torch.no_grad():
        noise_sg = float(torch.exp(p_sg["log_noise"]))
        post = gp.sgpr_predict(_kern(p_sg), xt, yt, p_sg["z"], xs, noise_sg)
    r_sg = metrics(post, y_te, y_scale, noise_sg)

    # SVGP: the uncollapsed whitened bound.
    st = gp.SVGPState(*(v.requires_grad_(True)
                        for v in gp.svgp_init(dev(z0))))
    p_sv, _ = fit(lambda p: -gp.svgp_elbo(
        _kern(p), p["state"], xt, yt,
        gp.GaussianLikelihood(torch.exp(p["log_noise"]))),
        _hyper(d, dtype, device, state=st),
        n_iters=svgp_n_iters or max(n_iters, 1500), lr=0.02)
    with torch.no_grad():
        noise_sv = float(torch.exp(p_sv["log_noise"]))
        post = gp.svgp_predict(_kern(p_sv), p_sv["state"], xs)
    r_sv = metrics(post, y_te, y_scale, noise_sv)

    if verbose:
        print(f"exact GP  : test RMSE {r_ex[0]:6.1f}  NLL {r_ex[1]:.3f}")
        print(f"SGPR m={m_inducing}: test RMSE {r_sg[0]:6.1f}  "
              f"NLL {r_sg[1]:.3f}")
        print(f"SVGP m={m_inducing}: test RMSE {r_sv[0]:6.1f}  "
              f"NLL {r_sv[1]:.3f}")
    return r_ex, r_sg, r_sv


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n_iters", default=800, type=int)
    parser.add_argument("--m_inducing", default=50, type=int)
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--svgp_n_iters", default=None, type=int)
    parser.add_argument("--data", default=None,
                        help="a diabetes.npz (default: ZS_DATA_DIR's, else "
                             "scikit-learn's)")
    add_device_arg(parser)
    hps = parser.parse_args(argv)
    return run(resolve_device(hps.device), hps.n_iters, hps.m_inducing,
               hps.seed, hps.svgp_n_iters, data_path=hps.data)


if __name__ == "__main__":
    main()
