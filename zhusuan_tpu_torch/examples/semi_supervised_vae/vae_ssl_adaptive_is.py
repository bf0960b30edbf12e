"""Semi-supervised VAE with adaptive importance sampling (RWS proposals).

Port of ``examples/semi_supervised_vae/vae_ssl_adaptive_is.py`` (parity:
reference ``examples/semi_supervised_vae/vae_ssl_adaptive_is.py``): the
model of :mod:`.vae_ssl` trained on importance-weighted bounds, its
non-reparameterized proposals adapted with ``klpq(...).importance()``
(reference :101-143); the unlabeled proposal draws y from the classifier,
then z | x, y (reference :61-69); the classifier's cost as in
:mod:`.vae_ssl`. Same data, widths and loop.

Run (on the card; ``--device cpu`` for the CPU)::

    python -m zhusuan_tpu_torch.examples.semi_supervised_vae.vae_ssl_adaptive_is
"""

from __future__ import annotations

import torch

from zhusuan_tpu_torch.examples.semi_supervised_vae import vae_ssl
from zhusuan_tpu_torch.examples.semi_supervised_vae.vae_ssl import (
    build_gen,
    classifier_terms,
    qy_x,
)
from zhusuan_tpu_torch.examples.utils.nn import linear_apply, mlp_apply
from zhusuan_tpu_torch.framework import BayesianNet
from zhusuan_tpu_torch.utils import tree_map
from zhusuan_tpu_torch.variational import importance_weighted_objective, klpq

__all__ = ["MODEL_KEYS", "labeled_proposal", "unlabeled_proposal",
           "adaptive_is_cost", "main"]

MODEL_KEYS = ("gen_z_h", "gen_y_h", "gen_h_h", "gen_h_x")


def _qz_params(params, x, y):
    h = torch.cat([x, y], -1)
    h = mlp_apply(params["qz_net"], h, final_activation=torch.relu)
    return (linear_apply(params["qz_mean"], h),
            linear_apply(params["qz_logstd"], h))


def labeled_proposal(params, x, y, z_dim, n_particles, key, noise=None):
    """q(z | x, y), not reparameterized; ``noise={"z": eps}``."""
    bn = BayesianNet(key=key, noise=noise)
    z_mean, z_logstd = _qz_params(params, x, y)
    bn.normal("z", z_mean, logstd=z_logstd, n_samples=n_particles,
              group_ndims=1, is_reparameterized=False)
    return bn


def unlabeled_proposal(params, x, n_class, z_dim, n_particles, key,
                       noise=None):
    """y ~ q(y | x) from the classifier, then q(z | x, y);
    ``noise={"y": uniforms, "z": eps}``."""
    bn = BayesianNet(key=key, noise=noise)
    y = bn.onehot_categorical("y", qy_x(params, x, n_class),
                              dtype=x.dtype)
    z_mean, z_logstd = _qz_params(params, x, y.tensor)
    bn.normal("z", z_mean, logstd=z_logstd, group_ndims=1,
              is_reparameterized=False, n_samples=n_particles)
    return bn


def adaptive_is_cost(params, x_l, y_l, x_u, keys, n_class, z_dim,
                     n_particles, beta, noise=None):
    """``(cost, (labeled IW bound, unlabeled IW bound, accuracy))``: the
    model's gradient from the IW bounds with the proposal detached, the
    proposals' from ``klpq(...).importance()`` with the model detached
    (both on the same draws: one key a net), plus the classifier cost.

    :param keys: ``(k_l, k_u)``.
    :param noise: ``(noise_l, noise_u)`` for the two proposals.
    """
    k_l, k_u = keys
    noise_l, noise_u = noise if noise is not None else (None, None)
    n_l, n_u = x_l.shape[0], x_u.shape[0]
    x_dim = x_l.shape[-1]

    def split_params(keep_model):
        return {k: (v if (k in MODEL_KEYS) == keep_model
                    else tree_map(torch.Tensor.detach, v))
                for k, v in params.items()}

    # Model update: the IW bounds, proposal parameters detached.
    pm = split_params(True)
    prop_l = labeled_proposal(pm, x_l, y_l, z_dim, n_particles, k_l,
                              noise=noise_l)
    model_l = build_gen(pm, n_l, x_dim, n_class, z_dim, n_particles)
    labeled_lb = torch.mean(importance_weighted_objective(
        model_l, {"x": x_l, "y": y_l}, variational=prop_l, axis=0).tensor)
    prop_u = unlabeled_proposal(pm, x_u, n_class, z_dim, n_particles, k_u,
                                noise=noise_u)
    model_u = build_gen(pm, n_u, x_dim, n_class, z_dim, n_particles)
    unlabeled_lb = torch.mean(importance_weighted_objective(
        model_u, {"x": x_u}, variational=prop_u, axis=0).tensor)
    model_cost = -labeled_lb - unlabeled_lb

    # Proposal update: klpq, model parameters detached.
    pq = split_params(False)
    prop_l2 = labeled_proposal(pq, x_l, y_l, z_dim, n_particles, k_l,
                               noise=noise_l)
    model_l2 = build_gen(pq, n_l, x_dim, n_class, z_dim, n_particles)
    labeled_q_cost = torch.mean(klpq(
        model_l2, {"x": x_l, "y": y_l}, variational=prop_l2,
        axis=0).importance())
    prop_u2 = unlabeled_proposal(pq, x_u, n_class, z_dim, n_particles, k_u,
                                 noise=noise_u)
    model_u2 = build_gen(pq, n_u, x_dim, n_class, z_dim, n_particles)
    unlabeled_q_cost = torch.mean(klpq(
        model_u2, {"x": x_u}, variational=prop_u2, axis=0).importance())

    classifier_cost, acc = classifier_terms(pq, x_l, y_l, n_class, beta)
    total = model_cost + labeled_q_cost + unlabeled_q_cost + classifier_cost
    return total, (labeled_lb, unlabeled_lb, acc)


def main(argv=None):
    return vae_ssl.main(argv, cost_fn=adaptive_is_cost,
                        description=__doc__.splitlines()[0])


if __name__ == "__main__":
    main()
