"""Dirichlet-latent VAE for bag-of-words topic modelling, trained with
implicit reparameterization gradients.

Port of ``examples/topic_models/dirichlet_vae.py``: document-topic
proportions ``theta_d ~ Dirichlet(alpha0)``, words from the mixture
``theta @ phi`` of a learned topic-word table, and the variational
posterior ``q(theta | d) = Dirichlet(softplus(MLP(log1p(bow_d))) + 1e-3)``
with ``is_reparameterized=True``: its sampler is torch's gamma sampler,
whose implicit gradient (Figurnov et al. 2018) carries the pathwise SGVB
gradient, as ``jax.random.gamma``'s does in the JAX package. The train
loop is :func:`~zhusuan_tpu_torch.fit.fit_scan`.

The corpus is a deterministic LDA-generated one (:func:`synthetic_corpus`,
the JAX example's ``RandomState`` draws). :func:`elbo_loss` takes
``theta=``, the posterior draws (a testing hook: the Gamma stream differs
between the packages, and the gradient then flows through ``theta`` as the
caller builds it).

Run (on the card; ``--device cpu`` for the CPU)::

    python -m zhusuan_tpu_torch.examples.topic_models.dirichlet_vae
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from zhusuan_tpu_torch.distributions import Dirichlet
from zhusuan_tpu_torch.examples.utils.cli import add_device_arg, resolve_device
from zhusuan_tpu_torch.examples.utils.nn import (
    init_linear,
    init_mlp,
    linear_apply,
    mlp_apply,
)
from zhusuan_tpu_torch.fit import fit_scan
from zhusuan_tpu_torch.utils import tree_leaves

__all__ = ["N_TOPICS", "N_VOCAB", "ALPHA0", "synthetic_corpus",
           "init_params", "elbo_loss", "topic_tv", "main"]

N_TOPICS = 8
N_VOCAB = 200
ALPHA0 = 0.5


def synthetic_corpus(n_docs=512, doc_len=64, seed=0):
    """A deterministic LDA-generated bag-of-words corpus and its true
    topics (the JAX example's draws)."""
    rng = np.random.RandomState(seed)
    topics = rng.dirichlet(np.full(N_VOCAB, 0.1), size=N_TOPICS)
    bows = np.zeros((n_docs, N_VOCAB), np.float32)
    for d in range(n_docs):
        theta = rng.dirichlet(np.full(N_TOPICS, ALPHA0))
        z = rng.choice(N_TOPICS, size=doc_len, p=theta)
        w = np.array([rng.choice(N_VOCAB, p=topics[k]) for k in z])
        np.add.at(bows[d], w, 1.0)
    return bows, topics


def init_params(generator, hidden=64, dtype=torch.float32):
    """The encoder MLP, the concentration head and the topic-word logits
    (``0.01 N(0, 1)``), drawn from ``generator`` in the JAX example's
    order."""
    g = generator
    params = {
        "enc": init_mlp(g, [N_VOCAB, hidden], dtype),
        "alpha": init_linear(g, hidden, N_TOPICS, dtype),
    }
    phi = 0.01 * torch.randn((N_TOPICS, N_VOCAB), generator=g, dtype=dtype,
                             device=g.device)
    params["log_phi"] = phi.requires_grad_(True)
    return params


def elbo_loss(params, bow, generator=None, n_particles=4, theta=None):
    """-ELBO with the pathwise Dirichlet posterior.

    :param generator: the posterior draws' generator (on ``bow``'s device).
    :param theta: optional ``[n_particles, batch, N_TOPICS]`` posterior
        draws replacing the sampler's (a testing hook).
    """
    bow = torch.as_tensor(bow)
    h = mlp_apply(params["enc"], torch.log1p(bow), final_activation=torch.relu)
    # Concentrations > 0; +1e-3 keeps the Gamma sampler well conditioned.
    alpha_q = torch.nn.functional.softplus(
        linear_apply(params["alpha"], h)) + 1e-3
    q = Dirichlet(alpha_q, is_reparameterized=True)
    if theta is None:
        theta = q.sample(generator, n_samples=n_particles)
    log_phi = torch.log_softmax(params["log_phi"], dim=-1)
    # log p(words | theta) = sum_w count_w log(theta @ phi).
    word_logp = torch.logsumexp(
        torch.log(theta)[..., None] + log_phi[None, None], dim=-2)
    log_lik = torch.sum(bow[None] * word_logp, dim=-1)
    prior = Dirichlet(torch.full((N_TOPICS,), ALPHA0, dtype=theta.dtype,
                                 device=theta.device))
    lb = log_lik + prior.log_prob(theta) - q.log_prob(theta)
    return -torch.mean(lb)


def topic_tv(params, true_topics):
    """Each true topic's total-variation distance to its nearest learned
    topic."""
    phi = torch.softmax(params["log_phi"].detach(), -1).double().cpu().numpy()
    tv = 0.5 * np.abs(true_topics[:, None, :] - phi[None, :, :]).sum(-1)
    return tv.min(axis=1)


def main(n_docs=512, epochs=150, batch_size=64, lr=1e-2, seed=0,
         device=None, verbose=True):
    """Adam on the -ELBO over the synthetic corpus. Returns ``(history
    [epochs, n_batches], best TV per true topic)``."""
    device = torch.device("cuda:0" if device is None else device)
    bows, true_topics = synthetic_corpus(n_docs)
    params = init_params(torch.Generator(device=device).manual_seed(seed))
    opt = torch.optim.Adam(tree_leaves(params), lr=lr)
    params, _, hist = fit_scan(
        elbo_loss, params, opt, torch.as_tensor(bows, device=device),
        generator=torch.Generator().manual_seed(seed), epochs=epochs,
        batch_size=batch_size,
        callback=(lambda e, loss: print("Epoch %d: -ELBO = %.2f" % (e, loss))
                  if verbose and e % 10 == 0 else None))
    best = topic_tv(params, true_topics)
    if verbose:
        print("per-true-topic best TV distance:", np.round(best, 3))
        print("mean best TV:", float(best.mean()))
    return hist, best


def _cli(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--epochs", type=int, default=150)
    add_device_arg(parser)
    args = parser.parse_args(argv)
    return main(epochs=args.epochs, device=resolve_device(args.device))


if __name__ == "__main__":
    _cli()
