"""Logistic-normal topic model trained by Monte Carlo EM.

Port of ``examples/topic_models/lntm_mcem.py`` (reference
``examples/topic_models/lntm_mcem.py``): per-document logistic-normal
topic proportions ``eta``, a topic-word matrix ``beta`` with a wide Normal
prior (``log_delta = 10``), a bag-of-words likelihood through
``unnormalized_multinomial``; the E-step is persistent-chain HMC over
``eta`` (reference :97-114), the M-step Adam on ``beta`` plus
moment-matched updates of the ``eta`` prior (reference :157-186). The test
perplexity is bounded by AIS (:class:`~zhusuan_tpu_torch.evaluation.AIS`).

HMC runs over ``eta [n_chains, batch, n_topics]`` with two chain axes
(``n_chain_dims=2``), which the JAX package's HMC gate sends to its plain
path too. The dual-averaging state is carried across minibatches
(:func:`e_step`'s ``da_state``). :func:`e_step` takes ``noise=``, one
``(eps, u)`` an HMC iteration (a testing hook).

The NIPS corpus is replaced by its loader's synthetic corpus when absent
(:func:`~zhusuan_tpu_torch.examples.utils.dataset.load_uci_bow`).

Run (on the card; ``--device cpu`` for the CPU)::

    python -m zhusuan_tpu_torch.examples.topic_models.lntm_mcem
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from zhusuan_tpu_torch.evaluation import AIS
from zhusuan_tpu_torch.examples.utils.cli import add_device_arg, resolve_device
from zhusuan_tpu_torch.framework import BayesianNet, meta_bayesian_net
from zhusuan_tpu_torch.mcmc import HMC
from zhusuan_tpu_torch.ops._random import child_key

__all__ = ["LOG_DELTA", "lntm", "make_model", "make_sampler", "init_da_state",
           "e_step", "m_step", "ais_test_perplexity", "main"]

LOG_DELTA = 10.0
DA_FIELDS = ("t", "step_size", "da_step", "h_bar", "log_epsilon_bar")


def lntm(n_chains, n_docs, n_topics, n_vocab, eta_mean, eta_logstd):
    """The model (reference lntm_mcem.py:33-48), in ``eta_mean``'s dtype
    and on its device."""
    dtype, device = eta_mean.dtype, eta_mean.device

    @meta_bayesian_net()
    def model():
        bn = BayesianNet()
        eta_mean_t = eta_mean[None, :].expand(n_docs, n_topics)
        eta = bn.normal("eta", eta_mean_t, logstd=eta_logstd,
                        n_samples=n_chains, group_ndims=1)
        theta = torch.softmax(eta.tensor, dim=-1)
        beta = bn.normal(
            "beta", torch.zeros((n_topics, n_vocab), dtype=dtype,
                                device=device),
            logstd=torch.tensor(LOG_DELTA, dtype=dtype, device=device),
            group_ndims=1)
        phi = torch.softmax(beta.tensor, dim=-1)
        doc_word = (theta.reshape(-1, n_topics) @ phi).reshape(
            n_chains, n_docs, n_vocab)
        bn.unnormalized_multinomial("x", torch.log(doc_word),
                                    normalize_logits=False, dtype=dtype)
        return bn

    return model()


def make_model(n_chains, batch_size, n_topics, n_vocab, eta_mean,
               eta_logstd):
    """The E-step's and M-step's model: :func:`lntm` with the log-joint of
    ``eta`` and ``x`` only (``beta`` is observed)."""
    model = lntm(n_chains, batch_size, n_topics, n_vocab, eta_mean,
                 eta_logstd)
    model.log_joint = lambda bn: (bn.cond_log_prob("eta")
                                  + bn.cond_log_prob("x"))
    return model


def make_sampler():
    return HMC(step_size=1e-3, n_leapfrogs=20, adapt_step_size=True,
               target_acceptance_rate=0.6)


def init_da_state(dtype=torch.float32, device=None):
    """The dual-averaging state the E-steps carry (``lntm_mcem.py:
    189-195``)."""
    kw = dict(dtype=dtype, device=device)
    return {"t": 0, "step_size": torch.tensor(1e-3, **kw),
            "da_step": torch.zeros((), **kw), "h_bar": torch.zeros((), **kw),
            "log_epsilon_bar": torch.zeros((), **kw)}


def e_step(hmc, model, eta, beta, x, da_state, key=None, num_e_steps=5,
           noise=None):
    """``num_e_steps`` HMC transitions over ``eta`` for one minibatch, from
    the carried dual-averaging state, adapting while its counter is below
    ``num_e_steps`` (``lntm_mcem.py:120-141``).

    :param noise: optional list of ``num_e_steps`` ``(eps, u)`` pairs (of
        :meth:`~zhusuan_tpu_torch.mcmc.HMC.sample`); ``key`` is then
        unused.
    :return: ``(eta, da_state, mean acceptance rate)``.
    """
    state = hmc.init({"eta": eta}, n_chain_dims=2)
    state = state._replace(**da_state)
    observed = {"x": x, "beta": beta}
    if noise is None:
        state, out = hmc.run(model, observed, state, key, num_e_steps,
                             n_adapt=num_e_steps,
                             collect_fields=("acceptance_rate",))
        acc = out["acceptance_rate"]
    else:
        accs = []
        for nz in noise:
            state, info = hmc.sample(model, observed, state,
                                     adapt_step_size=state.t < num_e_steps,
                                     noise=nz)
            accs.append(info.acceptance_rate)
        acc = torch.stack(accs)
    da = {k: getattr(state, k) for k in DA_FIELDS}
    return state.q["eta"], da, torch.mean(acc)


def m_step(optimizer, beta, model, eta, x):
    """One optimizer step on ``beta`` (a leaf tensor that requires grad)
    maximizing ``log p(beta) + E_chains log p(x | eta, beta)``
    (``lntm_mcem.py:143-155``); returns the log-joint before the step."""
    optimizer.zero_grad(set_to_none=True)
    bn = model.observe(eta=eta, x=x, beta=beta)
    log_p_beta, log_px = bn.cond_log_prob(["beta", "x"])
    loss = -(torch.sum(log_p_beta) + torch.sum(torch.mean(log_px, 0)))
    loss.backward()
    optimizer.step()
    return -loss.detach()


def ais_test_perplexity(X_test, beta, eta_mean, eta_logstd, n_topics,
                        n_chains=25, n_temperatures=100, key=None):
    """The test perplexity's upper bound by AIS (reference
    lntm_mcem.py:208-219): anneal from the ``eta`` prior to the posterior
    with HMC transitions and bound ``log p(x_test)``. Returns ``(log
    likelihood lower bound, perplexity upper bound)``."""
    n_docs_test, n_vocab = X_test.shape
    model = lntm(n_chains, n_docs_test, n_topics, n_vocab, eta_mean,
                 eta_logstd)
    model.log_joint = lambda bn: (bn.cond_log_prob("eta")
                                  + bn.cond_log_prob("x"))
    proposal = lntm(n_chains, n_docs_test, n_topics, n_vocab, eta_mean,
                    eta_logstd)
    proposal.log_joint = lambda bn: bn.cond_log_prob("eta")
    hmc = HMC(step_size=0.01, n_leapfrogs=20, adapt_step_size=True,
              target_acceptance_rate=0.6)
    x = torch.as_tensor(np.asarray(X_test), dtype=beta.dtype,
                        device=beta.device)
    ais = AIS(model, proposal, hmc, observed={"x": x, "beta": beta},
              latent=["eta"], n_temperatures=n_temperatures)
    ll_lb = float(ais.run(key))
    return ll_lb, float(np.exp(-ll_lb * n_docs_test / np.sum(X_test)))


def main(epochs=20, batch_size=100, n_topics=20, num_e_steps=5, n_chains=1,
         run_ais=True, ais_temperatures=100, device=None, seed=1237,
         verbose=True):
    """Monte Carlo EM over the first 1200 documents, AIS on 50 of the rest.
    Returns ``(beta, eta_mean, eta_logstd, result)`` with ``result`` the
    last epoch's acceptance rate and log-joint, the topic sparsity and, when
    ``run_ais``, the AIS bounds."""
    from zhusuan_tpu_torch.examples.utils.dataset import load_uci_bow

    device = torch.device("cuda:0" if device is None else device)
    X, _, synthetic = load_uci_bow("nips", n_docs=1500, n_vocab=500)
    if synthetic and verbose:
        print("[note] NIPS bag-of-words not found; using a synthetic "
              "corpus.")
    training_size = 1200
    X_train, X_test = X[:training_size], X[training_size:]
    n_vocab = X_train.shape[1]
    rem = batch_size - X_train.shape[0] % batch_size
    if rem < batch_size:
        X_train = np.vstack([X_train, np.zeros((rem, n_vocab), np.float32)])
    iters = X_train.shape[0] // batch_size
    X_dev = torch.as_tensor(X_train, device=device)

    # Persistent chain state for every document (reference :81-84).
    kw = dict(dtype=torch.float32, device=device)
    Eta = torch.zeros((n_chains, X_train.shape[0], n_topics), **kw)
    eta_mean = torch.zeros(n_topics, **kw)
    eta_logstd = torch.zeros(n_topics, **kw)
    beta = torch.zeros((n_topics, n_vocab), **kw).requires_grad_(True)
    hmc = make_sampler()
    optimizer = torch.optim.Adam([beta], lr=0.1)
    da_state = init_da_state(**kw)
    step = 0
    result = {}
    for epoch in range(1, epochs + 1):
        accs, ljs = [], []
        model = make_model(n_chains, batch_size, n_topics, n_vocab,
                           eta_mean, eta_logstd)
        for t in range(iters):
            sl = slice(t * batch_size, (t + 1) * batch_size)
            x = X_dev[sl]
            eta_new, da_state, acc = e_step(
                hmc, model, Eta[:, sl], beta.detach(), x, da_state,
                child_key((seed, 0), step), num_e_steps)
            step += 1
            Eta[:, sl] = eta_new
            ljs.append(m_step(optimizer, beta, model, eta_new, x))
            accs.append(acc)
        # Update the eta prior by moment matching (reference :176-181).
        eta_mean = Eta.mean(dim=(0, 1))
        eta_logstd = torch.log(Eta.std(dim=(0, 1), unbiased=False) + 1e-6)
        result = {"acceptance": float(torch.stack(accs).mean()),
                  "log_joint": float(torch.stack(ljs).mean())}
        if verbose and epoch % 5 == 0:
            print("Epoch {}: acceptance = {:.3f}, log joint = {:.1f}".format(
                epoch, result["acceptance"], result["log_joint"]))
    beta = beta.detach()
    phi = torch.softmax(beta, dim=-1)
    result["sparsity"] = float(phi.max(-1).values.mean())
    if verbose:
        print("Topic sparsity (mean max word prob): {:.4f}".format(
            result["sparsity"]))
    if run_ais:
        ll_lb, ppl_ub = ais_test_perplexity(
            X_test[:50], beta, eta_mean, eta_logstd, n_topics, n_chains=10,
            n_temperatures=ais_temperatures,
            key=torch.Generator().manual_seed(seed))
        result["ll_lb"], result["perplexity_ub"] = ll_lb, ppl_ub
        if verbose:
            print(">> log likelihood lower bound = {:.2f}\n"
                  ">> perplexity upper bound = {:.2f}".format(ll_lb, ppl_ub))
    return beta, eta_mean, eta_logstd, result


def _cli(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--epochs", type=int, default=20)
    add_device_arg(parser)
    args = parser.parse_args(argv)
    return main(args.epochs, device=resolve_device(args.device))


if __name__ == "__main__":
    _cli()
