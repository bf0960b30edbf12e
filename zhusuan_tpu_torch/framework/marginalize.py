"""Exact enumeration of finite discrete latents.

Port of ``zhusuan_tpu/framework/marginalize.py`` (beyond the reference,
which sums discrete sites out by hand, e.g.
``examples/semi_supervised_vae/vae_ssl.py:95-133``): given a model (or a
raw log-joint) and the supports of its finite discrete sites,
:func:`marginalize` returns a log-joint over the remaining variables with
those sites summed out exactly::

    log p(rest) = logsumexp over the product of the supports
                  of log p(sites = values, rest)

The result is an ordinary differentiable log-joint (for HMC, NUTS, an ELBO
or AIS). Where the JAX package evaluates the M = K1 * K2 * ... points of
the product support with one ``vmap`` over a flat index grid, the port
loops over them (M is small by design: labels, mixture assignments, model
indicators), stacks the M log-joints and takes one ``logsumexp``.
"""

from __future__ import annotations

import itertools
from typing import Dict, Union

import numpy as np
import torch

from zhusuan_tpu_torch.framework.meta_bn import MetaBayesianNet
from zhusuan_tpu_torch.utils import merge_dicts

__all__ = ["marginalize"]


def marginalize(meta_bn_or_log_joint, supports: Dict[str, Union[int, object]]):
    """Sum finite discrete sites out of a model's log-joint.

    :param meta_bn_or_log_joint: a :class:`MetaBayesianNet` or a raw
        ``log_joint(obs_dict)`` callable.
    :param supports: ``{site_name: support}``, where a support is an int K
        (the values ``0..K-1``) or an array whose leading axis enumerates
        the values (``[K] + value_shape``, e.g. one-hot rows).
    :return: ``log_joint(obs_dict)`` over the remaining variables; passing
        one of the enumerated names in ``obs_dict`` raises.
    """
    if not supports:
        raise ValueError("supports must name at least one site.")
    if isinstance(meta_bn_or_log_joint, MetaBayesianNet):
        meta_bn = meta_bn_or_log_joint

        def base(obs):
            return meta_bn.observe(**obs).log_joint()
    elif callable(meta_bn_or_log_joint):
        base = meta_bn_or_log_joint
    else:
        raise TypeError(
            "Expected a MetaBayesianNet or a callable log-joint, got "
            "{!r}.".format(type(meta_bn_or_log_joint)))

    names = list(supports)
    tensors = [s for s in supports.values() if isinstance(s, torch.Tensor)]
    values = []
    for n in names:
        s = supports[n]
        if isinstance(s, (int, np.integer)):
            if s < 1:
                raise ValueError(
                    "support size for {!r} must be >= 1; got {}.".format(
                        n, s))
            values.append(torch.arange(int(s)))
        else:
            v = torch.as_tensor(s)
            if v.ndim < 1 or v.shape[0] < 1:
                raise ValueError(
                    "support array for {!r} needs a leading enumeration "
                    "axis; got shape {}.".format(n, tuple(v.shape)))
            values.append(v)
    # The product support in the JAX package's order (the last site's
    # index varies fastest, as in its meshgrid(indexing="ij")).
    grid = list(itertools.product(*[range(int(v.shape[0])) for v in values]))

    def marginalized(observed):
        clash = sorted(set(observed) & set(names))
        if clash:
            raise ValueError(
                "Variables {} are marginalized out; do not pass them as "
                "observed/latent.".format(clash))
        # The supports follow the observations onto their device; with
        # none observed, that of the first support given as a tensor
        # (int supports then stay on the host, and a distribution moves a
        # host value onto its own device).
        device = next((v.device for v in list(observed.values()) + tensors
                       if isinstance(v, torch.Tensor)), None)
        vals = [v if device is None else v.to(device) for v in values]
        terms = []
        for point in grid:
            assign = {n: v[i] for n, v, i in zip(names, vals, point)}
            terms.append(base(merge_dicts(observed, assign)))
        lp = torch.stack(torch.broadcast_tensors(*terms), dim=0)
        return torch.logsumexp(lp, dim=0)

    return marginalized
