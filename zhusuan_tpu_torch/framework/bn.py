"""BayesianNet: the directed-graphical-model builder.

Port of ``zhusuan_tpu/framework/bn.py`` (parity: reference
``zhusuan/framework/bn.py``): ``StochasticTensor`` (bn.py:26-316) and
``BayesianNet`` with ``stochastic``/``deterministic``/``get``/
``cond_log_prob``/``log_joint`` (bn.py:319-497), the compatibility queries
``outputs``/``local_log_prob``/``query`` (bn.py:1200-1249), and the sugar
methods of every distribution of ``univariate.py``, ``multivariate.py``,
``extra.py``, ``special.py`` and ``mixture.py`` (36 methods and 6 aliases,
in the JAX package's order).

Randomness: a net's ``key`` is an int seed. Each unobserved node draws from
its own ``torch.Generator`` on its distribution's device, seeded from
``(key, zlib.crc32(name))``: the counterpart of the JAX package's
``fold_in(key, crc32(name))``, so a node's draw is reproducible and does not
depend on the order in which nodes are created. The numbers differ from
JAX's; ``noise={name: eps}`` supplies a node's base draws instead (a
testing hook, so both packages can be fed the same draws): the standard
normals of a Gaussian node, the uniforms of a Bernoulli node, the
open-interval uniforms behind a categorical or Concrete node's Gumbels (see
:meth:`~zhusuan_tpu_torch.distributions.Distribution.sample`).
"""

from __future__ import annotations

import warnings
import zlib
from typing import Dict, Optional

import torch

from zhusuan_tpu_torch import distributions
from zhusuan_tpu_torch.framework.arith import TensorArithmeticMixin, unwrap
from zhusuan_tpu_torch.framework.utils import Context, Local

__all__ = ["StochasticTensor", "BayesianNet", "node_seed"]


_MASK64 = 0xFFFFFFFFFFFFFFFF


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def node_seed(key: int, name: str) -> int:
    """The 64-bit seed of node ``name``'s generator under net key ``key``
    (taken modulo 2^64): the key and ``crc32(name)`` through two rounds of
    the splitmix64 finalizer, so that every bit of the result depends on
    both (torch's CPU generator keeps only the low 32 bits of a seed)."""
    return _splitmix64(_splitmix64(int(key) & _MASK64)
                       ^ zlib.crc32(name.encode("utf-8")))


class StochasticTensor(TensorArithmeticMixin):
    """A named random-variable node owned by a :class:`BayesianNet`.

    ``tensor`` is the observation if the node is observed, else a sample
    drawn once (lazily, cached) from ``dist`` with the node's generator.
    ``cond_log_p`` is ``dist.log_prob(tensor)``, cached (reference
    bn.py:26-316).
    """

    def __init__(self, bn, name, dist, observation=None, n_samples=None):
        self._bn = bn
        self._name = name
        self._dist = dist
        self._n_samples = n_samples
        self._observation = None
        if observation is not None:
            self._observation = self._check_observation(observation)
        self._tensor = None
        self._cond_log_p = None

    def _check_observation(self, observation):
        observation = torch.as_tensor(unwrap(observation),
                                      device=self._dist.device)
        dist_dtype = self._dist.dtype
        if observation.dtype != dist_dtype:
            # Same-kind mismatches are cast; cross-kind (int vs float) are
            # errors (reference bn.py:96-115).
            if observation.is_floating_point() == dist_dtype.is_floating_point:
                observation = observation.to(dist_dtype)
            else:
                raise ValueError(
                    "Observed tensor for node '{}' has dtype {}, which does "
                    "not match the distribution dtype {}.".format(
                        self._name, observation.dtype, dist_dtype))
        expected = tuple(self._dist.batch_shape) + tuple(
            self._dist.value_shape)
        try:
            torch.broadcast_shapes(tuple(observation.shape), expected)
        except RuntimeError:
            raise ValueError(
                "Observed tensor for node '{}' has shape {}, which cannot "
                "broadcast to match batch_shape + value_shape of the "
                "distribution ({} + {}).".format(
                    self._name, tuple(observation.shape),
                    self._dist.batch_shape, self._dist.value_shape))
        return observation

    name = property(lambda self: self._name, doc="Name of the node.")
    bn = property(lambda self: self._bn, doc="The owning BayesianNet.")
    dist = property(lambda self: self._dist, doc="The followed distribution.")
    distribution = property(lambda self: self._dist)
    dtype = property(lambda self: self._dist.dtype)
    n_samples = property(lambda self: self._n_samples)

    @property
    def is_observed(self) -> bool:
        """Whether the node is observed."""
        return self._observation is not None

    @property
    def tensor(self):
        """Observation if observed, else a cached sample."""
        if self._observation is not None:
            return self._observation
        if self._tensor is None:
            eps = self._bn._noise_for(self._name)
            generator = None
            if eps is None:
                generator = self._bn._generator_for(self._name,
                                                    self._dist.device)
            self._tensor = self._dist.sample(
                generator, n_samples=self._n_samples, eps=eps)
        return self._tensor

    @property
    def cond_log_p(self):
        """Cached ``dist.log_prob(self.tensor)`` (reference bn.py:195-204)."""
        if self._cond_log_p is None:
            self._cond_log_p = self._dist.log_prob(self.tensor)
        return self._cond_log_p

    def sample(self, generator, n_samples=None):
        return self._dist.sample(generator, n_samples=n_samples)

    def log_prob(self, given):
        return self._dist.log_prob(given)

    def prob(self, given):
        return self._dist.prob(given)

    def __repr__(self):
        return "<StochasticTensor '{}' {} observed={}>".format(
            self._name, type(self._dist).__name__, self.is_observed)


class BayesianNet(Context):
    """A Bayesian network under construction: a dict of named stochastic and
    deterministic nodes with conditional log-probability queries.

    Direct construction: ``BayesianNet(observed={"x": x}, key=seed)``.
    Inside a builder run by ``MetaBayesianNet.observe`` the observations and
    key come from the enclosing ``Local`` (reference bn.py:319-346).

    :param observed: dict of node names to observed values.
    :param key: int seed of the nodes' generators (see the module
        docstring); needed only to sample unobserved nodes.
    :param noise: optional ``{name: eps}`` replacing a node's base draws
        (testing hook), each of the shape its distribution's ``eps=``
        takes: standard normals for the Gaussian nodes, uniforms on [0, 1)
        for ``Bernoulli`` and ``Uniform`` nodes, uniforms on (0, 1) for the
        categorical, Laplace and Concrete nodes.
    """

    def __init__(self, observed: Optional[Dict] = None, key=None,
                 noise: Optional[Dict] = None):
        self._nodes: Dict[str, object] = {}
        self._log_joint_cache = None
        local = Local.try_get_context()
        self._noise = dict(local.noise) if local is not None else {}
        if noise:
            self._noise.update(noise)
        if local is not None:
            self._observed = dict(local.observations)
            if observed:
                self._observed.update(observed)
            self._meta_bn = local.meta_bn
            self._key = key if key is not None else local.key
        else:
            self._observed = dict(observed) if observed else {}
            self._meta_bn = None
            self._key = key

    # -- internals ----------------------------------------------------- #
    def _generator_for(self, name: str, device) -> torch.Generator:
        if self._key is None:
            raise ValueError(
                "Node '{}' is unobserved and needs to be sampled, but no "
                "PRNG key was provided. Pass `key=` to BayesianNet(...) or "
                "to MetaBayesianNet.observe(key, ...).".format(name))
        return torch.Generator(device=device).manual_seed(
            node_seed(self._key, name))

    def _noise_for(self, name: str):
        return self._noise.get(name)

    def _get_observation(self, name):
        """The observation bound to node ``name``, or None (the legacy
        wrappers pick theirs up so)."""
        return self._observed.get(name, None)

    # -- node creation ------------------------------------------------- #
    @property
    def nodes(self):
        """Dict of all named nodes (stochastic and deterministic)."""
        return self._nodes

    @property
    def observed(self):
        """The observation dict bound to this net."""
        return self._observed

    def _register_node(self, name, node):
        if name in self._nodes:
            raise ValueError(
                "There exists a node with name '{}' in the BayesianNet. "
                "Names should be unique.".format(name))
        self._log_joint_cache = None
        self._nodes[name] = node
        return node

    def stochastic(self, name, dist, n_samples=None) -> StochasticTensor:
        """Add a stochastic node following ``dist``; returns the node
        (reference bn.py:348-371)."""
        node = StochasticTensor(self, name, dist,
                                observation=self._observed.get(name),
                                n_samples=n_samples)
        return self._register_node(name, node)

    def deterministic(self, name, input_tensor):
        """Add a named deterministic node; returns the tensor itself
        (reference bn.py:373-385)."""
        return self._register_node(name, torch.as_tensor(unwrap(input_tensor)))

    def __enter__(self):
        warnings.warn(
            "Using `BayesianNet` as contexts has been deprecated. "
            "Please see the concepts tutorial for the suggested way of "
            "model construction.", FutureWarning)
        return super().__enter__()

    # -- queries ------------------------------------------------------- #
    def _check_name_exist(self, name, only_stochastic=False):
        if not isinstance(name, str):
            raise TypeError(
                "Expected string in `name_or_names`, got {!r} of type "
                "{}.".format(name, type(name)))
        if name not in self._nodes:
            raise ValueError(
                "There isn't a node named '{}' in the BayesianNet.".format(
                    name))
        if only_stochastic and not isinstance(self._nodes[name],
                                              StochasticTensor):
            raise ValueError(
                "Node '{}' is deterministic (input or output).".format(name))
        return name

    def _check_names_exist(self, name_or_names, only_stochastic=False):
        if isinstance(name_or_names, str):
            names = (name_or_names,)
        else:
            name_or_names = tuple(name_or_names)
            names = name_or_names
        for name in names:
            self._check_name_exist(name, only_stochastic=only_stochastic)
        return name_or_names

    def get(self, name_or_names):
        """Get node(s) by name; list in, list out (reference bn.py:422-435)."""
        name_or_names = self._check_names_exist(name_or_names)
        if isinstance(name_or_names, tuple):
            return [self._nodes[name] for name in name_or_names]
        return self._nodes[name_or_names]

    def cond_log_prob(self, name_or_names):
        """Conditional log-probabilities of stochastic nodes at their current
        values (reference bn.py:437-452)."""
        name_or_names = self._check_names_exist(name_or_names,
                                                only_stochastic=True)
        if isinstance(name_or_names, tuple):
            return [self._nodes[name].cond_log_p for name in name_or_names]
        return self._nodes[name_or_names].cond_log_p

    def _default_log_joint(self):
        terms = [node.cond_log_p for node in self._nodes.values()
                 if isinstance(node, StochasticTensor)]
        if not terms:
            raise ValueError(
                "log_joint called on a BayesianNet with no stochastic nodes.")
        total = terms[0]
        for t in terms[1:]:
            total = total + t
        return total

    def log_joint(self):
        """Sum of conditional log-probabilities of all stochastic nodes,
        overridable via ``meta_bn.log_joint`` (reference bn.py:454-478)."""
        if self._log_joint_cache is None:
            meta_bn = self._meta_bn
            if meta_bn is None or meta_bn.log_joint is None:
                self._log_joint_cache = self._default_log_joint()
            elif callable(meta_bn.log_joint):
                self._log_joint_cache = meta_bn.log_joint(self)
            else:
                raise TypeError(
                    "meta_bn.log_joint is set to a non-callable instance: "
                    "{!r}".format(meta_bn.log_joint))
        return self._log_joint_cache

    def __getitem__(self, name):
        return self._nodes[self._check_name_exist(name)]

    def __setitem__(self, name, node):
        raise TypeError(
            "BayesianNet instance does not support replacement of existing "
            "nodes. Pass observations via MetaBayesianNet.observe or the "
            "`observed=` constructor argument.")

    def __contains__(self, name):
        return name in self._nodes

    # -- compatibility query API (reference bn.py:1200-1249) ----------- #
    def outputs(self, name_or_names):
        """Node value(s) by name: ``get(...).tensor`` (reference
        bn.py:1200-1214)."""
        name_or_names = self._check_names_exist(name_or_names)
        if isinstance(name_or_names, tuple):
            return [self._node_value(self._nodes[name])
                    for name in name_or_names]
        return self._node_value(self._nodes[name_or_names])

    @staticmethod
    def _node_value(node):
        return node.tensor if isinstance(node, StochasticTensor) else node

    def local_log_prob(self, name_or_names):
        """Alias of :meth:`cond_log_prob` (reference bn.py:1216-1226)."""
        return self.cond_log_prob(name_or_names)

    def query(self, name_or_names, outputs=False, local_log_prob=False):
        """Values and/or conditional log-probs in one call: ``(value,
        log_prob)`` tuples, a list of them for several names (reference
        bn.py:1228-1249)."""
        name_or_names = self._check_names_exist(name_or_names)
        ret = []
        if outputs:
            ret.append(self.outputs(name_or_names))
        if local_log_prob:
            ret.append(self.local_log_prob(name_or_names))
        if len(ret) == 0:
            raise ValueError("No query options are selected.")
        if isinstance(name_or_names, tuple):
            return list(zip(*ret))
        return tuple(ret)

    # -- sugar methods (reference bn.py:556-1189) ---------------------- #
    def normal(
        self, name, mean=0.0, _sentinel=None, std=None, logstd=None,
        group_ndims=0, n_samples=None, is_reparameterized=True,
        use_path_derivative=False, check_numerics=False, **kwargs,
    ):
        """Add a Normal node (reference bn.py:556)."""
        dist = distributions.Normal(
            mean, _sentinel=_sentinel, std=std, logstd=logstd,
            group_ndims=group_ndims, is_reparameterized=is_reparameterized,
            use_path_derivative=use_path_derivative,
            check_numerics=check_numerics, **kwargs)
        return self.stochastic(name, dist, n_samples=n_samples)

    def fold_normal(
        self, name, mean=0.0, _sentinel=None, std=None, logstd=None,
        group_ndims=0, n_samples=None, is_reparameterized=True,
        use_path_derivative=False, check_numerics=False, **kwargs,
    ):
        """Add a FoldNormal node (reference bn.py:592)."""
        dist = distributions.FoldNormal(
            mean, _sentinel=_sentinel, std=std, logstd=logstd,
            group_ndims=group_ndims, is_reparameterized=is_reparameterized,
            use_path_derivative=use_path_derivative,
            check_numerics=check_numerics, **kwargs)
        return self.stochastic(name, dist, n_samples=n_samples)

    def bernoulli(
        self, name, logits, group_ndims=0, n_samples=None,
        dtype=torch.int32, **kwargs,
    ):
        """Add a Bernoulli node (reference bn.py:628)."""
        dist = distributions.Bernoulli(
            logits, group_ndims=group_ndims, dtype=dtype, **kwargs)
        return self.stochastic(name, dist, n_samples=n_samples)

    def categorical(
        self, name, logits, group_ndims=0, n_samples=None,
        dtype=torch.int32, **kwargs,
    ):
        """Add a Categorical node (reference bn.py:656)."""
        dist = distributions.Categorical(
            logits, group_ndims=group_ndims, dtype=dtype, **kwargs)
        return self.stochastic(name, dist, n_samples=n_samples)

    discrete = categorical

    def uniform(
        self, name, minval=0.0, maxval=1.0, group_ndims=0, n_samples=None,
        is_reparameterized=True, check_numerics=False, **kwargs,
    ):
        """Add a Uniform node (reference bn.py:686)."""
        dist = distributions.Uniform(
            minval, maxval, group_ndims=group_ndims,
            is_reparameterized=is_reparameterized,
            check_numerics=check_numerics, **kwargs)
        return self.stochastic(name, dist, n_samples=n_samples)

    def gamma(
        self, name, alpha, beta, group_ndims=0, n_samples=None,
        check_numerics=False, **kwargs,
    ):
        """Add a Gamma node (reference bn.py:718)."""
        dist = distributions.Gamma(
            alpha, beta, group_ndims=group_ndims,
            check_numerics=check_numerics, **kwargs)
        return self.stochastic(name, dist, n_samples=n_samples)

    def beta(
        self, name, alpha, beta, group_ndims=0, n_samples=None,
        check_numerics=False, **kwargs,
    ):
        """Add a Beta node (reference bn.py:748)."""
        dist = distributions.Beta(
            alpha, beta, group_ndims=group_ndims,
            check_numerics=check_numerics, **kwargs)
        return self.stochastic(name, dist, n_samples=n_samples)

    def poisson(
        self, name, rate, group_ndims=0, n_samples=None, dtype=torch.int32,
        check_numerics=False, **kwargs,
    ):
        """Add a Poisson node (reference bn.py:778)."""
        dist = distributions.Poisson(
            rate, group_ndims=group_ndims, dtype=dtype,
            check_numerics=check_numerics, **kwargs)
        return self.stochastic(name, dist, n_samples=n_samples)

    def binomial(
        self, name, logits, n_experiments, group_ndims=0, n_samples=None,
        dtype=torch.int32, check_numerics=False, **kwargs,
    ):
        """Add a Binomial node (reference bn.py:808)."""
        dist = distributions.Binomial(
            logits, n_experiments, group_ndims=group_ndims, dtype=dtype,
            check_numerics=check_numerics, **kwargs)
        return self.stochastic(name, dist, n_samples=n_samples)

    def multivariate_normal_cholesky(
        self, name, mean, cov_tril, group_ndims=0, n_samples=None,
        is_reparameterized=True, use_path_derivative=False,
        check_numerics=False, **kwargs,
    ):
        """Add a MultivariateNormalCholesky node (reference bn.py:840)."""
        dist = distributions.MultivariateNormalCholesky(
            mean, cov_tril, group_ndims=group_ndims,
            is_reparameterized=is_reparameterized,
            use_path_derivative=use_path_derivative,
            check_numerics=check_numerics, **kwargs)
        return self.stochastic(name, dist, n_samples=n_samples)

    def multivariate_student_t_cholesky(
        self, name, df, loc, scale_tril, group_ndims=0, n_samples=None,
        is_reparameterized=True, use_path_derivative=False,
        check_numerics=False, **kwargs,
    ):
        """Add a MultivariateStudentTCholesky node (the JAX package's,
        beyond the reference)."""
        dist = distributions.MultivariateStudentTCholesky(
            df, loc, scale_tril, group_ndims=group_ndims,
            is_reparameterized=is_reparameterized,
            use_path_derivative=use_path_derivative,
            check_numerics=check_numerics, **kwargs)
        return self.stochastic(name, dist, n_samples=n_samples)

    def matrix_variate_normal_cholesky(
        self, name, mean, u_tril, v_tril, group_ndims=0, n_samples=None,
        is_reparameterized=True, use_path_derivative=False,
        check_numerics=False, **kwargs,
    ):
        """Add a MatrixVariateNormalCholesky node (reference bn.py:872)."""
        dist = distributions.MatrixVariateNormalCholesky(
            mean, u_tril, v_tril, group_ndims=group_ndims,
            is_reparameterized=is_reparameterized,
            use_path_derivative=use_path_derivative,
            check_numerics=check_numerics, **kwargs)
        return self.stochastic(name, dist, n_samples=n_samples)

    def multinomial(
        self, name, logits, n_experiments, normalize_logits=True,
        group_ndims=0, n_samples=None, dtype=torch.int32, **kwargs,
    ):
        """Add a Multinomial node (reference bn.py:906)."""
        dist = distributions.Multinomial(
            logits, n_experiments, normalize_logits=normalize_logits,
            group_ndims=group_ndims, dtype=dtype, **kwargs)
        return self.stochastic(name, dist, n_samples=n_samples)

    def unnormalized_multinomial(
        self, name, logits, normalize_logits=True, group_ndims=0,
        dtype=torch.int32, **kwargs,
    ):
        """Add an UnnormalizedMultinomial node (reference bn.py:938); it
        cannot be sampled, so it takes no ``n_samples``."""
        dist = distributions.UnnormalizedMultinomial(
            logits, normalize_logits=normalize_logits,
            group_ndims=group_ndims, dtype=dtype, **kwargs)
        return self.stochastic(name, dist)

    bag_of_categoricals = unnormalized_multinomial

    def onehot_categorical(
        self, name, logits, group_ndims=0, n_samples=None, dtype=torch.int32,
        **kwargs,
    ):
        """Add a OnehotCategorical node (reference bn.py:969)."""
        dist = distributions.OnehotCategorical(
            logits, group_ndims=group_ndims, dtype=dtype, **kwargs)
        return self.stochastic(name, dist, n_samples=n_samples)

    onehot_discrete = onehot_categorical

    def dirichlet(
        self, name, alpha, group_ndims=0, n_samples=None,
        check_numerics=False, **kwargs,
    ):
        """Add a Dirichlet node (reference bn.py:999)."""
        dist = distributions.Dirichlet(
            alpha, group_ndims=group_ndims, check_numerics=check_numerics,
            **kwargs)
        return self.stochastic(name, dist, n_samples=n_samples)

    def inverse_gamma(
        self, name, alpha, beta, group_ndims=0, n_samples=None,
        check_numerics=False, **kwargs,
    ):
        """Add an InverseGamma node (reference bn.py:1027)."""
        dist = distributions.InverseGamma(
            alpha, beta, group_ndims=group_ndims,
            check_numerics=check_numerics, **kwargs)
        return self.stochastic(name, dist, n_samples=n_samples)

    def laplace(
        self, name, loc, scale, group_ndims=0, n_samples=None,
        is_reparameterized=True, use_path_derivative=False,
        check_numerics=False, **kwargs,
    ):
        """Add a Laplace node (reference bn.py:1057)."""
        dist = distributions.Laplace(
            loc, scale, group_ndims=group_ndims,
            is_reparameterized=is_reparameterized,
            use_path_derivative=use_path_derivative,
            check_numerics=check_numerics, **kwargs)
        return self.stochastic(name, dist, n_samples=n_samples)

    # -- heads beyond the reference (distributions/extra.py) ---------- #
    def student_t(
        self, name, df, loc=0.0, scale=1.0, group_ndims=0, n_samples=None,
        is_reparameterized=True, use_path_derivative=False,
        check_numerics=False, **kwargs,
    ):
        """Add a StudentT node (beyond reference)."""
        dist = distributions.StudentT(
            df, loc, scale, group_ndims=group_ndims,
            is_reparameterized=is_reparameterized,
            use_path_derivative=use_path_derivative,
            check_numerics=check_numerics, **kwargs)
        return self.stochastic(name, dist, n_samples=n_samples)

    def exponential(
        self, name, rate, group_ndims=0, n_samples=None,
        is_reparameterized=True, use_path_derivative=False,
        check_numerics=False, **kwargs,
    ):
        """Add an Exponential node (beyond reference)."""
        dist = distributions.Exponential(
            rate, group_ndims=group_ndims,
            is_reparameterized=is_reparameterized,
            use_path_derivative=use_path_derivative,
            check_numerics=check_numerics, **kwargs)
        return self.stochastic(name, dist, n_samples=n_samples)

    def cauchy(
        self, name, loc, scale, group_ndims=0, n_samples=None,
        is_reparameterized=True, use_path_derivative=False,
        check_numerics=False, **kwargs,
    ):
        """Add a Cauchy node (beyond reference)."""
        dist = distributions.Cauchy(
            loc, scale, group_ndims=group_ndims,
            is_reparameterized=is_reparameterized,
            use_path_derivative=use_path_derivative,
            check_numerics=check_numerics, **kwargs)
        return self.stochastic(name, dist, n_samples=n_samples)

    def half_cauchy(
        self, name, scale, group_ndims=0, n_samples=None,
        is_reparameterized=True, use_path_derivative=False,
        check_numerics=False, **kwargs,
    ):
        """Add a HalfCauchy node (beyond reference)."""
        dist = distributions.HalfCauchy(
            scale, group_ndims=group_ndims,
            is_reparameterized=is_reparameterized,
            use_path_derivative=use_path_derivative,
            check_numerics=check_numerics, **kwargs)
        return self.stochastic(name, dist, n_samples=n_samples)

    def log_normal(
        self, name, mean=0.0, scale=1.0, group_ndims=0, n_samples=None,
        is_reparameterized=True, use_path_derivative=False,
        check_numerics=False, **kwargs,
    ):
        """Add a LogNormal node (beyond reference)."""
        dist = distributions.LogNormal(
            mean, scale, group_ndims=group_ndims,
            is_reparameterized=is_reparameterized,
            use_path_derivative=use_path_derivative,
            check_numerics=check_numerics, **kwargs)
        return self.stochastic(name, dist, n_samples=n_samples)

    def negative_binomial(
        self, name, logits, total_count, dtype=None, group_ndims=0,
        n_samples=None, check_numerics=False, **kwargs,
    ):
        """Add a NegativeBinomial node (beyond reference)."""
        dist = distributions.NegativeBinomial(
            logits, total_count,
            dtype=torch.int32 if dtype is None else dtype,
            group_ndims=group_ndims, check_numerics=check_numerics,
            **kwargs)
        return self.stochastic(name, dist, n_samples=n_samples)

    def truncated_normal(
        self, name, loc, scale, low, high, group_ndims=0, n_samples=None,
        is_reparameterized=True, use_path_derivative=False,
        check_numerics=False, **kwargs,
    ):
        """Add a TruncatedNormal node (beyond reference)."""
        dist = distributions.TruncatedNormal(
            loc, scale, low, high, group_ndims=group_ndims,
            is_reparameterized=is_reparameterized,
            use_path_derivative=use_path_derivative,
            check_numerics=check_numerics, **kwargs)
        return self.stochastic(name, dist, n_samples=n_samples)

    def weibull(
        self, name, concentration, scale, group_ndims=0, n_samples=None,
        is_reparameterized=True, use_path_derivative=False,
        check_numerics=False, **kwargs,
    ):
        """Add a Weibull node (beyond reference)."""
        dist = distributions.Weibull(
            concentration, scale, group_ndims=group_ndims,
            is_reparameterized=is_reparameterized,
            use_path_derivative=use_path_derivative,
            check_numerics=check_numerics, **kwargs)
        return self.stochastic(name, dist, n_samples=n_samples)

    def right_censored(
        self, name, base, upper, group_ndims=0, n_samples=None, **kwargs,
    ):
        """Add a RightCensored node wrapping a distribution instance
        (beyond reference; the survival observation model)."""
        dist = distributions.RightCensored(
            base, upper, group_ndims=group_ndims, **kwargs)
        return self.stochastic(name, dist, n_samples=n_samples)

    def beta_binomial(
        self, name, n_experiments, alpha, beta, dtype=None, group_ndims=0,
        n_samples=None, check_numerics=False, **kwargs,
    ):
        """Add a BetaBinomial node (beyond reference)."""
        dist = distributions.BetaBinomial(
            n_experiments, alpha, beta,
            dtype=torch.int32 if dtype is None else dtype,
            group_ndims=group_ndims, check_numerics=check_numerics,
            **kwargs)
        return self.stochastic(name, dist, n_samples=n_samples)

    def ordered_logistic(
        self, name, eta, cutpoints, dtype=None, group_ndims=0,
        n_samples=None, **kwargs,
    ):
        """Add an OrderedLogistic node (beyond reference)."""
        dist = distributions.OrderedLogistic(
            eta, cutpoints, dtype=torch.int32 if dtype is None else dtype,
            group_ndims=group_ndims, **kwargs)
        return self.stochastic(name, dist, n_samples=n_samples)

    def zero_inflated(
        self, name, base, pi_logits, group_ndims=0, n_samples=None,
        **kwargs,
    ):
        """Add a ZeroInflated node wrapping a count distribution instance
        (beyond reference)."""
        dist = distributions.ZeroInflated(
            base, pi_logits, group_ndims=group_ndims, **kwargs)
        return self.stochastic(name, dist, n_samples=n_samples)

    def bin_concrete(
        self, name, temperature, logits, group_ndims=0, n_samples=None,
        is_reparameterized=True, use_path_derivative=False,
        check_numerics=False, **kwargs,
    ):
        """Add a BinConcrete node (reference bn.py:1089)."""
        dist = distributions.BinConcrete(
            temperature, logits, group_ndims=group_ndims,
            is_reparameterized=is_reparameterized,
            use_path_derivative=use_path_derivative,
            check_numerics=check_numerics, **kwargs)
        return self.stochastic(name, dist, n_samples=n_samples)

    bin_gumbel_softmax = bin_concrete

    def exp_concrete(
        self, name, temperature, logits, group_ndims=0, n_samples=None,
        is_reparameterized=True, use_path_derivative=False,
        check_numerics=False, **kwargs,
    ):
        """Add an ExpConcrete node (reference bn.py:1123)."""
        dist = distributions.ExpConcrete(
            temperature, logits, group_ndims=group_ndims,
            is_reparameterized=is_reparameterized,
            use_path_derivative=use_path_derivative,
            check_numerics=check_numerics, **kwargs)
        return self.stochastic(name, dist, n_samples=n_samples)

    exp_gumbel_softmax = exp_concrete

    def concrete(
        self, name, temperature, logits, group_ndims=0, n_samples=None,
        is_reparameterized=True, use_path_derivative=False,
        check_numerics=False, **kwargs,
    ):
        """Add a Concrete node (reference bn.py:1157)."""
        dist = distributions.Concrete(
            temperature, logits, group_ndims=group_ndims,
            is_reparameterized=is_reparameterized,
            use_path_derivative=use_path_derivative,
            check_numerics=check_numerics, **kwargs)
        return self.stochastic(name, dist, n_samples=n_samples)

    gumbel_softmax = concrete

    def implicit(self, name, samples, value_shape=(), group_ndims=0,
                 **kwargs):
        """Add an Implicit node wrapping samples made elsewhere (GAN
        support; reference legacy/distributions/special.py:96)."""
        dist = distributions.Implicit(
            samples, value_shape=value_shape, group_ndims=group_ndims,
            **kwargs)
        return self.stochastic(name, dist)

    def empirical(self, name, dtype, batch_shape=(), value_shape=(),
                  group_ndims=0, **kwargs):
        """Add an Empirical (always observed) node (reference
        legacy/distributions/special.py:19)."""
        dist = distributions.Empirical(
            dtype, batch_shape=batch_shape, value_shape=value_shape,
            group_ndims=group_ndims, **kwargs)
        return self.stochastic(name, dist)

    def mixture(
        self, name, logits, components, group_ndims=0, n_samples=None,
        **kwargs,
    ):
        """Add a finite Mixture node (beyond the reference): ``logits``
        over the last batch axis of the K-batched ``components``
        distribution; the assignment is marginalized in ``log_prob``."""
        dist = distributions.Mixture(
            logits, components, group_ndims=group_ndims, **kwargs)
        return self.stochastic(name, dist, n_samples=n_samples)
