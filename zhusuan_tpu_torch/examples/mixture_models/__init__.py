"""Mixture examples: a Bayesian Gaussian mixture by HMC on the
:class:`~zhusuan_tpu_torch.distributions.Mixture` head (:mod:`.gmm`)."""
