"""Bayesian neural networks: mean-field SGVB (:mod:`.bnn_vi`), SGHMC with
EM on the prior scales (:mod:`.bnn_sgmcmc`) and variational dropout
(:mod:`.variational_dropout`)."""
