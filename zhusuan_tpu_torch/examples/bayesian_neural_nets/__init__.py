"""Bayesian neural networks: mean-field SGVB (:mod:`.bnn_vi`) and SGHMC
with EM on the prior scales (:mod:`.bnn_sgmcmc`)."""
