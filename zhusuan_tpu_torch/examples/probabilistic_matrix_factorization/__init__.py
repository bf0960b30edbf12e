"""Probabilistic matrix factorization with alternating HMC
(:mod:`.pmf_hmc`)."""
