"""Predictive model comparison: PSIS-LOO and WAIC over HMC draws
(:mod:`.loo_compare`)."""
