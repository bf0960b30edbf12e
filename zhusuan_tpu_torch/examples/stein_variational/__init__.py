"""Stein variational examples: Bayesian logistic regression by SVGD
(:mod:`.blr_svgd`)."""
