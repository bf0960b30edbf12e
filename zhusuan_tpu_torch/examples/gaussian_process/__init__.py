"""Gaussian-process examples: the SVGP training path (:mod:`.svgp`), the
library GP API on diabetes (:mod:`.gp_regression_diabetes`) and GP
classification by elliptical slice sampling
(:mod:`.gp_classification_ess`)."""
