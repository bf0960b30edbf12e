"""Gaussian-process examples: the SVGP training path (:mod:`.svgp`)."""
