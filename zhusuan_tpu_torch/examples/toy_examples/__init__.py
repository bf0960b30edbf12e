"""Toy examples: mean-field SGVB on the 2-D intractable posterior
(:mod:`.toy2d_intractable`), HMC on a diagonal Gaussian (:mod:`.gaussian`)
and the VR / CUBO evidence sandwich (:mod:`.evidence_sandwich`)."""
