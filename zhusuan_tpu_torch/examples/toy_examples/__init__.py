"""Toy examples: mean-field SGVB on the 2-D intractable posterior
(:mod:`.toy2d_intractable`), HMC on a diagonal Gaussian (:mod:`.gaussian`),
the VR / CUBO evidence sandwich (:mod:`.evidence_sandwich`), ChEES-HMC on an
ill-conditioned Gaussian (:mod:`.gaussian_chees`), NeuTra HMC on Neal's
funnel (:mod:`.neal_funnel_neutra`) and SGNHT on a two-mode mixture
(:mod:`.mixture_sgnht`)."""
