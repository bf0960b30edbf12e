"""Normalizing-flow examples: coupling-flow VI on the 2-D funnel
(:mod:`.toy2d_flow`) and the planar-flow VAE (:mod:`.vae_nf`)."""
