"""Variational autoencoders: the VAE (:mod:`.vae`) and the IWAE
(:mod:`.iwae`)."""
