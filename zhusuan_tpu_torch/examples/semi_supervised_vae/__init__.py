"""The semi-supervised VAE (Kingma's M2): trained on the ELBO
(:mod:`.vae_ssl`) and with adaptive importance sampling
(:mod:`.vae_ssl_adaptive_is`)."""
