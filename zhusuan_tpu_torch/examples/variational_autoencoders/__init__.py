"""Variational autoencoders: the VAE (:mod:`.vae`), the IWAE (:mod:`.iwae`),
the Bernoulli-latent VAE with REINFORCE (:mod:`.bernoulli_latent_vae`), the
Gumbel-softmax VAE (:mod:`.gumbel_softmax_vae`) and the convolutional VAE
(:mod:`.vae_conv`)."""
