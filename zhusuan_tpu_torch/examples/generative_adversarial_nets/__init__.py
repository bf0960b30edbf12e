"""GANs whose generator is a BayesianNet: DCGAN (:mod:`.dcgan`) and the
weight-clipped Wasserstein GAN (:mod:`.wasserstein_gan`)."""
