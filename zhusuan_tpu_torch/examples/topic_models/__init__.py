"""Topic models: the pathwise Dirichlet VAE (:mod:`.dirichlet_vae`) and the
logistic-normal topic model by Monte Carlo EM (:mod:`.lntm_mcem`)."""
