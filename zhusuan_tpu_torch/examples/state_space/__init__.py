"""State-space examples: Poisson change-point detection by compound Gibbs
sampling (:mod:`.changepoint`)."""
