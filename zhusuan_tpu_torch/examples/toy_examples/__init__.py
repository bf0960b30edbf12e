"""Toy examples: mean-field SGVB on the 2-D intractable posterior
(:mod:`.toy2d_intractable`) and HMC on a diagonal Gaussian
(:mod:`.gaussian`)."""
