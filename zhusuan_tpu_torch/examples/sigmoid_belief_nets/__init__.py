"""Sigmoid belief nets: the builders (:mod:`.sbn`), VIMCO training
(:mod:`.sbn_vimco`) and adaptive importance sampling
(:mod:`.sbn_adaptive_is`)."""
