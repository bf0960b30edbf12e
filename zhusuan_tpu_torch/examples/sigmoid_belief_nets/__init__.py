"""Sigmoid belief nets: the builders (:mod:`.sbn`) and VIMCO training
(:mod:`.sbn_vimco`)."""
