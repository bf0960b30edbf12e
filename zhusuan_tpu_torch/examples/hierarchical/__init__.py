"""Hierarchical examples: eight schools (:mod:`.eight_schools`), HMC on the
non-centred model and the NUTS funnel diagnosis on the kernel's built-in
densities."""
