"""Hierarchical examples: eight schools (:mod:`.eight_schools`), HMC on the
non-centred model and the NUTS funnel diagnosis, and the LKJ covariance
model (:mod:`.covariance_estimation`), all NUTS runs on the kernel's
built-in densities."""
