"""Robust and survival regression examples: Student-t regression by HMC
(:mod:`.robust_regression`), ordinal regression (:mod:`.ordinal_regression`)
and Weibull AFT survival regression (:mod:`.survival_regression`) by NUTS on
the kernel's built-in densities."""
