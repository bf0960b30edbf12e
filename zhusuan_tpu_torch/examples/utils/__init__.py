"""Shared helpers of the port's examples (counterpart of ``examples/utils``)."""
