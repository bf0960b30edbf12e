"""Examples of the port (counterpart of the repository's ``examples/``)."""
