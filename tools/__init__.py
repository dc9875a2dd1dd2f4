"""Scripts that drive or measure the port: see each module's docstring."""
