"""methods of the PyTorch port (see the package docstring)."""
