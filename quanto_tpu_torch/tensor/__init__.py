"""tensor of quanto_tpu_torch (see the package docstring)."""
