"""Part of the perceiver_io_torch port; see the package docstring."""
