"""Measurement tools of the perceiver_io_torch port that run on the card."""
