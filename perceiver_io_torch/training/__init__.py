"""Training: losses, optimizer, train state, step builders, trainer."""

from perceiver_io_torch.training.steps import make_ar_steps, make_mlm_steps

__all__ = ["make_ar_steps", "make_mlm_steps"]
