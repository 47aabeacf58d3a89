"""Training: losses, optimizer, train state, step builders, trainer,
checkpoints and metrics logging."""

from perceiver_io_torch.training.steps import (
    make_ar_steps,
    make_classifier_steps,
    make_flow_steps,
    make_guarded_step,
    make_mlm_steps,
    make_multimodal_steps,
)

__all__ = ["make_ar_steps", "make_classifier_steps", "make_flow_steps", "make_guarded_step",
           "make_mlm_steps", "make_multimodal_steps"]
