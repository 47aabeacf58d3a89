"""Part of the perceiver_io_torch port; see the package docstring. The
generation engines' names are exported here, as the JAX package's
``inference`` exports them."""

from perceiver_io_torch.inference.batching import ArenaSession, ContinuousBatcher
from perceiver_io_torch.inference.generate import (
    ARGenerator,
    GenSession,
    SamplingConfig,
    sample_logits_rows,
)

__all__ = ["ARGenerator", "ArenaSession", "ContinuousBatcher", "GenSession", "SamplingConfig",
           "sample_logits_rows"]
