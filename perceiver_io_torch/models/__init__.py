"""Part of the perceiver_io_torch port; see the package docstring. The
optical-flow model's names are exported here, as the JAX package's
``models`` exports them."""

from perceiver_io_torch.models.flow import (
    DenseSpatialOutputAdapter,
    OpticalFlowInputAdapter,
    build_optical_flow_model,
    end_point_error,
    extract_patches,
)

__all__ = ["DenseSpatialOutputAdapter", "OpticalFlowInputAdapter", "build_optical_flow_model",
           "end_point_error", "extract_patches"]
