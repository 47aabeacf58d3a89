"""Part of the perceiver_io_torch port; see the package docstring. The
optical-flow and multimodal models' names are exported here, as the JAX
package's ``models`` exports them."""

from perceiver_io_torch.models.flow import (
    DenseSpatialOutputAdapter,
    OpticalFlowInputAdapter,
    build_optical_flow_model,
    end_point_error,
    extract_patches,
)
from perceiver_io_torch.models.multimodal import (
    AudioInputAdapter,
    AudioOutputAdapter,
    MultimodalInputAdapter,
    MultimodalOutputAdapter,
    VideoInputAdapter,
    VideoOutputAdapter,
    build_multimodal_autoencoder,
    multimodal_autoencoding_loss,
    patchify_video,
)

__all__ = ["AudioInputAdapter", "AudioOutputAdapter", "DenseSpatialOutputAdapter",
           "MultimodalInputAdapter", "MultimodalOutputAdapter", "OpticalFlowInputAdapter",
           "VideoInputAdapter", "VideoOutputAdapter", "build_multimodal_autoencoder",
           "build_optical_flow_model", "end_point_error", "extract_patches",
           "multimodal_autoencoding_loss", "patchify_video"]
