"""Part of the perceiver_io_torch port; see the package docstring. The
optical-flow and audio-video data's names are exported here."""

from perceiver_io_torch.data.av import (
    AVDataModule,
    AVDataset,
    load_av_tree,
    synthetic_av_clips,
)
from perceiver_io_torch.data.flow import (
    FlowDataModule,
    FlowDataset,
    load_sintel,
    read_flo,
    synthetic_flow_pairs,
    warp_backward,
)

__all__ = ["AVDataModule", "AVDataset", "FlowDataModule", "FlowDataset", "load_av_tree",
           "load_sintel", "read_flo", "synthetic_av_clips", "synthetic_flow_pairs",
           "warp_backward"]
