"""Part of the perceiver_io_torch port; see the package docstring. The
optical-flow data's names are exported here."""

from perceiver_io_torch.data.flow import (
    FlowDataModule,
    FlowDataset,
    load_sintel,
    read_flo,
    synthetic_flow_pairs,
    warp_backward,
)

__all__ = ["FlowDataModule", "FlowDataset", "load_sintel", "read_flo", "synthetic_flow_pairs",
           "warp_backward"]
