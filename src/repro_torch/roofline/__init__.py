"""Roofline analysis of the pod dry run (port of ``repro.roofline``):
``analysis`` (the record, the H100 SXM constants) and ``counter`` (the
trace's cost counter, the counterpart of the reference's HLO parser)."""

from repro_torch.roofline.analysis import (  # noqa: F401
    HBM_BW,
    NODE_BW,
    NVLINK_BW,
    PEAK_FLOPS,
    RooflineRecord,
    build_record,
    format_table,
    model_flops,
)
