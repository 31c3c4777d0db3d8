"""Roofline analysis of the port's cells on one card: the twin of
``repro.roofline``."""
from repro_torch.roofline.analysis import (
    HW,
    collective_wire_bytes,
    model_flops,
    parse_collectives,
    roofline_terms,
)
from repro_torch.roofline.op_cost import Cost, op_cost

__all__ = ["HW", "Cost", "collective_wire_bytes", "model_flops", "op_cost",
           "parse_collectives", "roofline_terms"]
