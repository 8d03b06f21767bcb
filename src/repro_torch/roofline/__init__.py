"""Roofline analysis of the dry run (counterpart of ``repro.roofline``):
``analysis`` (the three terms of a step on the H100's data-sheet peaks),
``op_costs`` (FLOPs, HBM bytes, collective bytes and live bytes of an
eager step, counted op by op; the counterpart of ``hlo_costs``) and
``report`` (the Markdown tables)."""
