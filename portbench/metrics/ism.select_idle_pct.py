"""ism.select_idle_pct: the share of the card's idle time in the profiled
window (the gaps between its operations) whose gaps fall, at their
midpoint, inside the program's `amg_select` span: the AMG's thresholds,
NMS and mask upscale on the host side (`harness/spans.py`)."""

from portbench.harness import spans


def read(rec):
    return spans.idle_share(rec, ("amg_select",))
