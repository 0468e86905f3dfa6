"""fastsam.select_idle_pct: the share of the card's idle time in the
profiled window (the gaps between its operations) whose gaps fall, at
their midpoint, inside the program's `fastsam_nms` and `fastsam_masks`
spans: the confidence threshold and greedy NMS on the host, and the
masks composed on the card and copied to the host (`harness/spans.py`)."""

from portbench.harness import spans


def read(rec):
    return spans.idle_share(rec, ("fastsam_nms", "fastsam_masks"))
