"""train.forward_idle_ms: the card's idle ms a step whose gaps fall, at
their midpoint, inside the program's `train.to_device` or
`train.forward` span (the batch to the card, the forward and the loss),
in the profiled window (`harness/spans.py`)."""

from portbench.harness import spans


def read(rec):
    return spans.tree_per_unit(rec, ("train.to_device", "train.forward"),
                               "tree_idle_ms")
