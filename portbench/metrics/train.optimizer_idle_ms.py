"""train.optimizer_idle_ms: the card's idle ms a step whose gaps fall,
at their midpoint, inside the program's `train.read_metrics` span (the
host's `.tolist()` of the metrics and gradient norm, a sync) or its
`train.optimizer` span, in the profiled window (`harness/spans.py`)."""

from portbench.harness import spans


def read(rec):
    return spans.tree_per_unit(rec, ("train.read_metrics",
                                     "train.optimizer"), "tree_idle_ms")
