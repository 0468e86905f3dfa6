"""pem.solve_idle_pct: the share of the card's idle time in the profiled
window (the gaps between its operations) whose gaps fall, at their
midpoint, inside the program's `pem.coarse_solve` or `pem.fine_solve`
span: the host enqueueing the 6000-hypothesis coarse solve and the fine
solve (`harness/spans.py`)."""

from portbench.harness import spans


def read(rec):
    return spans.idle_share(rec, ("pem.coarse_solve", "pem.fine_solve"))
