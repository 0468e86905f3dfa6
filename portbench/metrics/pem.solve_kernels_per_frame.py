"""pem.solve_kernels_per_frame: the kernels (copies and sets left out)
launched inside the program's `pem.coarse_solve` and `pem.fine_solve`
spans in the profiled window, matched to their launches by correlation
id, over the frames served in it (`harness/spans.py`)."""

from portbench.harness import spans


def read(rec):
    return spans.tree_per_unit(rec, ("pem.coarse_solve", "pem.fine_solve"),
                               "tree_kernels")
