"""scatter_rows_roofline: K7's (`csrc/scatter_rows.cu`, the row
scatter-add behind the fine positional encoding's neighbour gathers, its
four kernels) least possible time for the calls in the traced window
over its device time there, in percent.  A call scattering B x Q bf16
rows of width C into B x N float32 targets reads the int64 indices and
the rows once and writes the targets once, one addition an element:
`chip_smoke.check_scatter_rows`'s count, frozen."""

from portbench.harness.peaks import bound_s


def read(rec):
    p, calls = rec.profile, rec.extra.get("calls", {}).get("scatter_rows")
    if p is None or not calls or rec.launches.get("scatter_rows") != len(calls):
        return None
    sec, _ = p.kernel_s(lambda name: "scatter_rows_" in name)
    if sec <= 0:
        return None
    need = sum(bound_s(B * Q * (C * 2 + 8) + B * N * C * 4, B * Q * C,
                       "float32") for B, Q, N, C in calls)
    return 100.0 * need / sec
