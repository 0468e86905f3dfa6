"""flash_rpe_roofline: K4's (`csrc/flash_rpe.cu`, attention with SAM's
decomposed rel-pos bias) least possible time for the calls in the traced
window over its device time there, in percent.  A call on BH heads of an
h x w token grid (N = h w) with head width d: q k^T and P v (4 BH N^2 d),
the per-token tables (2 BH N d (h + w)) and the bias add (2 BH N^2);
q, k, v read and the output written once, the two tables read once:
`chip_smoke.check_attention`'s count, frozen, at the bf16 peak."""

from portbench.harness.peaks import bound_s
from portbench.harness.trace import is_flash_bias


def read(rec):
    p, calls = rec.profile, rec.extra.get("calls", {}).get("flash_rpe")
    if p is None or not calls:
        return None
    sec, n = p.kernel_s(lambda name: is_flash_bias(name) is True)
    if sec <= 0 or n != len(calls):
        return None
    need = 0.0
    for BH, h, w, d, es in calls:
        N = h * w
        flops = 4 * BH * N * N * d + 2 * BH * N * d * (h + w) + 2 * BH * N * N
        nbytes = 4 * BH * N * d * es + (2 * h + 2 * w - 2) * d * es
        need += bound_s(nbytes, flops, "bfloat16" if es == 2 else "float32")
    return 100.0 * need / sec
