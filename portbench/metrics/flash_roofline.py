"""flash_roofline: K5's (`csrc/flash_rpe.cu` without a bias: DINOv2's
attention) least possible time for the calls in the traced window over
its device time there, in percent.  A call on BH heads of N tokens with
head width d: q k^T and P v, 4 BH N^2 d operations; q, k, v read and
the output written once, 4 BH N d elements: `chip_smoke.check_attention`'s
count for K5, frozen, at the bf16 peak.  The calls are the cell's
(each traced frame's descriptor bucket through every block)."""

from portbench.harness.peaks import bound_s
from portbench.harness.trace import is_flash_bias


def read(rec):
    p, calls = rec.profile, rec.extra.get("calls", {}).get("flash")
    if p is None or not calls:
        return None
    sec, n = p.kernel_s(lambda name: is_flash_bias(name) is False)
    if sec <= 0 or n != len(calls):
        return None
    need = sum(bound_s(4 * BH * N * d * es, 4 * BH * N * N * d,
                       "bfloat16" if es == 2 else "float32")
               for BH, N, d, es in calls)
    return 100.0 * need / sec
