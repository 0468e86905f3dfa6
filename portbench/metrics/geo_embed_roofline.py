"""geo_embed_roofline: K2's (`csrc/geo_embed.cu`, forward) least possible
time for the calls in the traced window over its device time there, in
percent.  A call on B clouds of N points (embedding width d, output
element size es) reads the distance and angle index fields once (4 + 12
bytes a pair), writes the (B, N, N, d) embedding once, reads the folded
(40 + 28, d) matrices and the bias; each pair and channel takes
2 * (40 + 3 * 28) multiply-adds of the Chebyshev bases and 3 * (40 + 3 *
28) operations to build them: `chip_smoke.check_geo_embed`'s count,
frozen, at the bf16 peak."""

from portbench.harness.peaks import bound_s


def read(rec):
    p, calls = rec.profile, rec.extra.get("calls", {}).get("geo_embed")
    if p is None or not calls:
        return None
    sec, n = p.kernel_s(lambda name: "geo_embed_fwd" in name)
    if sec <= 0 or n != len(calls):
        return None
    need = 0.0
    for B, N, d, es in calls:
        pairs = B * N * N
        need += bound_s(pairs * (4 + 12 + d * es) + 68 * d * es + d * 4,
                        pairs * (2 * (40 + 3 * 28) * d + 3 * (40 + 3 * 28)),
                        "bfloat16" if es == 2 else "float32")
    return 100.0 * need / sec
