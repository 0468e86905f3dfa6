"""geo_embed_bwd_roofline: K3's (`csrc/geo_embed.cu`, the geometric
embedding's backward, its kernel and its fold) least possible time for
the calls in the traced window over its device time there, in percent.
A call on B clouds of N points, width d, element size es: per pair and
channel 40 + 84 multiply-adds (dMd, dMa) on the tensor cores; the
incoming gradient, the winners and the index fields read once, the three
outputs written once: `chip_smoke.check_geo_embed_bwd`'s count, frozen."""

from portbench.harness.peaks import bound_tc_s


def read(rec):
    p, calls = rec.profile, rec.extra.get("calls", {}).get("geo_embed_bwd")
    if p is None or not calls or rec.launches.get("geo_embed_bwd") != len(calls):
        return None
    sec, _ = p.kernel_s(lambda name: "geo_embed_bwd" in name)
    if sec <= 0:
        return None
    need = 0.0
    for B, N, d, es in calls:
        pairs = B * N * N
        splits = 4 if es == 4 else 1
        need += bound_tc_s(pairs * (d * es + d + 16) + 69 * d * 4,
                           pairs * d * 2 * (40 + 84) * splits)
    return 100.0 * need / sec
