"""fps_roofline: K1's (`csrc/fps.cu`) least possible time for the calls in
the traced window over its device time there, in percent.  A call on
(B, N, 3) float32 points choosing npoint reads the points once and writes
the int64 indices once, and does about 10 float32 operations for each
point and step (3 subtractions, 3 multiplications, 2 additions, a min, a
compare): `chip_smoke.check_fps`'s count, frozen."""

from portbench.harness.peaks import bound_s


def read(rec):
    p, calls = rec.profile, rec.extra.get("calls", {}).get("fps")
    if p is None or not calls:
        return None
    sec, n = p.kernel_s(lambda name: "fps_kernel" in name
                        or "fps_global_kernel" in name)
    if sec <= 0 or n != len(calls):
        return None
    need = sum(bound_s(B * N * 12 + B * npoint * 8,
                       B * (npoint - 1) * N * 10, "float32")
               for B, N, npoint in calls)
    return 100.0 * need / sec
