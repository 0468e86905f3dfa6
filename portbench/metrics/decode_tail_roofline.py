"""decode_tail_roofline: K6's (`csrc/decode_tail.cu`: the mask decoder's
upscaling tail reduced to each candidate's stability and box) least
possible time for the calls in the traced window over its device time
there (its tile kernel and its reduction), in percent.  A call on P
prompts of N key tokens: per token, stage 1 (256 x 256) as two bf16
products (bf16 keys, the float32 weight split into hi and lo), stage 2
(4 x 64 x 128) as three, on the tensor cores; on the CUDA cores the
hypernetwork contraction (4 x 12 x 32 multiply-adds) and about 10
operations for each LayerNorm and GELU value (256 + 512); the keys read
once, the statistics written once, the weights read once:
`chip_smoke.check_decode_tail`'s count, frozen."""

from portbench.harness.peaks import bound_tc_s


def read(rec):
    p, calls = rec.profile, rec.extra.get("calls", {}).get("decode_tail")
    if p is None or not calls:
        return None
    sec, n = p.kernel_s(lambda name: "decode_tail_mma_kernel" in name
                        or "reduce_tiles_kernel" in name)
    if sec <= 0:
        return None
    need = 0.0
    for P, N, es in calls:
        tokens = P * N
        splits = 2 if es == 2 else 3
        tc = tokens * 2 * (splits * 256 * 256 + 3 * 4 * 64 * 128)
        f32 = tokens * (2 * 4 * 12 * 32 + 10 * (256 + 512))
        nbytes = (tokens * 256 * es + P * (96 + 96) * 4
                  + (256 * 256 + 64 * 128 + 896) * 4)
        need += bound_tc_s(nbytes, tc, f32)
    return 100.0 * need / sec
