"""train.mfu_pct: the training step's floating-point operations (forward
and backward, the plain reference's, counted by FlopCounterMode;
`drivers/pem_train.flops_per_step`) for the steps in the traced window,
over the window, as a share of one H100's bf16 peak, 989 TFLOP/s."""

from portbench.harness.peaks import PEAK_FLOPS


def read(rec):
    p = rec.profile
    if p is None or not rec.steps or not rec.flops_per_step:
        return None
    done = sum(s["ok"] for s in rec.steps)
    return 100.0 * rec.flops_per_step * done / p.window_s \
        / PEAK_FLOPS["bfloat16"]
