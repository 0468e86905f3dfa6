"""train_samples_per_s: the samples of every step completed in the
window over the window's length, which ends in torch.cuda.synchronize()."""


def read(rec):
    n = sum(s["samples"] for s in rec.steps if s["ok"])
    return n / rec.window_s if n and not rec.trace else None
