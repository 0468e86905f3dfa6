"""train.device_idle_pct: the share of the traced training window in which
no kernel, copy or set ran on the card (torch.profiler)."""


def read(rec):
    p = rec.profile
    if p is None or not rec.steps or p.window_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.window_s)
