"""pem.kernels_per_frame: the kernels that ran on the card in the traced
window (copies and sets left out) over the frames served in it."""


def read(rec):
    p = rec.profile
    if p is None or not rec.frames:
        return None
    _, n = p.kernel_s(lambda name: not name.startswith(("Memcpy", "Memset")))
    return n / len(rec.frames)
