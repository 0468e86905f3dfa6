"""setup_s: process start to the first timed frame or step (loading, the
weights' draw, onboarding, warm-up, and in a first run the kernels'
build), on the host clock."""


def read(rec):
    return rec.setup_s
