"""pem_runner.pad_pct: the padded rows over the bucket rows of the frames
served in the traced window (`PEMRunner.bucket_for`)."""


def read(rec):
    if rec.profile is None or not rec.frames or "bucket" not in rec.frames[0]:
        return None
    rows = sum(f["bucket"] for f in rec.frames)
    return 100.0 * sum(f["bucket"] - f["n"] for f in rec.frames) / rows
