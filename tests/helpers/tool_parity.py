"""Shared pieces of the accuracy-loop parity tests (the port's
`sam6d_tpu_torch/tools/` against the JAX `tools/`)."""

import numpy as np
import pytest


@pytest.fixture
def numpy_rasterizers(monkeypatch):
    """Both packages' rasterizers pinned to numpy: the native one differs
    from it on boundary pixels."""
    import sam6d_tpu.utils.native
    import sam6d_tpu_torch.utils.native

    for mod in (sam6d_tpu.utils.native, sam6d_tpu_torch.utils.native):
        monkeypatch.setattr(mod, "rasterize", lambda *a, **k: None)


def rel(a, b):
    """|a - b| / |b| (Frobenius, float64)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
