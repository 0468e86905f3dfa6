"""The port's profiling hooks (`utils/profiling.py`) and debug tap
(`ops/debug.py`) on the CPU."""

import json

import numpy as np
import pytest
import torch

from sam6d_tpu_torch.ops.debug import DEBUG_ENV, debug_tap
from sam6d_tpu_torch.utils import profiling


def test_trace_writes_a_chrome_trace_naming_the_span(tmp_path):
    with profiling.trace(str(tmp_path / "trace")) as prof:
        with profiling.annotate("pem_request_span"):
            torch.randn(64, 64) @ torch.randn(64, 64)
    files = list((tmp_path / "trace").glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "pem_request_span" for e in events)
    assert any(e.key == "pem_request_span" for e in prof.key_averages())


def test_trace_disabled_writes_nothing(tmp_path):
    with profiling.trace(str(tmp_path / "off"), enabled=False) as prof:
        pass
    assert prof is None and not (tmp_path / "off").exists()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int64])
def test_debug_tap_is_the_identity_and_dumps_when_set(tmp_path, monkeypatch,
                                                      dtype):
    x = (torch.randn(3, 5) * 10).to(dtype)
    monkeypatch.delenv(DEBUG_ENV, raising=False)
    assert debug_tap(x, "off", str(tmp_path)) is x
    assert not list(tmp_path.iterdir())
    monkeypatch.setenv(DEBUG_ENV, "1")
    assert debug_tap(x, "node", str(tmp_path / "taps")) is x
    saved = np.load(tmp_path / "taps" / "torch_debug_node_node.npy")
    np.testing.assert_array_equal(saved, x.float().numpy()
                                  if dtype == torch.bfloat16 else x.numpy())
