"""The port's profiling hooks (`utils/profiling.py`) and debug tap
(`ops/debug.py`) on the CPU."""

import json

import numpy as np
import pytest
import torch

from sam6d_tpu_torch.ops.debug import DEBUG_ENV, debug_tap
from sam6d_tpu_torch.utils import profiling, timer


def test_trace_writes_a_chrome_trace_naming_the_span(tmp_path):
    """The program's spans and counters inside the block land in the
    Chrome trace, on the profiler's clock: the span holds the matmul's
    CPU event (`cpu=True`; without a card it is recorded anyway)."""
    with profiling.trace(str(tmp_path / "trace"), cpu=True) as prof:
        with timer.stage(None, "pem_request_span", request=3):
            timer.count("rows", 2)
            torch.randn(64, 64) @ torch.randn(64, 64)
    files = list((tmp_path / "trace").glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    span = [e for e in events if e.get("name") == "pem_request_span"]
    assert len(span) == 1 and span[0]["cat"] == "program_span"
    assert span[0]["args"] == {"request": 3}
    assert [e["args"] for e in events if e.get("cat") == "program_counter"] \
        == [{"rows": 2}]
    mm = [e for e in events if e.get("name") == "aten::mm"]
    assert mm and span[0]["ts"] <= mm[0]["ts"] \
        and mm[0]["ts"] + mm[0]["dur"] <= span[0]["ts"] + span[0]["dur"]
    assert any(e.key == "aten::mm" for e in prof.key_averages())


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
