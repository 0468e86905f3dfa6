"""The port's PEMRunner.infer against the JAX PEMRunner.infer.

3 instances pad to a bucket of 4 (the pad row repeats the first).
Setup, tolerances and the reason JAX runs op by op are those of
test_torch_pem.py; max_bucket=2 is held in
test_torch_pem_runner_chunks.py (one file per batch shape, so that the
eager JAX runs go to different workers).
"""

import pytest
import torch

from tests.test_torch_pem import build_tiny, check_runner

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tiny():
    return build_tiny()


def test_runner_infer_matches_bucket_4(tiny):
    check_runner(tiny, None, 4)
