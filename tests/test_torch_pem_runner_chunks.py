"""The port's PEMRunner with max_bucket=2 against the JAX PEMRunner.

3 instances run as chunks [0:2] and [2:3] + one pad row, each chunk
reusing the runner's key.  Setup, tolerances and the reason JAX runs op
by op are those of test_torch_pem.py (a file of its own so that the two
batch shapes' eager JAX runs go to different workers).
"""

import pytest
import torch

from tests.test_torch_pem import build_tiny, check_runner

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tiny():
    return build_tiny()


def test_runner_infer_matches_max_bucket_2(tiny):
    check_runner(tiny, 2, 2)
