"""On the card: each cell's fp8 control, in the program's place at the
cell's own size, comes out not correct; the program comes out correct.
Run with ``python -m pytest -m gpu portbench/tests/test_pb_gpu.py``."""
import json
import subprocess
import sys

import pytest

from portbench import harness

pytestmark = pytest.mark.gpu
SEED = 3_000_000_101


def _run(workload: str, seconds: float):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", str(SEED), "--seconds", str(seconds), "--trace", "0",
         "--control", "fp8"], cwd=harness.ROOT, capture_output=True,
        text=True, timeout=900, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("workload", [w["name"] for w in
                                      harness.Bench().spec["workloads"]])
def test_control_fails_and_program_passes(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    res = _run(workload, 10.0)
    assert res["program"]["correct"], res["program"]["checks"]
    assert not res["correct"], res["checks"]
