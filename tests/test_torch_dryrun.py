"""The port's dry run (``repro_torch.launch.dryrun``) end to end, each cell
in a subprocess (its fake group of 256 or 512 ranks must be the process's
default group): the twin of ``tests/test_dryrun.py``, held to the
reference test's own bounds with the port's numbers.  The fake tensors are
CPU tensors on a CPU mesh (``--device cpu``); nothing is allocated at
full scale.  The reference's own run of the multi-pod train cell fails
(``peak_bytes_tpu_est``); the port's is not compared with it.
"""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_cell(arch, shape, multi_pod=False):
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
           "--device", "cpu"]
    if multi_pod:
        cmd.append("--multi-pod")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    last = [line for line in out.stdout.splitlines() if line.startswith("{")][-1]
    return json.loads(last)


@pytest.mark.slow
def test_dryrun_decode_cell_single_pod():
    d = _run_cell("rwkv6-1.6b", "decode_32k")
    assert d["status"] == "ok"
    assert d["chips"] == 256
    assert d["peak_bytes"] < 16e9
    assert d["hlo_flops"] > 0 and d["hlo_bytes"] > 0
    assert d["bottleneck"] in ("t_compute", "t_memory", "t_collective")


@pytest.mark.slow
def test_dryrun_train_cell_multi_pod():
    d = _run_cell("qwen2.5-3b", "train_4k", multi_pod=True)
    assert d["status"] == "ok"
    assert d["chips"] == 512
    assert d["microbatches"] == 8
    assert d["peak_bytes"] < 16e9
    assert d["model_hlo_ratio"] > 0.2  # sane useful-flops fraction
    assert d["collective_bytes"] > 0 and d["collectives"]["all-reduce"] > 0


@pytest.mark.slow
def test_dryrun_skip_cell():
    d = _run_cell("qwen3-4b", "long_500k")
    assert d["status"] == "skipped"
    assert "sub-quadratic" in d["reason"]
