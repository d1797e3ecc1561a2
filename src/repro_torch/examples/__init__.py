"""The reference's example entry points (``examples/*.py``), ported.

One module per reference script, under the same name; each runs as

    PYTHONPATH=src python -m repro_torch.examples.<name>                 # the card
    PYTHONPATH=src python -m repro_torch.examples.<name> --cpu-lanes 1   # no card

and exposes ``main(argv=None, devices=None)``, which prints what the
reference prints and returns the printed numbers as a dict.  Every script
takes every CUDA device unless the caller passes ``devices`` or
``--cpu-lanes``, and raises without one (the rule of ``DeviceMesh()``):
there is no silent fallback to the CPU.

- ``quickstart``: PM vs the baselines (virtual time), a PM-planned
  multifrontal Cholesky executed in f64 on the devices, a capacity loss
  simulated;
- ``elastic_rescale``: failure detection, the elastic PM replan and the
  straggler-driven two-pod rebalance, all on the host;
- ``serve_lm``: two-pod request placement, then prefill (the flash kernel
  on the card) and greedy decode (one CUDA graph on the card) of a reduced
  qwen2.5-3b;
- ``train_lm``: a ~100M-parameter qwen3 trained with AdamW, microbatches,
  checkpoints and the straggler monitor;
- ``workload_serving``: the workload front end, simulated in virtual time
  on the host.
"""
from __future__ import annotations

import argparse
from typing import List, Optional, Sequence

import torch

from repro_torch.api import DeviceMesh


def add_device_flag(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    ap.add_argument("--cpu-lanes", type=int, default=0,
                    help="run on this many CPU lanes (plain kernel versions) "
                         "instead of the CUDA devices")
    return ap


def resolve_devices(devices: Optional[Sequence], cpu_lanes: int = 0) -> List[torch.device]:
    """``devices`` when given, else ``cpu_lanes`` CPU lanes when > 0, else
    every CUDA device (raises without one)."""
    if devices is None and cpu_lanes > 0:
        devices = [torch.device("cpu")] * cpu_lanes
    return DeviceMesh(devices).devices()
