"""The port's loop-aware cost counter (``repro_torch.launch.hlocost``): the
twin of ``tests/test_hlocost.py`` and ``tests/test_hlocost_attention.py``,
the microbatch multiplier, and ``hlo_flop_scale`` against the reference's.

The reference's handwritten HLO is written as the torch program it stands
for: a loop of 8 (64×64)·(64×64) products, each reading a dynamic slice of
an (8, 128, 64) stack and feeding an all-reduce over groups of 32 of a
512-rank group.  The group is a fake one (``torch.testing``'s ``fake``
backend), the process's default group, so it runs in a subprocess.  The
counter must give the reference's expected numbers exactly.

``hlo_flop_scale``: the port counts the reduced prefill's ATen matmuls, the
reference walks XLA's optimized HLO of the same program.  Measured on this
CPU the ten ratios agree to the last bit; the test holds them to 1e-9
relative.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro.configs import ARCHS as R_ARCHS
from repro.workloads.costs import hlo_flop_scale as r_hlo_flop_scale
from repro_torch.configs import ARCHS
from repro_torch.launch.hlocost import attention_scan_bytes, count_costs
from repro_torch.models import build_loss_fn, init_params, random_batch
from repro_torch.models.attention import attend
from repro_torch.models.common import tree_items
from repro_torch.workloads.costs import hlo_flop_scale

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALE_TOL = 1e-9

_PROGRAM = r"""
import json
import torch, torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.distributed.device_mesh import init_device_mesh
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch.hlocost import count_costs

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=512)
group = init_device_mesh("cpu", (16, 32), mesh_dim_names=("a", "b")).get_group(1)
stack, acc = torch.randn(8, 128, 64), torch.randn(64, 64)

def body(acc, i):
    w = stack.index_select(0, torch.tensor([i]))[0]   # the dynamic slice (128, 64)
    d = acc @ w[:64]                                    # (64, 64) x (64, 64)
    return funcol.wait_tensor(funcol.all_reduce(d, "sum", group))

out = {}
with count_costs() as c:            # the loop run 8 times
    a = acc
    for i in range(8):
        a = body(a, i)
out["unrolled"] = c.summary
with count_costs() as c:            # the body run once, counted 8 times
    with c.loop(8):
        body(acc, 0)
out["looped"] = c.summary
print(json.dumps({k: {"flops": s.flops, "bytes": s.bytes, "coll": s.collective_bytes}
                  for k, s in out.items()}))
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def handwritten():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", _PROGRAM], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("how", ["unrolled", "looped"])
def test_flops_multiplied_by_trip_count(handwritten, how):
    # dot: (64,64) result × contracted 64 × 2 flops × 8 trips
    assert handwritten[how]["flops"] == 2 * 64 * 64 * 64 * 8


@pytest.mark.parametrize("how", ["unrolled", "looped"])
def test_collective_ring_model_and_trips(handwritten, how):
    # all-reduce of 64·64·4 bytes over groups of 32: 2·s·(n−1)/n, ×8 trips
    coll = handwritten[how]["coll"]
    assert coll["all-reduce"] == pytest.approx(2 * (64 * 64 * 4) * (31 / 32) * 8, rel=1e-12)
    assert sum(coll.values()) == coll["all-reduce"]


@pytest.mark.parametrize("how", ["unrolled", "looped"])
def test_fusion_reads_only_the_slice(handwritten, how):
    # per trip: the slice read and written (2 × 128·64·4, not the 8× stack),
    # the product (result + two operands), the all-reduce's result
    slice_bytes = 128 * 64 * 4
    mat = 64 * 64 * 4
    assert handwritten[how]["bytes"] == 8 * (2 * slice_bytes + 3 * mat + mat)
    assert handwritten[how]["bytes"] < 8 * slice_bytes * 8


def test_attention_attribution_subset_of_total():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 64, 4, 16, generator=g) for _ in range(3))
    with count_costs() as c:
        attend(q, k, v, causal=True, block=16)
        big = torch.zeros(1024, 1024)  # 4 MiB outside attention
        big.sum()
    total, attn = c.summary.bytes, attention_scan_bytes(c.summary)
    assert 0 < attn <= total
    assert total - attn >= 1024 * 1024 * 4


def test_microbatch_loop_multiplies():
    """A reduced config's loss and gradient over M = 2 microbatches run in
    full counts what one microbatch counted under ``loop(2)`` does."""
    cfg = ARCHS["qwen3-4b"].reduced()
    params = init_params(cfg, 0, device="cpu")
    leaves = [p for _, p in tree_items(params)]
    for p in leaves:
        p.requires_grad_(True)
    loss_fn = build_loss_fn(cfg, remat=True, attn_block=8)
    batch = random_batch(cfg, 4, 16, torch.Generator().manual_seed(1))
    halves = [{k: v[i * 2 : (i + 1) * 2] for k, v in batch.items()} for i in range(2)]

    def micro(mb, acc):
        grads = torch.autograd.grad(loss_fn(params, mb), leaves)
        with torch.no_grad():
            for a, g in zip(acc, grads):
                a.add_(g / 2)

    acc = [torch.zeros_like(p) for p in leaves]
    with count_costs() as full:
        for mb in halves:
            micro(mb, acc)
    with count_costs() as looped:
        with looped.loop(2):
            micro(halves[0], acc)
    assert full.summary.flops > 0
    assert looped.summary.flops == full.summary.flops
    assert looped.summary.bytes == full.summary.bytes
    assert looped.summary.collective_bytes == full.summary.collective_bytes


def test_views_and_meta_ops_are_free():
    x = torch.randn(32, 32)
    with count_costs() as c:
        x.t().t().view(-1)[:10].unsqueeze(0)
        torch.empty(64, 64, device="meta") @ torch.empty(64, 64, device="meta")
    assert c.summary.flops == 0 and c.summary.bytes == 0


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_hlo_flop_scale_matches_reference(name):
    got, want = hlo_flop_scale(ARCHS[name]), r_hlo_flop_scale(R_ARCHS[name])
    assert got > 0
    assert abs(got - want) <= SCALE_TOL * want, (got, want)
