"""The port's assigned-architecture configs (``repro_torch.configs``):
twins of ``tests/test_configs.py`` (the assignment sheet's dims), and
every field of every ``ARCHS`` entry and of ``SOLVER`` equal to the JAX
package's (the configs are copies at their published widths)."""
import dataclasses

import pytest

import repro.configs as rconfigs
from repro_torch import configs
from repro_torch.configs import ARCHS, SOLVER

# (layers, d_model, heads, kv, d_ff, vocab, family)
ASSIGNMENT = {
    "qwen3-4b": (36, 2560, 32, 8, 9728, 151_936, "dense"),
    "starcoder2-7b": (32, 4608, 36, 4, 18_432, 49_152, "dense"),
    "qwen2.5-3b": (36, 2048, 16, 2, 11_008, 151_936, "dense"),
    "qwen2.5-32b": (64, 5120, 40, 8, 27_648, 152_064, "dense"),
    "qwen2-moe-a2.7b": (24, 2048, 16, 16, 1408, 151_936, "moe"),
    "granite-moe-3b-a800m": (32, 1536, 24, 8, 512, 49_155, "moe"),
    "rwkv6-1.6b": (24, 2048, 32, 32, 7168, 65_536, "ssm"),
    "pixtral-12b": (40, 5120, 32, 8, 14_336, 131_072, "vlm"),
    "seamless-m4t-large-v2": (24, 1024, 16, 16, 8192, 256_206, "audio"),
    "zamba2-2.7b": (54, 2560, 32, 32, 10_240, 32_000, "hybrid"),
}


@pytest.mark.parametrize("name", sorted(ASSIGNMENT))
def test_config_matches_assignment(name):
    cfg = ARCHS[name]
    l, d, h, kv, ff, v, fam = ASSIGNMENT[name]
    assert cfg.n_layers == l
    assert cfg.d_model == d
    assert cfg.n_heads == h
    assert cfg.n_kv_heads == kv
    assert cfg.d_ff == ff
    assert cfg.vocab_size == v
    assert cfg.family == fam


@pytest.mark.parametrize("name", sorted(ASSIGNMENT))
def test_config_equals_reference_field_by_field(name):
    """Every field (the MoE and SSM blocks' too) and every derived count
    the workload zoo reads equal the reference's."""
    cfg, ref = ARCHS[name], rconfigs.ARCHS[name]
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    for attr in ("resolved_head_dim", "padded_n_experts", "padded_n_heads", "n_params",
                 "n_active_params"):
        assert getattr(cfg, attr) == getattr(ref, attr), attr
    assert cfg.padded_vocab() == ref.padded_vocab()
    assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(ref.reduced())


def test_registry_equals_reference():
    assert list(ARCHS) == list(rconfigs.ARCHS)
    assert dataclasses.asdict(SOLVER) == dataclasses.asdict(rconfigs.SOLVER)
    assert configs.get("qwen3-4b") is ARCHS["qwen3-4b"]
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get("no-such-model")


def test_moe_details():
    q = ARCHS["qwen2-moe-a2.7b"].moe
    assert (q.n_experts, q.top_k, q.n_shared) == (60, 4, 4)
    g = ARCHS["granite-moe-3b-a800m"].moe
    assert (g.n_experts, g.top_k) == (40, 8)


def test_ssm_details():
    assert ARCHS["rwkv6-1.6b"].ssm.kind == "rwkv6"
    z = ARCHS["zamba2-2.7b"]
    assert z.ssm.kind == "mamba2" and z.ssm.d_state == 64
    assert z.hybrid_attn_every == 6


def test_encdec_and_frontends():
    s = ARCHS["seamless-m4t-large-v2"]
    assert s.encdec and s.n_encoder_layers == 24 and s.frontend == "frames"
    assert ARCHS["pixtral-12b"].frontend == "patch"


def test_solver_config():
    assert SOLVER.name == "multifrontal-cholesky"
    assert 0 < SOLVER.alpha <= 1.0
    assert (SOLVER.grid, SOLVER.relax, SOLVER.dtype) == (63, 2, "float32")


def test_shape_cells_equal_reference():
    """The shape cells, their lookup and the long_500k rule are the
    reference's."""
    import repro.models.config as rcfg
    from repro_torch.models import SHAPES, cell_is_runnable, shape_by_name

    assert [dataclasses.astuple(s) for s in SHAPES] == [
        dataclasses.astuple(s) for s in rcfg.SHAPES]
    for s in SHAPES:
        assert shape_by_name(s.name) == s
        for name, cfg in ARCHS.items():
            assert cell_is_runnable(cfg, s) == rcfg.cell_is_runnable(
                rconfigs.ARCHS[name], rcfg.shape_by_name(s.name))
    with pytest.raises(KeyError):
        shape_by_name("no-such-cell")
