"""The port's per-region attribution against the analytic matmul count
and against the JAX package's XLA counts.

The port counts JAX's grad-of-sum closures on the meta device under a
counting dispatch mode, the flash kernels by formula. Its compute regions
equal the analytic count exactly; against JAX's ``attribute_step`` (XLA's
cost analysis on the CPU) at a Llama-shaped config — hidden 512, ffn
1792, 8 / 2 heads, vocab 4096, 2 layers, B 2 x S 256 — the FLOPs part by
design: attn 0.959 (the flash kernels skip the causal tiles past the
diagonal; XLA's CPU path computes every tile), mlp 1.108 (XLA's count of
the three GEMMs' gradients is 0.903 of the analytic one), vocab_head
0.994, the analytic optimizer row 1.000. The tolerances below bracket
those ratios (ROADMAP C). A full-width Llama-3-8B pass runs on the meta
device: nothing on the card, under a MiB on the host.
"""

import dataclasses
import resource
import types

import pytest
import torch

from deepspeed_tpu.models.zoo import get_model as jax_model
from deepspeed_tpu.observability import attribution as j_attr
from deepspeed_tpu_torch.models import zoo
from deepspeed_tpu_torch.observability import attribution as p_attr
from deepspeed_tpu_torch.ops.flash_attention import TILE

SMALL = dict(hidden_size=512, ffn_size=1792, num_heads=8, num_kv_heads=2,
             vocab_size=4096, num_layers=2, max_seq_len=256)
B, S = 2, 256
# port FLOPs / JAX FLOPs by region, the bracket around the measured ratio
RATIO = {"attn": (0.93, 0.99), "mlp": (1.08, 1.14),
         "vocab_head": (0.98, 1.01), "optimizer": (1.0, 1.0)}


@pytest.fixture(scope="module")
def small_cfg():
    return zoo.get_config("llama3-8b", dtype=torch.bfloat16, **SMALL)


@pytest.fixture(scope="module")
def port_regions(small_cfg):
    return {r.region: r for r in p_attr.attribute_step(small_cfg, B, S)}


def _causal_pairs(seq):
    """(query, key) pairs of the 64 x 64 tiles up to the diagonal."""
    n = -(-seq // TILE)
    rows = [min(TILE, seq - i * TILE) for i in range(n)]
    return sum(rows[i] * sum(rows[:i + 1]) for i in range(n))


def test_counted_regions_equal_the_analytic_matmul_count(small_cfg,
                                                         port_regions):
    c = small_cfg
    T, H, F, V, L = B * S, c.hidden_size, c.ffn, c.vocab_size, c.num_layers
    nh, nkv, hd = c.num_heads, c.kv_heads, c.head_dim
    # three swiglu GEMMs, each 2·T·H·F forward and twice that backward
    assert port_regions["mlp"].flops == 6 * T * 3 * H * F * L
    assert port_regions["vocab_head"].flops == 6 * T * H * V
    proj = 6 * T * H * (2 * nh + 2 * nkv) * hd
    # flash: 4·D a pair forward, 8·D dK/dV, 6·D dQ, causal tiles only
    core = (4 + 8 + 6) * hd * B * nh * _causal_pairs(S)
    assert port_regions["attn"].flops == (proj + core) * L
    assert port_regions["optimizer"].flops == 4 * c.num_params()
    assert port_regions["param_fetch"].flops == 0.0
    assert "flash kernels" in port_regions["attn"].note


def test_regions_held_against_jax(port_regions):
    jm = jax_model("llama3-8b", **SMALL)
    want = {r.region: r for r in j_attr.attribute_step(jm.config, B, S)}
    assert set(want) == set(port_regions) == set(p_attr.REGIONS)
    for region, (lo, hi) in RATIO.items():
        ratio = port_regions[region].flops / want[region].flops
        assert lo <= ratio <= hi, (region, ratio)
    # the analytic transfer rows are JAX's
    for region in ("optimizer", "param_fetch"):
        assert port_regions[region].bytes_accessed == \
            want[region].bytes_accessed


def test_full_width_pass_runs_on_meta_and_allocates_nothing():
    cfg = zoo.get_config("llama3-8b", dtype=torch.bfloat16, num_layers=2)
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    seen = []
    orig = p_attr.WorkCounter.__exit__

    def spy(self, *exc):
        seen.append((set(self.devices) - {"cpu"}, self.host_bytes))
        return orig(self, *exc)

    p_attr.WorkCounter.__exit__ = spy
    try:
        regions = p_attr.attribute_step(cfg, 2, 2048)
        step = p_attr.count_step(cfg, 2, 2048, gas=2)
    finally:
        p_attr.WorkCounter.__exit__ = orig
    grown_mb = (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
                - before) / 1024
    assert seen and all(d <= {"meta"} and n < (1 << 20) for d, n in seen)
    # one real bf16 layer's weights alone are 436 MB
    assert grown_mb < 100
    by = {r.region: r for r in regions}
    T = 2 * 2048
    assert by["vocab_head"].flops == 6 * T * cfg.hidden_size * \
        cfg.vocab_size
    # the whole step: remat recomputes each layer's forward, GAS 2
    assert step["kernel_calls"] == {"flash_fwd": 4, "flash_bwd_dkdv": 2,
                                    "flash_bwd_dq": 2}
    compute = sum(by[r].flops for r in ("attn", "mlp", "vocab_head"))
    assert step["flops"] > 2 * compute


def test_markdown_and_split_equal_jax():
    rows = [("attn", 5e12, 2e10, False), ("mlp", 9e12, 3e10, False),
            ("vocab_head", 1e12, 5e10, False),
            ("optimizer", 4e9, 4e10, False),
            ("param_fetch", 0.0, 2e9, True)]
    jr = [j_attr.RegionCost(r, f, b, note="n", overlapped=o)
          for r, f, b, o in rows]
    pr = [p_attr.RegionCost(r, f, b, note="n", overlapped=o)
          for r, f, b, o in rows]
    kw = dict(peak_tflops=989.0, hbm_gbps=3350.0, fetch_gbps=64.0)
    for depth in (None, 0, 2):
        assert p_attr.attribution_markdown(pr, overlap_depth=depth,
                                           num_layers=2, **kw) == \
            j_attr.attribution_markdown(jr, overlap_depth=depth,
                                        num_layers=2, **kw)
    assert p_attr.split_exposed_hidden(pr, overlap_depth=1, num_layers=2,
                                       **kw) == \
        j_attr.split_exposed_hidden(jr, overlap_depth=1, num_layers=2,
                                    **kw)
    assert p_attr.overlap_split_ms(10.0, 1.0, 2, 8) == \
        j_attr.overlap_split_ms(10.0, 1.0, 2, 8)
    assert [r.to_dict() for r in pr] == [r.to_dict() for r in jr]


def test_unported_tiers_raise_naming_their_items():
    with pytest.raises(NotImplementedError, match="item 11"):
        p_attr.attribute_longctx_step(seq_len=4096, hidden_size=64,
                                      num_heads=4)
    with pytest.raises(NotImplementedError, match="item 10"):
        p_attr.attribute_quant_step(None)
    with pytest.raises(RuntimeError, match="counting pass"):
        p_attr.report_kernel("flash_fwd", 1.0, 1.0)


def test_device_ms_by_region_takes_the_innermost_range():
    from torch.autograd import DeviceType

    def ev(name, parent=None, kernels_us=()):
        return types.SimpleNamespace(
            name=name, cpu_parent=parent, device_type=DeviceType.CPU,
            kernels=[types.SimpleNamespace(duration=us, name=f"{name}_k")
                     for us in kernels_us])

    attn = ev("attention")
    norm = ev("norm", attn)
    events = [attn, norm, ev("aten::mm", attn, (1000, 500)),
              ev("aten::mul", norm, (250,)), ev("aten::add", None, (100,)),
              ev("mlp", None, (2000,)),
              types.SimpleNamespace(name="k", cpu_parent=None,
                                    device_type=DeviceType.CUDA,
                                    kernels=[])]
    prof = types.SimpleNamespace(events=lambda: events)
    got = p_attr.device_ms_by_region(prof)
    assert got["ms"]["attention"] == 1.5 and got["kernels"]["attention"] == 2
    assert got["ms"]["norm"] == 0.25 and got["ms"]["mlp"] == 2.0
    assert got["ms"]["other"] == 0.1 and got["ms"]["rope"] == 0.0
    fam = p_attr.device_ms_by_region(
        prof, family=lambda n: "gemm" if "mm" in n else "elementwise")
    assert fam["by_family"]["attention"] == {"gemm": 1.5}
    assert fam["by_family"]["norm"] == {"elementwise": 0.25}


def test_counted_config_resolves_the_cards_route(small_cfg):
    cfg = dataclasses.replace(small_cfg, attn_impl="auto")
    assert p_attr.counted_config(cfg, "cuda").attn_impl == "flash"
    assert p_attr.counted_config(cfg, "cpu").attn_impl == "xla"
    assert not p_attr.counted_config(cfg).remat
