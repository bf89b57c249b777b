"""The fp8 MLP (``ops/fp_quantizer.fp8_matmul_ste`` and the model's
``fp8_mlp``), ZeRO++'s quantization telemetry
(``observability/quant_stats.py``) and the quantized-comm attribution tier
against the JAX package on the CPU (``tests/test_fp8_mlp.py``'s
tolerances; the measures on the same tensors)."""

import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.zoo import get_model as jax_get_model
from deepspeed_tpu.observability import attribution as j_attr
from deepspeed_tpu.observability import quant_stats as jqs
from deepspeed_tpu.ops import fp_quantizer as jfp

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import zoo
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.observability import attribution as p_attr
from deepspeed_tpu_torch.observability import quant_stats as pqs
from deepspeed_tpu_torch.observability.hub import get_hub, reset_hub
from deepspeed_tpu_torch.ops import fp_quantizer as pfp


def _xw(seed=0, lead=(2, 8), k=32, n=48):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((*lead, k)).astype(np.float32),
            (rng.standard_normal((k, n)) * 0.1).astype(np.float32))


def test_fp8_matmul_forward_equals_jax():
    x, w = _xw()
    want = jfp.fp8_matmul(jnp.asarray(x.reshape(-1, 32)), jnp.asarray(w),
                          out_dtype=jnp.float32)
    got = pfp.fp8_matmul(torch.tensor(x.reshape(-1, 32)), torch.tensor(w),
                         out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    exact = x.reshape(-1, 32) @ w
    rel = np.abs(got.numpy() - exact).max() / np.abs(exact).max()
    assert rel < 0.1  # JAX's bound on the fp8 forward


def test_fp8_matmul_ste_straight_through_grads_equal_jax():
    x, w = _xw(seed=1)
    g = np.random.default_rng(2).standard_normal((2, 8, 48)).astype(
        np.float32)

    def jloss(x, w):
        return jnp.sum(jfp.fp8_matmul_ste(x, w) * g)

    jdx, jdw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                               jnp.asarray(w))
    px = torch.tensor(x, requires_grad=True)
    pw = torch.tensor(w, requires_grad=True)
    out = pfp.fp8_matmul_ste(px, pw)
    (out * torch.tensor(g)).sum().backward()
    np.testing.assert_allclose(px.grad.numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(pw.grad.numpy(), np.asarray(jdw), rtol=1e-5,
                               atol=1e-5)
    # straight through: the exact product's gradients
    np.testing.assert_allclose(px.grad.numpy(), g @ w.T, rtol=1e-5,
                               atol=1e-5)


def test_fp_quantizer_object_api():
    q = pfp.FPQuantizer(group_size=16)
    x = torch.randn(4, 32)
    codes, scale = q.quantize(x)
    rows = torch.tensor([1, 3])
    sel = q.selective_dequantize(codes, scale, rows, dtype=torch.float32)
    full = q.dequantize(codes, scale, dtype=torch.float32)
    assert torch.equal(sel, full[rows])


def _fp8_models(fp8):
    kw = dict(num_layers=2, hidden_size=64, ffn_size=128, num_heads=4,
              num_kv_heads=2, vocab_size=128, max_seq_len=32, remat=False)
    jmodel = jax_get_model("llama3-8b", dtype=jnp.float32, fp8_mlp=fp8,
                           **kw)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    cfg = zoo.get_config("llama3-8b", dtype=torch.float32, fp8_mlp=fp8,
                         **kw)
    return jmodel, params, params_from_jax(params, cfg, device="cpu")


def test_fp8_mlp_model_loss_follows_jax():
    """The fp8 model's loss equals JAX's fp8 model's on the same weights,
    within JAX's 5% of the exact model and not equal to it."""
    batch = {"input_ids": np.random.default_rng(0).integers(
        0, 128, (2, 17)).astype(np.int32)}
    jmodel, params, port = _fp8_models(True)
    jloss = float(jmodel.loss(params, {k: jnp.asarray(v)
                                       for k, v in batch.items()})[0])
    ploss = float(port.loss(port.params(), {
        k: torch.tensor(v) for k, v in batch.items()})[0])
    np.testing.assert_allclose(ploss, jloss, rtol=1e-5)
    _, _, exact = _fp8_models(False)
    eloss = float(exact.loss(exact.params(), {
        k: torch.tensor(v) for k, v in batch.items()})[0])
    assert ploss != eloss and abs(ploss - eloss) / eloss < 0.05


def test_engine_performance_fp8_flag_reaches_model():
    model = zoo.get_model("tiny", device="cpu", dtype=torch.float32)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, config={"train_micro_batch_size_per_chip": 1,
                             "performance": {"fp8_mlp": True}},
        device="cpu")
    assert engine.model_config.fp8_mlp


# -- quant_stats --------------------------------------------------------------


def _tensors(seed=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((64, 128)).astype(np.float32),
            (rng.standard_normal((32, 256)) * 1e-3).astype(np.float32)]


@pytest.mark.parametrize("bits,block", [(8, 128), (4, 256), (8, 0)])
def test_measures_equal_jax(bits, block):
    ts = _tensors()
    a = jqs.measure_region("qwz_param_fetch", ts, block=block, bits=bits)
    b = pqs.measure_region("qwz_param_fetch", ts, block=block, bits=bits)
    da, db = a.to_dict(), b.to_dict()
    for k in ("region", "logical_bytes", "wire_bytes", "n_elements", "bits",
              "block", "compression"):
        assert db[k] == da[k], k
    if math.isfinite(a.snr_db):
        assert b.snr_db == pytest.approx(a.snr_db, rel=1e-5)
    assert b.max_rel_err == pytest.approx(a.max_rel_err, rel=1e-5)
    for k, v in a.scales.items():
        assert b.scales[k] == pytest.approx(v, rel=1e-6), k
    x = ts[0]
    np.testing.assert_allclose(pqs.qdq_blockwise(x, 128, bits)[0].numpy(),
                               np.asarray(jqs.qdq_blockwise(x, 128, bits)[0]),
                               rtol=1e-6, atol=1e-7)
    assert pqs.wire_bytes(1000, bits, 128) == jqs.wire_bytes(1000, bits, 128)
    assert pqs.snr_db(x, x) == math.inf


def test_grad_reduce_qar_fp8_hpz_measures_equal_jax():
    rng = np.random.default_rng(5)
    groups = [{"w": rng.standard_normal((16, 256)).astype(np.float32),
               "b": rng.standard_normal((256,)).astype(np.float32)}
              for _ in range(4)]
    pairs = [(jqs.measure_grad_reduce(groups), pqs.measure_grad_reduce(
              [{k: torch.tensor(v) for k, v in g.items()} for g in groups])),
             (jqs.measure_qar(groups), pqs.measure_qar(
              [{k: torch.tensor(v) for k, v in g.items()} for g in groups])),
             (jqs.measure_fp8_mlp({"w": groups[0]["w"]}),
              pqs.measure_fp8_mlp({"w": torch.tensor(groups[0]["w"])})),
             (jqs.hpz_partition_stats(1000, 8),
              pqs.hpz_partition_stats(1000, 8))]
    for a, b in pairs:
        da, db = a.to_dict(), b.to_dict()
        for k in ("region", "logical_bytes", "wire_bytes", "n_elements",
                  "note", "bit_exact"):
            assert db[k] == da[k], (a.region, k)
        if a.snr_db is not None:
            assert b.snr_db == pytest.approx(a.snr_db, rel=1e-5)
        assert b.max_rel_err == pytest.approx(a.max_rel_err, rel=1e-5,
                                              abs=1e-9)
    ok_a, va = jqs.evaluate_gates([p[0] for p in pairs])
    ok_b, vb = pqs.evaluate_gates([p[1] for p in pairs])
    assert ok_a == ok_b and len(va) == len(vb)


def test_injection_trips_the_gates():
    ts = _tensors()
    pqs.set_injection("corrupt_scale")
    try:
        st = pqs.measure_region("qwz_param_fetch", ts, block=128, bits=8)
    finally:
        pqs.set_injection(None)
    ok, violations = pqs.evaluate_gates([st])
    assert not ok and {v["gate"] for v in violations} >= {"max_rel_err"}


def test_engine_collects_or_warns(monkeypatch):
    """qwZ on: with collection configured the engine publishes quant.*
    gauges at init; without, JAX's warning (once)."""
    reset_hub()
    model = zoo.get_model("tiny", device="cpu", dtype=torch.float32)
    base = {"train_micro_batch_size_per_chip": 1,
            "zero_optimization": {"stage": 1, "zero_quantized_weights": True}}
    deepspeed_tpu_torch.initialize(
        model=model, device="cpu",
        config=dict(base, observability={"quant_stats": True}))
    snap = pqs.last_snapshot()
    assert snap["regions"][0]["region"] == "qwz_param_fetch"
    assert "dstpu_quant_qwz_param_fetch_snr_db" in get_hub().to_prometheus()
    assert pqs.collection_configured(SimpleNamespace(quant_stats=True))
    assert not pqs.collection_configured(SimpleNamespace(quant_stats=False))
    assert not pqs.collection_configured(None)
    reset_hub()


def test_attribute_quant_step_follows_jax():
    jcfg = jax_get_model("tiny", vocab_size=128, hidden_size=64,
                         num_layers=2, num_heads=4).config
    pcfg = zoo.get_config("tiny", vocab_size=128, hidden_size=64,
                          num_layers=2, num_heads=4)
    assert pcfg.num_params() == jcfg.num_params()
    for kw in ({"qwz": True, "qgz": True, "hpz": 8},
               {"qar": True, "n_chips": 8}, {"hpz": 1}):
        jr = j_attr.attribute_quant_step(jcfg, ici_gbps=45.0, dcn_gbps=6.25,
                                         **kw)
        pr = p_attr.attribute_quant_step(pcfg, ici_gbps=45.0, dcn_gbps=6.25,
                                         **kw)
        assert [r.to_dict() for r in pr] == [r.to_dict() for r in jr]
    with pytest.raises(ValueError, match="mutually exclusive"):
        p_attr.attribute_quant_step(pcfg, qar=True, qgz=True)
