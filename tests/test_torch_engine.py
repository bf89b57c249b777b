"""Port training engine against the JAX engine.

Both engines start from the same fp32 masters: the JAX engine's
``opt_state.master`` crosses over through ``params_from_jax``. The JAX
engine runs on the 8-device CPU mesh (ZeRO stage 0, dp 8); the port's
world size is 1, so it gets the JAX engine's global batch
(``train_batch_size``) and the same GAS. fp32, AdamW lr 1e-3, clip 1.0,
GAS 2, ``attn_impl="flash"`` (the port's plain flash path, the JAX
kernel in interpret mode). Losses agree at rtol 1e-4 over 4 steps and
the final masters at atol 1e-4 (fp32 sums in different orders, carried
through 4 Adam steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as dstpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.transformer import TransformerConfig as JaxConfig
from deepspeed_tpu.models.transformer import TransformerLM as JaxLM
from deepspeed_tpu_torch.models import zoo
from deepspeed_tpu_torch.models.convert import (params_from_jax,
                                                params_to_numpy)
from deepspeed_tpu_torch.models.transformer import TransformerConfig

TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            max_seq_len=32, pos_emb="learned", norm="layernorm",
            activation="gelu", tie_embeddings=True, remat=False)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def data_iter(batch, seq=17, seed=0, n_fixed=2):
    """Cycle a small fixed set of batches so the loss can fall (the
    JAX ``tests/test_engine.py`` data)."""
    rng = np.random.default_rng(seed)
    fixed = [{"input_ids": rng.integers(0, 64, (batch, seq)).astype(np.int32)}
             for _ in range(n_fixed)]
    i = 0
    while True:
        yield fixed[i % n_fixed]
        i += 1


def _port_engine(extra=None, stage=0, model=None, **over):
    cfg = {"train_micro_batch_size_per_chip": 2,
           "gradient_accumulation_steps": 1,
           "optimizer": {"type": "adamw", "params": {"lr": 1e-2}},
           "zero_optimization": {"stage": stage}, "steps_per_print": 100}
    cfg.update(extra or {})
    if model is None:
        model = zoo.get_model("tiny", device="cpu", seed=0,
                              dtype=torch.float32, **dict(TINY, **over))
    engine, opt, loader, sched = deepspeed_tpu_torch.initialize(
        model=model, config=cfg, device="cpu")
    assert loader is None and opt.param_groups[0]["lr"] == engine.get_lr()[0]
    return engine


def test_four_steps_match_the_jax_engine(devices):
    cfg = {"train_micro_batch_size_per_chip": 2,
           "gradient_accumulation_steps": 2,
           "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
           "gradient_clipping": 1.0, "bf16": {"enabled": False},
           "zero_optimization": {"stage": 0}, "steps_per_print": 100}
    jmodel = JaxLM(JaxConfig(dtype=jnp.float32, attn_impl="flash", **TINY))
    jeng, *_ = dstpu.initialize(model=jmodel, config=dict(cfg))
    masters = jax.tree.map(np.asarray, jeng.opt_state.master)
    model = params_from_jax(masters, TransformerConfig(
        dtype=torch.float32, attn_impl="flash", **TINY), device="cpu")
    pcfg = dict(cfg, train_batch_size=jeng.train_batch_size)
    del pcfg["train_micro_batch_size_per_chip"]
    eng, *_ = deepspeed_tpu_torch.initialize(model=model, config=pcfg,
                                             device="cpu")
    assert eng.gradient_accumulation_steps == 2
    assert eng.micro_batch_size == jeng.micro_batch_size * jeng.dp_world_size

    jit = data_iter(jeng.micro_batch_size * jeng.dp_world_size, seed=5)
    pit = data_iter(eng.micro_batch_size, seed=5)
    want = [float(jeng.train_batch(jit)) for _ in range(4)]
    got = [float(eng.train_batch(pit)) for _ in range(4)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert eng.global_steps == 4 and eng.global_samples == 4 * 32
    jm = jax.tree.map(np.asarray, jeng.opt_state.master)
    pm = params_to_numpy(eng.opt_state.master)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jm)[0]:
        node = pm
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node, leaf, atol=1e-4, rtol=0,
                                   err_msg=str(path))
    # the fp32 model shares its tensors with the masters
    assert np.array_equal(params_to_numpy(model.params())["layers"]["mlp"]
                          ["wi"], pm["layers"]["mlp"]["wi"])


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_bf16_loss_decreases(stage):
    engine = _port_engine(stage=stage, attn_impl="flash")
    assert engine.compute_dtype == torch.bfloat16
    it = data_iter(engine.micro_batch_size)
    losses = [float(engine.train_batch(it)) for _ in range(8)]
    assert losses[-1] < losses[0] - 0.3, (stage, losses)
    assert engine.global_steps == 8
    assert np.isfinite(float(engine.get_global_grad_norm()))


def test_zero_stages_give_the_same_losses():
    seqs = {}
    for stage in (0, 1, 2, 3):
        engine = _port_engine(stage=stage, extra={"gradient_accumulation_"
                                                  "steps": 2})
        it = data_iter(engine.micro_batch_size, seed=7)
        seqs[stage] = [float(engine.train_batch(it)) for _ in range(3)]
    for stage in (1, 2, 3):
        np.testing.assert_array_equal(seqs[stage], seqs[0])


def test_schedule_eval_and_fp16_scaling():
    engine = _port_engine(extra={"scheduler": {
        "type": "WarmupLR", "params": {"warmup_num_steps": 10,
                                       "warmup_min_lr": 0.0}}})
    it = data_iter(engine.micro_batch_size)
    engine.train_batch(it)
    lr1 = engine.get_lr()[0]
    for _ in range(3):
        engine.train_batch(it)
    assert engine.get_lr()[0] > lr1 > 0
    assert np.isfinite(float(engine.eval_batch(next(it))))

    engine = _port_engine(extra={"fp16": {"enabled": True,
                                          "initial_scale_power": 8}})
    assert engine.loss_scale == 2.0 ** 8
    assert engine.compute_dtype == torch.float16
    assert np.isfinite(float(engine.train_batch(data_iter(2))))


def test_data_exhausted_mid_accumulation_raises():
    engine = _port_engine(extra={"gradient_accumulation_steps": 2})
    batch = next(data_iter(engine.micro_batch_size))
    with pytest.raises(RuntimeError, match="mid-gradient-accumulation"):
        engine.train_batch(iter([batch]))
    with pytest.raises(StopIteration):
        engine.train_batch(iter([]))


@pytest.mark.parametrize("extra,match", [
    ({"pipeline": {"stages": 2}}, "item 11"),
    ({"sequence_parallel": {"size": 2}}, "item 11"),
    ({"elasticity": {"enabled": True}}, "item 16"),
    ({"tensor_parallel": {"tp_size": 2}}, "item 11"),
    ({"compile": {"enabled": True}}, "item 16"),
    ({"zero_optimization": {"stage": 3,
                            "offload_optimizer": {"device": "cpu"},
                            "offload_param": {"device": "cpu"}},
      "tensor_parallel": {"tp_size": 2}}, "item 11"),
    ({"data_efficiency": {"enabled": True}}, "item 16"),
    ({"observability": {"run_dir": "fleet_run"}}, "item 14"),
    ({"observability": {"journal": {"enabled": True}}}, "item 13"),
])
def test_unported_config_raises(extra, match):
    if "tensor_parallel" in extra:
        # the tensor_parallel block is ported: JAX's TensorParallelConfig
        # knows autotp_size, so its tp_size warns and is ignored there and
        # here, and the engine's mesh keeps tp = 1 as JAX's does
        from deepspeed_tpu.config.config import load_config as jax_config

        assert jax_config(dict(extra)).tensor_parallel.size == 1
        with pytest.warns(UserWarning, match="tp_size"):
            engine = _port_engine(extra=extra)
        assert engine.config.tensor_parallel.size == 1
        assert engine.mesh.shape["tp"] == 1
        return
    if "pipeline" in extra or "sequence_parallel" in extra:
        # ported (tests/test_torch_pipeline.py, tests/test_torch_sp.py):
        # two stages or two sp ranks do not fit one rank's mesh, and the
        # port refuses it in JAX's words
        from deepspeed_tpu.config.config import load_config as jax_config
        from deepspeed_tpu.parallel import topology as jtopo

        cfg = jax_config(dict(extra))
        with pytest.raises(ValueError) as want:
            jtopo.TopologyConfig(
                pp=cfg.pipeline.stages, sp=cfg.sequence_parallel.size,
                fsdp=-1, dp=1).sizes(1)
        with pytest.raises(ValueError) as got:
            _port_engine(extra=extra)
        assert str(got.value) == str(want.value)
        return
    with pytest.raises(NotImplementedError, match=match):
        _port_engine(extra=extra)


@pytest.mark.parametrize("extra,flag", [
    ({"moe": {"enabled": True, "ep_size": 1, "impl": "einsum"}}, None),
    ({"performance": {"pipeline_depth": 2, "fp8_mlp": True}}, None),
    ({"zero_optimization": {"stage": 3, "zero_quantized_weights": True}},
     "_qwz_stage3"),
    ({"optimizer": {"type": "onebitadam", "params": {}}}, "_onebit"),
], ids=["moe_einsum", "fp8_mlp", "qwz_stage3", "onebitadam"])
def test_a9_a10_configs_build(extra, flag):
    """What raised naming items 9 and 10 builds now (ZeRO++, the 1-bit
    optimizers, the fp8 MLP, the einsum dispatch); qwZ at stage 3 on one
    process has no fsdp ranks to gather over, so it arms and moves
    nothing, as in JAX."""
    engine = _port_engine(extra=extra)
    if flag is not None:
        assert getattr(engine, flag)


def test_accepted_no_op_settings():
    engine = _port_engine(extra={"zero_optimization": {
        "stage": 2, "overlap_comm": True, "reduce_bucket_size": 10,
        "offload_optimizer": {"device": "none"}}, "wall_clock_breakdown":
        False})
    assert engine.config.zero_optimization.stage == 2
    with pytest.raises(ValueError, match="stage must be 0-3"):
        _port_engine(stage=4)


def test_initialize_defaults_to_cuda_and_raises_without_it(monkeypatch):
    model = zoo.get_model("tiny", device="cpu", dtype=torch.float32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deepspeed_tpu_torch.initialize(model=model, config={})
    # training_data builds the dataloader and client optimizers are
    # ported (tests/test_torch_engine_steps.py,
    # tests/test_torch_engine_client.py); what is not an optimizer raises
    with pytest.raises(TypeError, match="client optimizer"):
        deepspeed_tpu_torch.initialize(model=model, config={},
                                       optimizer=object(), device="cpu")
