"""Port MoE transformer (``models/moe_transformer.py``), its training
engine and its serving path against the JAX package on tiny-moe.

Weights come from the JAX ``model.init(PRNGKey(seed))`` and cross over
through ``params_from_jax``; tokens come from numpy seeds. fp32 on the
CPU: the port's grouped matmuls and attention kernels run their plain
versions, the JAX ones run in Pallas interpret mode. Tolerances: loss
rtol 1e-5 and every gradient leaf atol 1e-4 (fp32 sums in other
orders), engine losses rtol 1e-4 over 4 steps, greedy serving streams
token-identical. The Mixtral-8x7B and Qwen2-MoE presets are checked by
their configs only (no full-size build on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as dstpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.models.zoo import get_model as jax_get_model
from deepspeed_tpu_torch.inference import InferenceEngineV2
from deepspeed_tpu_torch.models import moe_transformer as mt
from deepspeed_tpu_torch.models import zoo
from deepspeed_tpu_torch.models.convert import (params_from_jax,
                                                params_to_numpy)

SMALL = dict(vocab_size=64, hidden_size=32, max_seq_len=32)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _pair(seed=0, **over):
    """(JAX model, its params, the port model on the same weights)."""
    jmodel = jax_get_model("tiny-moe", dtype=jnp.float32,
                           param_dtype=jnp.float32, **over)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    model = params_from_jax(jax.tree.map(np.asarray, jparams),
                            zoo.get_config("tiny-moe", dtype=torch.float32,
                                           **over), device="cpu")
    return jmodel, jparams, model


def _flat(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", tree[k]


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_every_gradient_match_jax(remat):
    jmodel, jparams, model = _pair(remat=remat)
    toks = np.random.default_rng(7).integers(0, 256, (2, 33)).astype(
        np.int32)
    (want, want_aux), want_grads = jax.value_and_grad(
        lambda p: jmodel.loss(p, {"input_ids": jnp.asarray(toks)}),
        has_aux=True)(jparams)
    params = {k: v for k, v in _flat(model.params())}
    for p in params.values():
        p.requires_grad_()
    loss, aux = model.loss(model.params(), {"input_ids":
                                            torch.from_numpy(toks)})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    for key in ("lm_loss", "aux_loss", "ntokens"):
        np.testing.assert_allclose(aux[key].item(), float(want_aux[key]),
                                   rtol=1e-5, err_msg=key)
    assert aux["aux_loss"].item() > 0
    want_flat = dict(_flat(jax.tree.map(np.asarray, want_grads)))
    assert sorted(want_flat) == sorted(params)
    assert "/layers/moe/router" in params
    for path, ref in want_flat.items():
        np.testing.assert_allclose(params[path].grad.numpy(), ref, atol=1e-4,
                                   rtol=0, err_msg=path)


def test_apply_logits_and_model_protocol():
    jmodel, jparams, model = _pair(seed=1)
    toks = np.random.default_rng(3).integers(0, 256, (2, 40)).astype(
        np.int32)
    want = np.asarray(jmodel.apply(jparams, jnp.asarray(toks)))
    with torch.no_grad():
        got = model.apply(model.params(), torch.from_numpy(toks))
    assert isinstance(model, mt.MoETransformerLM)
    assert got.dtype == torch.float32 and got.shape == (2, 40, 256)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    assert model.flops_per_token() == jmodel.flops_per_token()
    assert model.num_params() == jmodel.num_params() == sum(
        p.numel() for p in model.parameters())
    assert model.config.active_params() == jmodel.config.active_params()


def test_four_engine_steps_match_the_jax_engine():
    cfg = {"train_micro_batch_size_per_chip": 2,
           "gradient_accumulation_steps": 2,
           "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
           "gradient_clipping": 1.0, "bf16": {"enabled": False},
           "zero_optimization": {"stage": 0}, "steps_per_print": 100,
           "moe": {"enabled": True, "ep_size": 1, "impl": "grouped"}}
    jeng, *_ = dstpu.initialize(model=jax_get_model(
        "tiny-moe", dtype=jnp.float32, **SMALL), config=dict(cfg))
    model = params_from_jax(
        jax.tree.map(np.asarray, jeng.opt_state.master),
        zoo.get_config("tiny-moe", dtype=torch.float32, **SMALL),
        device="cpu")
    pcfg = dict(cfg, train_batch_size=jeng.train_batch_size)
    del pcfg["train_micro_batch_size_per_chip"]
    eng, *_ = deepspeed_tpu_torch.initialize(model=model, config=pcfg,
                                             device="cpu")
    assert eng.model_config.moe_impl == "grouped"
    rng = np.random.default_rng(5)
    fixed = [{"input_ids": rng.integers(0, 64, (eng.micro_batch_size, 17))
              .astype(np.int32)} for _ in range(2)]

    def data():
        i = 0
        while True:
            yield fixed[i % 2]
            i += 1

    jit, pit = data(), data()
    want = [float(jeng.train_batch(jit)) for _ in range(4)]
    got = [float(eng.train_batch(pit)) for _ in range(4)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]
    jm = dict(_flat(jax.tree.map(np.asarray, jeng.opt_state.master)))
    pm = dict(_flat(params_to_numpy(eng.opt_state.master)))
    for path in ("/layers/moe/router", "/layers/moe/experts/wi"):
        np.testing.assert_allclose(pm[path], jm[path], atol=1e-4, rtol=0,
                                   err_msg=path)


def test_greedy_serving_streams_match_jax():
    jmodel, jparams, model = _pair(seed=7)
    kw = dict(kv_blocks=64, kv_block_size=8, max_tokens_per_step=32,
              max_seqs_per_step=4, max_blocks_per_seq=8, decode_steps=4)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (5, 12, 19)]
    outs = []
    for eng in (JaxEngine(jmodel, params=jparams, dtype=jnp.float32, **kw),
                InferenceEngineV2(model, device="cpu", **kw)):
        eng.put([1, 2, 3], prompts, max_new_tokens=8)
        outs.append(eng.generate_all())
    assert outs[1] == outs[0]
    assert all(len(v) == 8 for v in outs[1].values())
    assert eng.stats["burst_steps"] >= 1
    assert eng.stats["prefill_kernel_steps"] >= 1


def test_runner_gather_path_routes_through_moe():
    """The plain gather runner (every token routed, no dropping) gives
    the engine's streams too."""
    _, _, model = _pair(seed=2)
    prompts = [((np.arange(11) * 3 + i) % 200).astype(np.int32)
               for i in range(3)]
    outs = []
    for use_kernels in (True, False):
        eng = InferenceEngineV2(model, kv_blocks=64, kv_block_size=8,
                                max_tokens_per_step=32, max_seqs_per_step=4,
                                max_blocks_per_seq=8,
                                decode_steps=4 if use_kernels else 1,
                                device="cpu")
        eng._use_paged_kernel = use_kernels
        eng.put([0, 1, 2], prompts, max_new_tokens=5)
        outs.append(eng.generate_all())
    assert outs[0] == outs[1]


def test_presets_are_full_width():
    cfg = zoo.get_config("mixtral-8x7b")
    assert isinstance(cfg, mt.MoETransformerConfig)
    assert (cfg.hidden_size, cfg.num_layers, cfg.num_heads, cfg.kv_heads,
            cfg.ffn, cfg.vocab_size, cfg.num_experts, cfg.top_k,
            cfg.max_seq_len, cfg.rope_theta) == (
                4096, 32, 32, 8, 14336, 32000, 8, 2, 32768, 1e6)
    assert cfg.num_params() == 46_702_792_704
    assert cfg.active_params() == 12_879_925_248
    assert cfg.dtype == torch.bfloat16 and cfg.moe_impl == "auto"
    qwen = zoo.get_config("qwen2-moe-a14b")
    assert (qwen.hidden_size, qwen.num_layers, qwen.num_heads, qwen.kv_heads,
            qwen.ffn, qwen.vocab_size, qwen.num_experts, qwen.top_k) == (
                3584, 28, 28, 4, 2560, 151936, 64, 8)
    jcfg = jax_get_model("qwen2-moe-a14b").config
    assert qwen.num_params() == jcfg.num_params()
    assert qwen.flops_per_token() == jcfg.flops_per_token()
    half = zoo.get_config("mixtral-8x7b", num_layers=16)
    assert half.num_params() == 23_482_470_400


def test_moe_config_block_and_unported_switches():
    with pytest.raises(NotImplementedError, match="item 9"):
        zoo.get_config("tiny-moe", moe_impl="einsum")
    with pytest.raises(ValueError, match="unknown moe_impl"):
        zoo.get_config("tiny-moe", moe_impl="bogus")
    with pytest.raises(NotImplementedError, match="item 12"):
        zoo.get_config("tiny-moe", param_host_offload=True)
    model = zoo.get_model("tiny-moe", device="cpu", dtype=torch.float32,
                          **SMALL)
    base = {"train_micro_batch_size_per_chip": 1,
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}}
    with pytest.raises(NotImplementedError, match="item 9"):
        deepspeed_tpu_torch.initialize(model=model, config=dict(
            base, moe={"enabled": True, "impl": "einsum"}), device="cpu")
    with pytest.raises(ValueError, match="moe.impl"):
        deepspeed_tpu_torch.initialize(model=model, config=dict(
            base, moe={"impl": "bogus"}), device="cpu")
    eng, *_ = deepspeed_tpu_torch.initialize(model=model, config=dict(
        base, moe={"enabled": True, "ep_size": 1}), device="cpu")
    assert eng.model_config.moe_impl == "auto"
    batch = {"input_ids": np.random.default_rng(0).integers(
        0, 64, (1, 9)).astype(np.int32)}
    assert np.isfinite(float(eng.train_batch(iter([batch]))))
    assert np.isfinite(float(eng.eval_batch(batch)))
