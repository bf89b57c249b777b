"""Port training forward (``loss_fn``) and its gradients against the JAX
``loss_fn`` and ``jax.grad`` on the same weights and tokens.

Weights come from the JAX ``model.init(PRNGKey(0))`` and cross over
through ``params_from_jax``; tokens come from numpy seeds. fp32 on the
CPU: the port's flash attention runs its plain versions through the
autograd Function, the JAX one runs in Pallas interpret mode. Configs:
the ``entry()`` shapes (``__graft_entry__.py:15-17``: Llama-style rope,
rmsnorm, swiglu, untied, GQA 2) with ``attn_impl="flash"``, remat on
and off; and the GPT-2-style ``TINY`` of ``tests/test_engine.py``
(learned positions, layernorm, gelu, tied), also with a Falcon-style
parallel block, biases and rope. Tolerances: loss rtol 1e-5,
every gradient leaf atol 1e-4 (two frameworks summing fp32 matmuls in
different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import transformer as jax_tf
from deepspeed_tpu.models.zoo import get_model as jax_get_model
from deepspeed_tpu_torch.models import transformer as tf
from deepspeed_tpu_torch.models import zoo
from deepspeed_tpu_torch.models.convert import (params_from_jax,
                                                params_to_numpy)

ENTRY = dict(num_layers=2, hidden_size=256, ffn_size=512, num_heads=8,
             num_kv_heads=4, vocab_size=1024, max_seq_len=256)
TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            max_seq_len=32, pos_emb="learned", norm="layernorm",
            activation="gelu", tie_embeddings=True)
# name -> (zoo preset or None for a bare config, overrides, batch, seq)
CASES = {
    "entry-flash-remat": ("llama3-8b", dict(ENTRY, attn_impl="flash",
                                            remat=True), 2, 129),
    "entry-flash": ("llama3-8b", dict(ENTRY, attn_impl="flash",
                                      remat=False), 2, 129),
    "tiny": (None, dict(TINY, remat=False), 4, 17),
    "tiny-flash-masked": (None, dict(TINY, remat=True, attn_impl="flash"),
                          4, 17),
    # Falcon-style: parallel residual block, projection biases, rope, MQA
    "tiny-parallel-biases": (None, dict(TINY, remat=False, attn_impl="flash",
                                        parallel_block=True, use_biases=True,
                                        pos_emb="rope", num_kv_heads=1),
                             2, 17),
}
LOSS_RTOL, GRAD_ATOL = 1e-5, 1e-4


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _configs(name):
    preset, over, _, _ = CASES[name]
    if preset is None:
        jcfg = jax_tf.TransformerConfig(dtype=jnp.float32, **over)
        return jax_tf.TransformerLM(jcfg), tf.TransformerConfig(
            dtype=torch.float32, **over)
    return (jax_get_model(preset, dtype=jnp.float32, **over),
            zoo.get_config(preset, dtype=torch.float32, **over))


def _batch(name, vocab):
    _, _, B, S = CASES[name]
    rng = np.random.default_rng(7)
    batch = {"input_ids": rng.integers(0, vocab, (B, S)).astype(np.int32)}
    if name.endswith("masked"):
        mask = (rng.random((B, S)) < 0.7).astype(np.float32)
        mask[:, 1] = 1.0
        batch["loss_mask"] = mask
    return batch


def _flat(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", tree[k]


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_and_every_gradient_match_jax(name):
    jmodel, cfg = _configs(name)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    batch = _batch(name, cfg.vocab_size)

    (want_loss, want_aux), want_grads = jax.value_and_grad(
        lambda p: jax_tf.loss_fn(jmodel.config, p, {
            k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jparams)

    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    params = _leaf_copies(model.params())
    loss, aux = tf.loss_fn(cfg, params, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(aux["ntokens"].item(),
                               float(want_aux["ntokens"]))
    got = dict(_flat(params_to_numpy(_grads(params))))
    want = dict(_flat(jax.tree.map(np.asarray, want_grads)))
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=GRAD_ATOL,
                                   rtol=0, err_msg=path)


def test_apply_logits_and_model_protocol():
    jmodel, cfg = _configs("entry-flash")
    jparams = jmodel.init(jax.random.PRNGKey(1))
    toks = np.random.default_rng(3).integers(0, 1024, (2, 64)).astype(
        np.int32)
    want = np.asarray(jmodel.apply(jparams, jnp.asarray(toks)))
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    with torch.no_grad():
        got = model.apply(model.params(), torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == (2, 64, 1024)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    assert model.flops_per_token() == jmodel.flops_per_token()
    assert model.num_params() == jmodel.num_params()


def test_unported_switches_raise():
    # sequence parallelism is ported (tests/test_torch_sp.py): the switch
    # builds, and its mode is checked as JAX checks it
    cfg = zoo.get_config("tiny", sequence_parallel=True, sp_mode="ring")
    assert cfg.sequence_parallel and cfg.sp_mode == "ring"
    with pytest.raises(ValueError, match="sp_mode must be ulysses|ring"):
        zoo.get_config("tiny", sequence_parallel=True, sp_mode="bogus")
    # the fp8 MLP is ported (A10; tests/test_torch_fp8_quant_stats.py)
    assert zoo.get_config("tiny", fp8_mlp=True).fp8_mlp
    # A11's one-card switches are ported (tests/test_torch_long_context.py,
    # tests/test_torch_param_stream.py)
    for field, value in (("attn_chunks", 4), ("tiled_logits", 8),
                         ("tiled_mlp", 2), ("fpdt_host_kv", True),
                         ("param_host_offload", True)):
        assert getattr(zoo.get_config("tiny", **{field: value}),
                       field) == value
    zoo.get_config("tiny", attn_chunks=1, tiled_logits=0)  # both mean off


def _leaf_copies(tree):
    return {k: (_leaf_copies(v) if isinstance(v, dict)
                else v.detach().clone().requires_grad_())
            for k, v in tree.items()}


def _grads(tree):
    return {k: (_grads(v) if isinstance(v, dict) else v.grad)
            for k, v in tree.items()}
