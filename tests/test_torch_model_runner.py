"""Port ragged runner against the JAX runner on the same weights.

Weights come from the JAX ``model.init(PRNGKey(0))`` and cross over
through ``params_from_jax``; KV pools and metadata are made with numpy
from a seed and handed to both sides. Everything runs in fp32 on the CPU
(the port's paged attention through its plain version, the JAX one in
Pallas interpret mode). Logits and the updated pool agree at atol 1e-4:
the two frameworks sum matmuls in different orders, and 2 layers of
fp32 round-off stay well under that. Greedy tokens must be identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import model_runner as jax_runner
from deepspeed_tpu.models.zoo import get_model as jax_get_model
from deepspeed_tpu_torch.inference import model_runner as runner
from deepspeed_tpu_torch.models import zoo
from deepspeed_tpu_torch.models.convert import params_from_jax

TOL = dict(rtol=1e-4, atol=1e-4)
BS = 8          # block size
NB = 24         # pool blocks; the last one is the scratch block
BM = 4          # max pages per slot

# GPT-2 style tiny (learned positions, layernorm, gelu, tied, MHA) and a
# Llama-style tiny (rope, rmsnorm, swiglu, untied, GQA group 4)
CONFIGS = {
    "tiny": {},
    "tiny-llama": dict(pos_emb="rope", norm="rmsnorm", activation="swiglu",
                       num_kv_heads=1, ffn_size=128, tie_embeddings=False),
}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def pair(request):
    over = CONFIGS[request.param]
    jmodel = jax_get_model("tiny", dtype=jnp.float32,
                           param_dtype=jnp.float32, **over)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = zoo.get_config("tiny", dtype=torch.float32, **over)
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    return jmodel.config, jparams, cfg, model.params()


def _pool(cfg, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((cfg.num_layers, NB, BS, 2, cfg.kv_heads,
                                cfg.head_dim)).astype(np.float32)


def _table(seed, S):
    rng = np.random.default_rng(seed)
    return rng.permutation(NB - 1)[:S * BM].reshape(S, BM).astype(np.int32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _check_pool(got, want):
    # the scratch block takes every padded write, in no defined order
    np.testing.assert_allclose(got[:, :-1], np.asarray(want)[:, :-1], **TOL)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_and_rope_match_jax(kind):
    from deepspeed_tpu.models import transformer as jax_tf
    from deepspeed_tpu_torch.models import transformer as tf

    rng = np.random.default_rng(16)
    x = rng.standard_normal((3, 5, 4, 16)).astype(np.float32) * 3
    p = {"scale": rng.standard_normal(16).astype(np.float32),
         "bias": rng.standard_normal(16).astype(np.float32)}
    want = jax_tf._norm(jnp.asarray(x), {k: jnp.asarray(v) for k, v in
                                         p.items()}, kind, 1e-5)
    got = tf._norm(_t(x), {k: _t(v) for k, v in p.items()}, kind, 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    pos = rng.integers(0, 4000, (3, 5)).astype(np.int32)
    want = jax_tf._rope(jnp.asarray(x), jnp.asarray(pos), 5e5)
    got = tf.apply_rope(_t(x), *tf.rope_tables(_t(pos), 16, 5e5))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_params_cross_over_leaf_by_leaf(pair):
    jcfg, jparams, cfg, params = pair
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert flat
    for path, leaf in flat:
        node = params
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_prefill_forward_matches_jax(pair):
    jcfg, jparams, cfg, params = pair
    S, Tq = 3, 8
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (S, Tq)).astype(np.int32)
    # seg 0: chunk on 11 tokens of history; seg 1: dead; seg 2: 5 real
    # tokens from position 0 (3 padded rows)
    pos0 = np.array([11, 0, 0], np.int32)
    nreal = np.array([8, 0, 5], np.int32)
    kv, bt = _pool(cfg, 2), _table(3, S)
    want_lg, want_kv = jax_runner.ragged_prefill_forward(
        jcfg, jparams, jnp.asarray(kv), jnp.asarray(toks),
        jnp.asarray(pos0), jnp.asarray(nreal), jnp.asarray(bt))
    got_lg, got_kv = runner.ragged_prefill_forward(
        cfg, params, _t(kv), _t(toks), _t(pos0), _t(nreal), _t(bt))
    assert got_lg.shape == (S, Tq, cfg.vocab_size)
    np.testing.assert_allclose(got_lg.numpy(), np.asarray(want_lg), **TOL)
    _check_pool(got_kv.numpy(), want_kv)


def test_decode_forward_matches_jax(pair):
    jcfg, jparams, cfg, params = pair
    S = 4
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, S).astype(np.int32)
    pos = np.array([0, 13, 0, 31], np.int32)
    ctx = np.array([1, 14, 0, 32], np.int32)  # slot 2 is dead
    kv, bt = _pool(cfg, 5), _table(6, S)
    want_lg, want_kv = jax_runner.ragged_decode_forward(
        jcfg, jparams, jnp.asarray(kv), jnp.asarray(toks), jnp.asarray(pos),
        jnp.asarray(bt), jnp.asarray(ctx))
    got_lg, got_kv = runner.ragged_decode_forward(
        cfg, params, _t(kv), _t(toks), _t(pos), _t(bt), _t(ctx))
    np.testing.assert_allclose(got_lg.numpy(), np.asarray(want_lg), **TOL)
    _check_pool(got_kv.numpy(), want_kv)


def test_gather_forward_matches_jax(pair):
    jcfg, jparams, cfg, params = pair
    S, T = 3, 16
    rng = np.random.default_rng(7)
    # slot 0: 6-token chunk at 9; slot 1: one decode token at 20;
    # slot 2: 4 tokens from 0; 5 padding tokens
    seq = np.array([0] * 6 + [1] + [2] * 4 + [0] * 5, np.int32)
    pos = np.array(list(range(9, 15)) + [20] + list(range(4)) + [0] * 5,
                   np.int32)
    toks = rng.integers(0, cfg.vocab_size, T).astype(np.int32)
    kv, bt = _pool(cfg, 8), _table(9, S)
    want_lg, want_kv = jax_runner.ragged_forward(
        jcfg, jparams, jnp.asarray(kv), jnp.asarray(toks), jnp.asarray(seq),
        jnp.asarray(pos), jnp.asarray(bt), jnp.asarray(11, jnp.int32))
    got_lg, got_kv = runner.ragged_forward(
        cfg, params, _t(kv), _t(toks), _t(seq), _t(pos), _t(bt), 11)
    np.testing.assert_allclose(got_lg.numpy(), np.asarray(want_lg), **TOL)
    _check_pool(got_kv.numpy(), want_kv)


def test_multi_decode_matches_jax(pair):
    jcfg, jparams, cfg, params = pair
    S, steps = 4, 3
    rng = np.random.default_rng(10)
    toks = rng.integers(0, cfg.vocab_size, S).astype(np.int32)
    pos = np.array([5, 0, 17, 2], np.int32)
    ctx = np.array([6, 0, 18, 3], np.int32)  # slot 1 dead
    kv, bt = _pool(cfg, 11), _table(12, S)
    want_toks, want_kv = jax_runner.ragged_multi_decode(
        jcfg, jparams, jnp.asarray(kv), jnp.asarray(toks), jnp.asarray(pos),
        jnp.asarray(bt), jnp.asarray(ctx), steps=steps)
    got_toks, got_kv = runner.ragged_multi_decode(
        cfg, params, _t(kv), _t(toks), _t(pos), _t(bt), _t(ctx),
        steps=steps)
    assert got_toks.dtype == torch.int32 and got_toks.shape == (steps, S)
    np.testing.assert_array_equal(got_toks.numpy(), np.asarray(want_toks))
    assert np.all(got_toks.numpy()[:, 1] == 0)
    _check_pool(got_kv.numpy(), want_kv)


def test_prefill_kernel_path_matches_gather_path(pair):
    """Within the port: a prefill chunk through the paged prefill path
    and the same tokens through the gather path give the same logits."""
    _, _, cfg, params = pair
    Tq = 8
    rng = np.random.default_rng(13)
    toks = rng.integers(0, cfg.vocab_size, Tq).astype(np.int32)
    kv, bt = _pool(cfg, 14), _table(15, 1)
    lg_k, _ = runner.ragged_prefill_forward(
        cfg, params, _t(kv), _t(toks[None]), _t(np.array([3], np.int32)),
        _t(np.array([Tq], np.int32)), _t(bt))
    lg_g, _ = runner.ragged_forward(
        cfg, params, _t(kv), _t(toks), _t(np.zeros(Tq, np.int32)),
        _t(np.arange(3, 3 + Tq, dtype=np.int32)), _t(bt), Tq)
    np.testing.assert_allclose(lg_k.numpy()[0], lg_g.numpy(), **TOL)
