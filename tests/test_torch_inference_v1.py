"""The v1 inference engine of the port (``init_inference``,
``InferenceEngine``, ``model_runner.forward_with_cache``) against the JAX
package's, after ``tests/test_inference.py``'s ``TestDenseCacheRunner``,
``TestInferenceEngineV1`` and ``TestWeightOnlyQuant``: the same seeded
weights carried across, fp32 on the CPU.

Tolerances: the dense-cache forward within rtol/atol 2e-4 of JAX's (the
reference test's own); greedy streams token-identical; int8 codes and
scales bit-equal, the quantized logits within 2e-4 of JAX's quantized
engine and their argmax equal.
"""

import jax
import jax.numpy as jnp
import types

import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import init_inference as jax_init_inference
from deepspeed_tpu.inference import model_runner as jax_runner
from deepspeed_tpu.inference import weight_quant as jwq
from deepspeed_tpu.models.zoo import get_model as jax_get_model
import deepspeed_tpu_torch
from deepspeed_tpu_torch.inference import InferenceEngine, init_inference
from deepspeed_tpu_torch.inference import engine as port_engine
from deepspeed_tpu_torch.inference import model_runner
from deepspeed_tpu_torch.inference import weight_quant as wq
from deepspeed_tpu_torch.models import zoo
from deepspeed_tpu_torch.models.convert import params_from_jax

TOL = 2e-4
LLAMA = dict(pos_emb="rope", norm="rmsnorm", activation="swiglu",
             num_kv_heads=1, ffn_size=128, tie_embeddings=False)
FALCON = dict(parallel_block=True, use_biases=True)
# GPT-2 style tiny (tied, learned positions), Llama-style tiny (rope,
# GQA 4:1, untied), Falcon-style tiny (parallel block, biases), tiny MoE
MODELS = {"tiny": ("tiny", {}), "tiny-llama": ("tiny", LLAMA),
          "tiny-falcon": ("tiny", FALCON), "tiny-moe": ("tiny-moe", {})}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _pair(name, seed=0):
    preset, over = MODELS[name]
    jmodel = jax_get_model(preset, dtype=jnp.float32,
                           param_dtype=jnp.float32, **over)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    model = params_from_jax(jax.tree.map(np.asarray, jparams),
                            zoo.get_config(preset, dtype=torch.float32,
                                           **over), device="cpu")
    return jmodel, jparams, model


@pytest.fixture(scope="module")
def tiny():
    return _pair("tiny")


def _np(t):
    return t.detach().cpu().numpy()


# -- the dense-cache runner ------------------------------------------------


@pytest.mark.parametrize("name", sorted(MODELS))
def test_prefill_matches_jax_and_full_forward(name):
    jmodel, jparams, model = _pair(name)
    toks = np.random.default_rng(0).integers(0, 255, (2, 17)).astype(np.int32)
    jcache = jax_runner.init_dense_cache(jmodel.config, 2, 64, jnp.float32)
    want, jcache = jax_runner.forward_with_cache(
        jmodel.config, jparams, jnp.asarray(toks), jcache, 0)
    cache = model_runner.init_dense_cache(model.config, 2, 64, torch.float32,
                                          "cpu")
    assert tuple(cache.shape) == tuple(jcache.shape)
    got, out_cache = model_runner.forward_with_cache(
        model.config, model.params(), torch.from_numpy(toks), cache, 0)
    assert out_cache is cache  # written in place
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_np(cache), np.asarray(jcache), rtol=TOL,
                               atol=TOL)
    full = model.apply(model.params(), torch.from_numpy(toks))
    np.testing.assert_allclose(_np(full), _np(got), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_decode_matches_jax_and_full_forward(name):
    """Prefill 8 tokens, then decode one at a time: each step's logits
    against JAX's runner and against the full forward."""
    jmodel, jparams, model = _pair(name)
    toks = np.random.default_rng(1).integers(0, 255, (1, 12)).astype(np.int32)
    full = _np(model.apply(model.params(), torch.from_numpy(toks)))
    jcache = jax_runner.init_dense_cache(jmodel.config, 1, 32, jnp.float32)
    _, jcache = jax_runner.forward_with_cache(
        jmodel.config, jparams, jnp.asarray(toks[:, :8]), jcache, 0)
    cache = model_runner.init_dense_cache(model.config, 1, 32, torch.float32,
                                          "cpu")
    params = model.params()
    _, cache = model_runner.forward_with_cache(
        model.config, params, torch.from_numpy(toks[:, :8]), cache, 0)
    for i in range(8, 12):
        want, jcache = jax_runner.forward_with_cache(
            jmodel.config, jparams, jnp.asarray(toks[:, i:i + 1]), jcache, i)
        got, cache = model_runner.forward_with_cache(
            model.config, params, torch.from_numpy(toks[:, i:i + 1]), cache,
            i)
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(_np(got)[:, 0], full[:, i], rtol=TOL,
                                   atol=TOL)


def test_cache_rows_past_the_end_raise(tiny):
    _, _, model = tiny
    cache = model_runner.init_dense_cache(model.config, 1, 8, torch.float32,
                                          "cpu")
    with pytest.raises(ValueError, match="do not fit"):
        model_runner.forward_with_cache(model.config, model.params(),
                                        torch.zeros((1, 4), dtype=torch.int32),
                                        cache, 6)


# -- the engine --------------------------------------------------------------


def _engines(name, seed=0, **kw):
    jmodel, jparams, model = _pair(name, seed)
    jeng = jax_init_inference(jmodel, params=jparams, dtype=jnp.float32,
                              max_seq_len=64, **kw)
    eng = init_inference(model, dtype=torch.float32, max_seq_len=64, **kw)
    return jeng, eng


@pytest.mark.parametrize("name", sorted(MODELS))
@pytest.mark.parametrize("batch", [1, 2])
def test_greedy_generate_token_identical_to_jax(name, batch):
    jeng, eng = _engines(name, seed=2)
    rng = np.random.default_rng(batch)
    prompt = rng.integers(1, 255, (batch, 5)).astype(np.int32)
    want = np.asarray(jeng.generate(prompt, max_new_tokens=9))
    got = eng.generate(prompt, max_new_tokens=9)
    assert got.shape == (batch, 14) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # with an eos the streams take: rows stop and pad the same way
    eos = int(want[0, 7])
    want = np.asarray(jeng.generate(prompt, max_new_tokens=9,
                                    eos_token_id=eos))
    got = eng.generate(prompt, max_new_tokens=9, eos_token_id=eos)
    np.testing.assert_array_equal(got, want)
    assert (got[0, 8:] == eos).all()


def test_prompt_longer_than_the_bucket_floor(tiny):
    """A 20-token prompt pads to a 32 bucket (JAX's pow2 rule), a 1-token
    one to 16."""
    jmodel, jparams, model = tiny
    jeng = jax_init_inference(jmodel, params=jparams, dtype=jnp.float32,
                              max_seq_len=64)
    eng = init_inference(model, dtype=torch.float32, max_seq_len=64)
    for S in (1, 20):
        prompt = np.arange(3, 3 + S, dtype=np.int32)[None]
        np.testing.assert_array_equal(
            eng.generate(prompt, max_new_tokens=6),
            np.asarray(jeng.generate(prompt, max_new_tokens=6)))


def test_greedy_generate_matches_teacher_forcing(tiny):
    _, _, model = tiny
    eng = init_inference(model, dtype=torch.float32, max_seq_len=64)
    prompt = np.asarray([[5, 9, 2, 14, 7]], np.int32)
    out = eng.generate(prompt, max_new_tokens=4)
    assert out.shape == (1, 9)
    # each generated token is the argmax of the full forward over
    # everything before it
    for i in range(5, 9):
        logits = _np(eng.forward(out[:, :i]))
        assert out[0, i] == logits[0, -1].argmax(), f"mismatch at pos {i}"


def test_forward_matches_jax(tiny):
    jmodel, jparams, model = tiny
    jeng = jax_init_inference(jmodel, params=jparams, dtype=jnp.float32,
                              max_seq_len=64)
    eng = InferenceEngine(model, dtype=torch.float32, max_seq_len=64)
    toks = np.array([[3, 1, 4, 1, 5, 9]], np.int32)
    np.testing.assert_allclose(_np(eng(toks)), np.asarray(jeng(toks)),
                               rtol=TOL, atol=TOL)


def test_params_as_a_jax_tree(tiny):
    """``params=`` takes the JAX tree (numpy leaves) as well as the port's
    own; the engine runs on the model's device."""
    jmodel, jparams, model = tiny
    other = zoo.get_model("tiny", device="cpu", dtype=torch.float32, seed=9)
    eng = init_inference(other, params=jax.tree.map(np.asarray, jparams),
                         dtype=torch.float32, max_seq_len=64)
    ref = init_inference(model, dtype=torch.float32, max_seq_len=64)
    prompt = np.array([[7, 7, 1]], np.int32)
    np.testing.assert_array_equal(eng.generate(prompt, max_new_tokens=5),
                                  ref.generate(prompt, max_new_tokens=5))
    assert eng.device == torch.device("cpu")
    meta = zoo.get_model("tiny", device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="params live on"):
        InferenceEngine(meta, params={"embed": {
            "tokens": torch.zeros(1, device="meta")}})


def test_limits_raise(tiny):
    _, _, model = tiny
    eng = init_inference(model, dtype=torch.float32, max_seq_len=16,
                         max_batch=2)
    with pytest.raises(ValueError, match="max_batch"):
        eng.generate(np.ones((3, 4), np.int32), max_new_tokens=2)
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.generate(np.ones((1, 10), np.int32), max_new_tokens=7)


def test_tp_and_mesh_raise_naming_item_11(tiny):
    """TP is ported (tests/test_torch_tp.py serves it on two ranks); on
    one process JAX's checks hold: a tp mesh needs as many ranks, and tp
    must divide both head counts."""
    from deepspeed_tpu_torch.inference.engine import check_tp
    from deepspeed_tpu_torch.parallel import topology

    _, _, model = tiny
    # as in JAX, a global mesh (an earlier engine's) wins over tp_size
    topology.set_global_mesh(None)
    with pytest.raises(ValueError, match="fixed axes product 2"):
        init_inference(model, tensor_parallel={"tp_size": 2},
                       dtype=torch.float32)
    mesh3 = types.SimpleNamespace(shape={"tp": 3})
    with pytest.raises(ValueError, match="tp=3 does not divide num_heads"):
        check_tp(model.config, mesh3, None)
    with pytest.raises(ValueError, match="does not compose with tp>1"):
        check_tp(model.config, types.SimpleNamespace(shape={"tp": 2}),
                 "int8")
    # tp_size 1 is the one card
    init_inference(model, tensor_parallel={"tp_size": 1},
                   dtype=torch.float32)
    with pytest.raises(ValueError, match="supports 'int8'"):
        init_inference(model, quantize_weights="int4")
    assert deepspeed_tpu_torch.init_inference is init_inference


# -- sampling ------------------------------------------------------------------


@pytest.mark.parametrize("temperature,top_k", [(1.0, 0), (0.7, 5),
                                                (2.0, 1)])
def test_sample_masks_logits_as_jax(monkeypatch, temperature, top_k):
    from deepspeed_tpu.inference import engine as jax_engine

    logits = np.random.default_rng(4).standard_normal((3, 50)).astype(
        np.float32)
    logits[1, 7] = logits[1, 9] = logits[1].max() + 1.0  # a tie at the top
    seen = {}

    def capture(rng, masked, axis=-1):
        seen["masked"] = np.asarray(masked)
        return jnp.zeros(masked.shape[0], jnp.int32)

    monkeypatch.setattr(jax_engine.jax.random, "categorical", capture)
    jax_engine._sample(jnp.asarray(logits), temperature, top_k,
                       jax.random.PRNGKey(0))
    got = port_engine._masked_logits(torch.from_numpy(logits), temperature,
                                     top_k)
    np.testing.assert_array_equal(_np(got), seen["masked"])
    # greedy: the first maximum, as jnp.argmax
    assert _np(port_engine._sample(torch.from_numpy(logits), 0.0, 0)).tolist() \
        == np.asarray(jnp.argmax(jnp.asarray(logits), -1)).tolist()


def test_sampling_seeded(tiny):
    _, _, model = tiny
    eng = init_inference(model, dtype=torch.float32, max_seq_len=64)
    prompt = np.array([[5, 9, 2], [1, 2, 3]], np.int32)
    a = eng.generate(prompt, max_new_tokens=12, temperature=1.0, top_k=20,
                     seed=5)
    b = eng.generate(prompt, max_new_tokens=12, temperature=1.0, top_k=20,
                     seed=5)
    c = eng.generate(prompt, max_new_tokens=12, temperature=1.0, top_k=20,
                     seed=6)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    # top_k 1 draws the argmax whatever the seed
    np.testing.assert_array_equal(
        eng.generate(prompt, max_new_tokens=6, temperature=1.0, top_k=1,
                     seed=7),
        eng.generate(prompt, max_new_tokens=6))


# -- weight-only int8 ------------------------------------------------------------


def _qleaves(tree, path=""):
    out = {}
    for k, v in tree.items():
        p = f"{path}/{k}"
        if isinstance(v, dict):
            out.update(_qleaves(v, p))
        elif isinstance(v, (wq.QuantizedTensor, jwq.QuantizedTensor)):
            out[p] = v
    return out


@pytest.mark.parametrize("name", ["tiny", "tiny-llama", "tiny-falcon"])
def test_int8_weights_match_jax(name):
    jeng, eng = _engines(name, seed=1, quantize_weights="int8")
    jq, pq = _qleaves(jeng.params), _qleaves(eng.params)
    assert sorted(pq) == sorted(jq) and pq
    for path, qt in pq.items():
        np.testing.assert_array_equal(_np(qt.q), np.asarray(jq[path].q))
        np.testing.assert_array_equal(
            _np(qt.scale).view(np.int32),
            np.asarray(jq[path].scale).view(np.int32))
    toks = np.array([[3, 1, 4, 1, 5, 9]], np.int32)
    got, want = _np(eng.forward(toks)), np.asarray(jeng.forward(toks))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    prompt = np.array([[3, 1, 4]], np.int32)
    np.testing.assert_array_equal(
        eng.generate(prompt, max_new_tokens=6),
        np.asarray(jeng.generate(prompt, max_new_tokens=6)))


def test_int8_close_to_exact(tiny):
    """JAX's ``test_quantized_serving_close_to_exact``: int8 noise, not
    divergence; the quantized leaves take ~4x fewer bytes."""
    _, _, model = tiny
    exact = init_inference(model, dtype=torch.float32, max_seq_len=64)
    toks = np.array([[3, 1, 4, 1, 5, 9]], np.int32)
    le = _np(exact.forward(toks))
    _, _, model2 = _pair("tiny")
    quant = init_inference(model2, dtype=torch.float32, max_seq_len=64,
                           quantize_weights="int8")
    wq_leaf = quant.params["layers"]["attn"]["wq"]
    assert isinstance(wq_leaf, wq.QuantizedTensor)
    assert wq_leaf.nbytes < 0.45 * np.prod(wq_leaf.shape) * 4
    lq = _np(quant.forward(toks))
    np.testing.assert_allclose(lq, le, atol=0.2)
    np.testing.assert_array_equal(lq.argmax(-1), le.argmax(-1))
