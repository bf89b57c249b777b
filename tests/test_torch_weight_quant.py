"""Weight-only int8 serving of the port against the JAX package: the same
leaves quantized as JAX's ``quantize_params``, the same codes and scales,
``QuantizedTensor.to`` equal to JAX's ``.astype`` bit for bit in fp32,
and greedy engine streams with ``quantize_weights="int8"`` identical to
the JAX engine's. fp32 on the CPU (plain versions of the kernels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import keystr, tree_flatten_with_path

from deepspeed_tpu.inference import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference import weight_quant as jwq
from deepspeed_tpu.models.zoo import get_model as jax_get_model
from deepspeed_tpu_torch.inference import InferenceEngineV2
from deepspeed_tpu_torch.inference import weight_quant as wq
from deepspeed_tpu_torch.models import zoo
from deepspeed_tpu_torch.models.convert import params_from_jax

LLAMA = dict(pos_emb="rope", norm="rmsnorm", activation="swiglu",
             num_kv_heads=1, ffn_size=128, tie_embeddings=False)
# GPT-2 style tiny (tied, biases), Llama-style tiny, tiny MoE
MODELS = {"tiny": ("tiny", {}), "tiny-llama": ("tiny", LLAMA),
          "tiny-moe": ("tiny-moe", {})}


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


def _jax_quantized(jparams):
    tree = jwq.quantize_params(jparams)
    leaves = tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jwq.QuantizedTensor))[0]
    return tree, {keystr(p): v for p, v in leaves
                  if isinstance(v, jwq.QuantizedTensor)}


def _port_quantized(tree, path=""):
    out = {}
    for k, v in tree.items():
        p = f"{path}['{k}']"
        if isinstance(v, dict):
            out.update(_port_quantized(v, p))
        elif isinstance(v, wq.QuantizedTensor):
            out[p] = v
    return out


@pytest.mark.parametrize("name", sorted(MODELS))
def test_same_leaves_codes_and_dequant_as_jax(name):
    _, jparams, model = _pair(name)
    jtree, jq = _jax_quantized(jparams)
    ptree = wq.quantize_params(model.params())
    pq = _port_quantized(ptree)
    assert sorted(pq) == sorted(jq) and pq
    for path, qt in pq.items():
        want = jq[path]
        assert qt.shape == tuple(want.shape) and qt.ndim == want.ndim
        np.testing.assert_array_equal(qt.q.numpy(), np.asarray(want.q))
        np.testing.assert_array_equal(qt.scale.numpy().view(np.int32),
                                      np.asarray(want.scale).view(np.int32))
        full = qt.to(torch.float32)
        np.testing.assert_array_equal(
            full.numpy().view(np.int32),
            np.asarray(want.astype(jnp.float32)).view(np.int32))
        # the runner's per-layer slice dequantizes to the same values
        assert torch.equal(qt[0].to(torch.float32), full[0])
    assert wq.quantized_fraction(ptree) == pytest.approx(
        jwq.quantized_fraction(jtree), rel=1e-12)


def test_pick_block_and_skip_rules():
    assert wq.pick_block(14336) == 128 and wq.pick_block(48) == 16
    assert wq.pick_block(40) is None
    assert wq.pick_block(40) == jwq.pick_block(40)
    w = torch.ones(3, 40)
    assert not wq._eligible("['layers']['mlp']['wi']", w)  # block < 16
    assert not wq._eligible("['embed']['tokens']", torch.ones(4, 64))
    assert wq._eligible("['unembed']['kernel']", torch.ones(4, 64))
    assert not wq._eligible("['layers']['attn']['bq']", torch.ones(4, 64))
    with pytest.raises(ValueError, match="block divisor"):
        wq.quantize_weight(w)
    with pytest.raises(IndexError, match="leading dims"):
        wq.quantize_weight(torch.ones(2, 64))[0, 1]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_engine_streams_match_jax(name):
    jmodel, jparams, model = _pair(name, seed=3)
    kw = dict(kv_blocks=64, kv_block_size=8, max_tokens_per_step=32,
              max_seqs_per_step=4, max_blocks_per_seq=8, decode_steps=4)
    base = np.arange(16, dtype=np.int32) * 5 % 256
    prompts = [np.concatenate([base, [50 + i, 51]]).astype(np.int32)
               for i in range(3)]
    outs = []
    for eng in (JaxEngine(jmodel, params=jparams, dtype=jnp.float32,
                          quantize_weights="int8", **kw),
                InferenceEngineV2(model, device="cpu",
                                  quantize_weights="int8", **kw)):
        eng.put([0], prompts[:1], max_new_tokens=8)
        out = eng.generate_all()
        eng.put([1, 2], prompts[1:], max_new_tokens=8)
        out.update(eng.generate_all())
        outs.append(out)
    assert outs[1] == outs[0]
    assert all(len(v) == 8 for v in outs[1].values())


def test_engine_releases_the_full_precision_leaves():
    _, _, model = _pair("tiny-llama")
    before = {k: v.numel() for k, v in model.named_parameters()}
    with pytest.raises(ValueError, match="int8"):
        InferenceEngineV2(model, device="cpu", quantize_weights="int4")
    eng = InferenceEngineV2(model, device="cpu", quantize_weights="int8",
                            kv_blocks=16, kv_block_size=8)
    after = {k: v.numel() for k, v in model.named_parameters()}
    released = sorted(k for k in before if after[k] == 0)
    assert released and all(before[k] > 0 for k in released)
    assert len(released) == len(_port_quantized(eng.params))
    assert after["tree.embed.tokens"] == before["tree.embed.tokens"]
    eng.put([0], [np.arange(12, dtype=np.int32)], max_new_tokens=3)
    assert len(eng.generate_all()[0]) == 3
