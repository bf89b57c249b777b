"""Port ``InferenceEngineV2`` against the JAX engine on the same weights:
greedy ``generate_all`` streams must be token-identical (the
tests/test_serving.py pattern), through the shared-prefix cache,
overload preemption with requeue, and multi-token decode bursts.

fp32 on the CPU: the port's paged kernels run their plain versions, the
JAX kernels run in Pallas interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.models.zoo import get_model as jax_get_model
from deepspeed_tpu_torch.inference import InferenceEngineV2
from deepspeed_tpu_torch.models import zoo
from deepspeed_tpu_torch.models.convert import params_from_jax

LLAMA = dict(pos_emb="rope", norm="rmsnorm", activation="swiglu",
             num_kv_heads=1, ffn_size=128, tie_embeddings=False)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def tiny():
    jmodel = jax_get_model("tiny", dtype=jnp.float32,
                           param_dtype=jnp.float32, **LLAMA)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = zoo.get_config("tiny", dtype=torch.float32, **LLAMA)
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    return jmodel, jparams, model


def _kw(kw):
    kw.setdefault("kv_blocks", 64)
    kw.setdefault("kv_block_size", 8)
    kw.setdefault("max_tokens_per_step", 32)
    kw.setdefault("max_seqs_per_step", 4)
    kw.setdefault("max_blocks_per_seq", 8)
    return kw


def make_engines(tiny, **kw):
    jmodel, jparams, model = tiny
    kw = _kw(kw)
    jax_eng = JaxEngine(jmodel, params=jparams, dtype=jnp.float32, **kw)
    return jax_eng, InferenceEngineV2(model, device="cpu", **kw)


def _serve(eng, rounds):
    out = {}
    for uids, prompts, n in rounds:
        eng.put(uids, prompts, max_new_tokens=n)
        for uid, toks in eng.generate_all().items():
            out.setdefault(uid, []).extend(toks)
    return out


def test_shared_prefix_streams_match_jax(tiny):
    base = np.arange(16, dtype=np.int32) * 5 % 256
    a = np.concatenate([base, [50, 51, 52, 53]]).astype(np.int32)
    b = np.concatenate([base, [60, 61, 62, 63, 64]]).astype(np.int32)
    rounds = [([1], [a], 6), ([2], [b], 6)]
    jax_eng, eng = make_engines(tiny)
    want, got = _serve(jax_eng, rounds), _serve(eng, rounds)
    assert got == want
    assert eng.stats["prefix_hit_tokens"] == 16
    assert jax_eng.stats["prefix_hit_tokens"] == 16


def test_overload_preempts_and_matches_jax(tiny):
    prompts = [((np.arange(20) * 7 + i) % 100).astype(np.int32)
               for i in range(6)]
    rounds = [(list(range(6)), prompts, 8)]
    jax_eng, eng = make_engines(tiny, kv_blocks=13, max_blocks_per_seq=4,
                                prefix_cache=False)
    want, got = _serve(jax_eng, rounds), _serve(eng, rounds)
    assert got == want
    assert all(len(got[u]) == 8 for u in range(6))  # zero drops
    assert eng.stats["preempted"] >= 1
    assert eng.stats["preempted"] == jax_eng.stats["preempted"]
    assert eng.stats["requeued"] == eng.stats["preempted"]
    assert eng.stats["truncated"] == 0
    assert eng._admit_time == {} and eng._last_emit_time == {}


def test_decode_burst_and_prefill_kernel_steps_match_jax(tiny):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, n).astype(np.int32)
               for n in (5, 12, 3)]
    rounds = [([7, 8, 9], prompts, 10)]
    jax_eng, eng = make_engines(tiny, decode_steps=4)
    want, got = _serve(jax_eng, rounds), _serve(eng, rounds)
    assert got == want
    assert all(len(v) == 10 for v in got.values())
    assert eng.stats["burst_steps"] >= 1
    assert eng.stats["prefill_kernel_steps"] >= 1
    for key in ("decode_kernel_steps", "prefill_kernel_steps",
                "prefill_gather_fallbacks", "burst_steps"):
        assert eng.stats[key] == jax_eng.stats.get(key, 0), key
    assert eng.stats["fallback_reasons"]["vmem"] == 0
    assert len(eng.latency["ttft_s"]) == 3


def test_gather_path_engine_matches_kernel_path(tiny):
    """The manual switch that sends every step through the gather path
    gives the same streams (as the JAX engine's own switch does); bursts
    always run the decode kernel, so the gather engine steps one token
    at a time."""
    prompts = [((np.arange(11) * 3 + i) % 200).astype(np.int32)
               for i in range(3)]
    _, eng = make_engines(tiny)
    _, gather = make_engines(tiny, decode_steps=1)
    gather._use_paged_kernel = False
    rounds = [([0, 1, 2], prompts, 5)]
    assert _serve(gather, rounds) == _serve(eng, rounds)
    assert gather.stats["decode_kernel_steps"] == 0
    assert gather.stats["prefill_kernel_steps"] == 0


def test_put_rejects_never_fitting_prompt_and_full_queue(tiny):
    _, eng = make_engines(tiny, max_blocks_per_seq=2)
    with pytest.raises(ValueError, match="never"):
        eng.put([1], [np.zeros(40, np.int32)])
    _, eng = make_engines(tiny, kv_blocks=13, max_queue_depth=1)
    eng.put([1], [np.arange(60, dtype=np.int32) % 100])
    eng.put([2], [np.arange(60, dtype=np.int32) % 100])
    assert len(eng._queue) == 1
    with pytest.raises(RuntimeError, match="queue full"):
        eng.put([3], [np.arange(60, dtype=np.int32) % 100])
    eng.flush([1, 2])
    assert not eng.state.seqs and not eng._queue
