"""The port's host KV tier against the JAX package (the cases of
tests/test_kv_tier.py): ``HostKVTier`` bookkeeping, explicit page-out
with warm resume, pool exhaustion paging a victim out, a spilled session
degrading to recompute, evicted prefix chains paging back in, and an fp8
pool paging its native payload. Greedy streams must be identical to an
untiered port engine and to the JAX engine's. fp32 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.models.zoo import get_model as jax_get_model
from deepspeed_tpu_torch.inference import InferenceEngineV2
from deepspeed_tpu_torch.inference.ragged import HostKVTier, PagedSession
from deepspeed_tpu_torch.models import zoo
from deepspeed_tpu_torch.models.convert import params_from_jax


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def tiny():
    jmodel = jax_get_model("tiny", dtype=jnp.float32,
                           param_dtype=jnp.float32)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    return jmodel, jparams


def _kw(kw):
    kw.setdefault("kv_blocks", 64)
    kw.setdefault("kv_block_size", 8)
    kw.setdefault("max_tokens_per_step", 32)
    kw.setdefault("max_seqs_per_step", 4)
    kw.setdefault("max_blocks_per_seq", 8)
    return kw


def make_engine(tiny, **kw):
    jmodel, jparams = tiny
    model = params_from_jax(jax.tree.map(np.asarray, jparams),
                            zoo.get_config("tiny", dtype=torch.float32),
                            device="cpu")
    return InferenceEngineV2(model, device="cpu", **_kw(kw))


def make_jax_engine(tiny, **kw):
    jmodel, jparams = tiny
    return JaxEngine(jmodel, params=jparams, dtype=jnp.float32, **_kw(kw))


def serve_all(engine):
    out = {}
    while engine.state.seqs or engine._queue:
        for uid, toks in engine.serve_step().items():
            out.setdefault(uid, []).extend(toks)
    return out


def _page_out_after(eng, uid, n):
    """Serve until ``uid`` has ``n`` tokens, then page it out."""
    got = []
    while len(got) < n:
        got.extend(eng.serve_step().get(uid, []))
    assert eng.page_out(uid)
    return got


def _block(shape=(2, 1, 4, 2, 2, 8), seed=0):
    return np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32)


def _session(uid, payload, generated=(), seen=4):
    return PagedSession(uid=uid, input_tokens=np.arange(4, dtype=np.int32),
                        generated=list(generated), seen_tokens=seen,
                        max_new_tokens=4, prior_generated=0,
                        payload=payload, scales=None)


# -- the host tier's own bookkeeping (no device, no engine) --------------


def test_chain_put_take_move_semantics():
    t = HostKVTier(capacity_bytes=1 << 20)
    p = _block()
    t.put_chain(["k1"], p, None)
    assert t.has_block("k1") and t.chain_blocks == 1
    assert t.used_bytes == p.nbytes
    got, scales = t.take_block("k1")
    assert scales is None and np.array_equal(got, p[:, 0])
    # move semantics: the host copy is gone once paged back in
    assert t.take_block("k1") is None
    assert t.used_bytes == 0
    assert t.stats["chain_blocks_out"] == 1
    assert t.stats["chain_blocks_in"] == 1


def test_lru_evicts_chains_before_sessions():
    one = _block().nbytes
    t = HostKVTier(capacity_bytes=3 * one)
    assert t.put_session(_session(7, _block(), generated=[1], seen=5))
    t.put_chain(["a"], _block(seed=1), None)
    t.put_chain(["b"], _block(seed=2), None)
    # full: the next chain evicts the LRU chain ("a"); the parked
    # session, a live request, survives
    t.put_chain(["c"], _block(seed=3), None)
    assert not t.has_block("a")
    assert t.has_block("b") and t.has_block("c")
    assert t.has_session(7)
    assert t.stats["evicted_chain_blocks"] == 1
    assert t.stats["evicted_sessions"] == 0
    # only when no chain is left to drop do sessions go
    big = _session(8, _block(shape=(2, 3, 4, 2, 2, 8), seed=9))
    assert t.put_session(big)
    assert not t.has_session(7) and t.has_session(8)
    assert t.chain_blocks == 0
    assert t.stats["evicted_sessions"] == 1
    assert t.snapshot()["sessions"] == 1


def test_oversize_rejected_not_stored():
    t = HostKVTier(capacity_bytes=16)
    t.put_chain(["big"], _block(), None)
    assert not t.has_block("big") and t.used_bytes == 0
    assert not t.put_session(_session(1, _block(), seen=2))
    assert t.stats["rejected_oversize"] == 2


def test_peek_is_side_effect_free():
    t = HostKVTier(capacity_bytes=1 << 20)
    sess = _session(3, _block(), generated=[9], seen=5)
    t.put_session(sess)
    before = (t.used_bytes, dict(t.stats))
    assert t.peek_session(3) is sess
    assert (t.used_bytes, dict(t.stats)) == before
    assert t.pop_session(3) is sess
    assert t.used_bytes == 0 and t.stats["sessions_in"] == 1
    assert t.peek_session(3) is None


# -- warm resume: paged-out sessions continue without re-prefill ---------


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_explicit_page_out_resume_matches_untiered_and_jax(tiny, bits):
    prompt = ((np.arange(20) * 5 + 3) % 100).astype(np.int32)
    want = []
    for eng in (make_engine(tiny, kv_quant_bits=bits),
                make_jax_engine(tiny, kv_quant_bits=bits)):
        eng.put([1], [prompt], max_new_tokens=10)
        want.append(eng.generate_all()[1])
    assert want[0] == want[1]

    eng = make_engine(tiny, kv_quant_bits=bits, host_kv_tier=True,
                      host_tier_mb=4)
    eng.put([1], [prompt], max_new_tokens=10)
    got = _page_out_after(eng, 1, 4)
    tier = eng.kv_cache.host_tier
    assert tier.has_session(1) and eng.stats["paged_out"] == 1
    prefill = eng.scheduler.stats["prefill_tokens"]
    rest = serve_all(eng)
    assert got + rest[1] == want[0]
    # resumed from host memory: no second prefill pass ran
    assert eng.stats["paged_in"] == 1
    assert eng.stats["warm_resume_tokens"] > 0
    assert eng.scheduler.stats["prefill_tokens"] == prefill
    assert not tier.has_session(1)


def test_pool_exhaustion_pages_out_and_resumes(tiny):
    prompts = [((np.arange(18) * 3 + 11 * i) % 100).astype(np.int32)
               for i in range(4)]
    uids = list(range(4))
    ref = make_engine(tiny)
    ref.put(uids, prompts, max_new_tokens=8)
    out_ref = ref.generate_all()
    # 13 blocks = 12 usable: all four 18-token prompts admit, prefill in
    # one 128-token step, and cross the 24-token block boundary in the
    # same decode step with zero free blocks; the victim pages out and
    # warm-resumes instead of recomputing
    outs = []
    for eng in (make_engine(tiny, kv_blocks=13, max_tokens_per_step=128,
                            host_kv_tier=True, host_tier_mb=8),
                make_jax_engine(tiny, kv_blocks=13, max_tokens_per_step=128,
                                host_kv_tier=True, host_tier_mb=8)):
        eng.put(uids, prompts, max_new_tokens=8)
        outs.append(serve_all(eng))
        assert eng.stats["paged_out"] >= 1
        assert eng.stats["paged_in"] == eng.stats["paged_out"]
    assert {u: outs[0][u] for u in uids} == out_ref
    assert outs[0] == outs[1]


def test_session_spill_degrades_to_recompute(tiny):
    prompt = ((np.arange(20) * 7 + 1) % 100).astype(np.int32)
    ref = make_engine(tiny)
    ref.put([1], [prompt], max_new_tokens=10)
    out_ref = ref.generate_all()
    eng = make_engine(tiny, host_kv_tier=True, host_tier_mb=4)
    eng.put([1], [prompt], max_new_tokens=10)
    got = _page_out_after(eng, 1, 4)
    # the parked session is lost (host pressure elsewhere): resume falls
    # back to the requeue recompute path, stream unchanged
    assert eng.kv_cache.host_tier.pop_session(1) is not None
    rest = serve_all(eng)
    assert got + rest[1] == out_ref[1]
    assert eng.stats["paged_in"] == 0


def test_page_out_refuses_unknown_and_finished(tiny):
    eng = make_engine(tiny, host_kv_tier=True)
    assert not eng.page_out(99)  # never admitted
    eng.put([1], [np.arange(12, dtype=np.int32)], max_new_tokens=2)
    eng.generate_all()
    assert not eng.page_out(1)  # already completed and released
    assert not make_engine(tiny).page_out(1)  # no tier


# -- evicted prefix chains page back in through the attach walk ----------


def test_evicted_chain_pages_in_on_reuse(tiny):
    prompt = np.arange(20, dtype=np.int32) % 100
    cold = make_engine(tiny)
    cold.put([1], [prompt], max_new_tokens=4)
    out_cold = cold.generate_all()

    outs = []
    for eng in (make_engine(tiny, kv_blocks=9, host_kv_tier=True,
                            host_tier_mb=8),
                make_jax_engine(tiny, kv_blocks=9, host_kv_tier=True,
                                host_tier_mb=8)):
        eng.put([1], [prompt], max_new_tokens=4)
        first = eng.generate_all()
        assert first[1] == out_cold[1]
        tier = eng.kv_cache.host_tier
        # decode growth of a second request reclaims the idle cached
        # chain, which pages OUT to the tier instead of dropping
        eng.put([2], [(np.arange(20, dtype=np.int32) + 37) % 100],
                max_new_tokens=30)
        second = eng.generate_all()
        assert tier.stats["chain_blocks_out"] >= 1
        assert eng.holds_prefix_blocks(prompt) >= 1
        # the same prompt returns: its chain walk continues into the
        # tier, blocks page back in, and the stream matches cold prefill
        eng.put([3], [prompt], max_new_tokens=4)
        third = eng.generate_all()
        assert third[3] == out_cold[1]
        assert tier.stats["chain_blocks_in"] >= 1
        assert eng.stats["prefix_hit_tokens"] > 0
        outs.append((second, third, dict(tier.stats)))
    assert outs[0][:2] == outs[1][:2]
    assert outs[0][2]["chain_blocks_in"] == outs[1][2]["chain_blocks_in"]


def test_paged_in_chain_refcounts_survive_release(tiny):
    prompt = np.arange(20, dtype=np.int32) % 100
    eng = make_engine(tiny, kv_blocks=9, host_kv_tier=True, host_tier_mb=8)
    eng.put([1], [prompt], max_new_tokens=4)
    ref_out = eng.generate_all()
    eng.put([2], [(np.arange(20, dtype=np.int32) + 37) % 100],
            max_new_tokens=30)
    eng.generate_all()
    for uid in (3, 4):
        eng.put([uid], [prompt], max_new_tokens=4)
        assert eng.generate_all()[uid] == ref_out[1]
    cache = eng.kv_cache.prefix_cache
    assert cache.evictable_blocks <= cache.cached_blocks


# -- an fp8 pool pages its native payload ---------------------------------


def test_fp8_warm_resume_pages_native_payload(tiny):
    prompt = ((np.arange(20) * 5 + 3) % 100).astype(np.int32)
    want = []
    for eng in (make_engine(tiny, kv_quant_bits="fp8"),
                make_jax_engine(tiny, kv_quant_bits="fp8")):
        eng.put([1], [prompt], max_new_tokens=10)
        want.append(eng.generate_all()[1])
    assert want[0] == want[1]
    eng = make_engine(tiny, kv_quant_bits="fp8", host_kv_tier=True,
                      host_tier_mb=4)
    eng.put([1], [prompt], max_new_tokens=10)
    got = _page_out_after(eng, 1, 4)
    sess = eng.kv_cache.host_tier.peek_session(1)
    # pool-native page-out: the e4m3 bytes and fp32 scales, no re-encode
    assert sess.payload.dtype == np.uint8 and sess.scales is not None
    assert sess.payload.shape[-1] == eng.cfg.head_dim
    restored = torch.from_numpy(sess.payload).view(torch.float8_e4m3fn)
    assert restored.float().abs().max() <= 448
    rest = serve_all(eng)
    assert got + rest[1] == want[0]
    assert eng.stats["paged_in"] == 1


def test_block_io_round_trips_every_pool_dtype():
    from deepspeed_tpu_torch.inference.ragged import (BlockedKVCache,
                                                      KVCacheConfig)

    for bits, dtype in ((None, torch.bfloat16), (None, torch.float32),
                        (8, None), (4, None), ("fp8", None)):
        cfg = KVCacheConfig(num_layers=2, kv_heads=2, head_dim=8,
                            block_size=4, num_blocks=6, quant_bits=bits,
                            **({} if dtype is None else {"dtype": dtype}))
        kv = BlockedKVCache(cfg, device="cpu")
        raw = kv.data.view(torch.uint8)
        raw.copy_(torch.randint(0, 120, raw.shape, dtype=torch.uint8))
        if kv.scales is not None:
            kv.scales.uniform_()
        payload, scales = kv.read_blocks_host([4, 1])
        kv.write_blocks([2, 3], payload, scales)
        assert torch.equal(raw[:, 2], raw[:, 4])
        assert torch.equal(raw[:, 3], raw[:, 1])
        if scales is not None:
            assert torch.equal(kv.scales[:, [2, 3]], kv.scales[:, [4, 1]])
