"""The port's speculative decoding against the JAX package (the cases of
tests/test_serving.py's TestSpecDecode and tests/test_kv_tier.py's
TestAdaptiveSpec / TestDrafters), and ROADMAP fault C5 (``impl="auto"``
on a head dim the flash kernels do not take).

The drafters are held to JAX's: prompt lookup proposal for proposal, the
repository's distilled ``TransformerDrafter`` leaf for leaf and id for
id, and the ``.npz`` format in both directions. The spec-on engines'
streams and spec counters equal JAX's spec-on engine's on the tiny model
with JAX's weights carried across, and spec on equals spec off token for
token (prompt lookup, the distilled drafter, adaptive k, an int8 pool, a
page-out / page-in). fp32 on the CPU.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference import spec_decode as jax_spec
from deepspeed_tpu.models.transformer import TransformerConfig as JaxConfig
from deepspeed_tpu.models.transformer import TransformerLM as JaxLM
from deepspeed_tpu.models.zoo import get_model as jax_get_model
from deepspeed_tpu.ops.attention import multi_head_attention as jax_mha
from deepspeed_tpu_torch.config.config import ServingConfig, load_config
from deepspeed_tpu_torch.inference import InferenceEngineV2
from deepspeed_tpu_torch.inference.spec_decode import (Drafter,
                                                       PromptLookupDrafter,
                                                       TransformerDrafter,
                                                       jax_leaf_order)
from deepspeed_tpu_torch.models import zoo
from deepspeed_tpu_torch.models.convert import fp32_tree, params_from_jax
from deepspeed_tpu_torch.ops import attention as port_attn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRAFTER_NPZ = os.path.join(REPO, "docs", "autotuned", "spec_drafter_tiny.npz")

PROMPTS = {1: [5, 6, 7, 5, 6, 7, 5, 6], 2: [1, 2, 1, 2, 1, 2, 1],
           3: [9, 9, 9, 9, 9], 4: [3, 14, 15, 9, 2, 6]}


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
    _, jparams = tiny
    model = params_from_jax(jax.tree.map(np.asarray, jparams),
                            zoo.get_config("tiny", dtype=torch.float32),
                            device="cpu")
    return InferenceEngineV2(model, device="cpu", **_kw(kw))


def make_jax_engine(tiny, **kw):
    jmodel, jparams = tiny
    return JaxEngine(jmodel, params=jparams, dtype=jnp.float32, **_kw(kw))


def _run(eng, prompts, max_new_tokens):
    eng.put(list(prompts), [np.asarray(p, np.int32)
                            for p in prompts.values()],
            max_new_tokens=max_new_tokens)
    return eng.generate_all()


def _spec_counts(eng):
    return {k: eng.stats[k] for k in ("spec_steps", "spec_proposed",
                                      "spec_accepted",
                                      "spec_backoff_rounds")}


def _ramp_prompts(n, mult, shift):
    return {i + 1: ((np.arange(16) * mult + shift * i) % 100).astype(
        np.int32).tolist() for i in range(n)}


class _WrongDrafter:
    """Proposes a token the greedy chain rejects (the tiny model never
    argmaxes vocab - 1 on these prompts)."""

    def propose(self, tokens, k):
        return [255] * int(k)


class _JunkDrafter:
    def propose(self, tokens, k):
        return [0] * k


# -- drafters ----------------------------------------------------------------


def test_prompt_lookup_drafter_cases():
    d = PromptLookupDrafter(max_ngram=3)
    assert d.propose([1, 2, 3, 4, 5, 1, 2, 3], k=2) == [4, 5]
    assert d.propose([7, 9, 7, 8, 7], k=1) == [8]  # most recent match
    assert d.propose([1, 2, 3, 4], k=4) == []
    assert d.propose([1], k=4) == []
    with pytest.raises(ValueError):
        PromptLookupDrafter(max_ngram=2, min_ngram=3)
    assert isinstance(d, Drafter)


@pytest.mark.parametrize("max_ngram,min_ngram,k", [
    (1, 1, 1), (2, 1, 3), (3, 1, 4), (3, 2, 2), (4, 1, 8), (5, 3, 4)])
def test_prompt_lookup_matches_jax(max_ngram, min_ngram, k):
    port = PromptLookupDrafter(max_ngram=max_ngram, min_ngram=min_ngram)
    ref = jax_spec.PromptLookupDrafter(max_ngram=max_ngram,
                                       min_ngram=min_ngram)
    rng = np.random.default_rng(max_ngram * 10 + k)
    for trial in range(40):
        vocab = int(rng.integers(2, 12))  # small vocabularies repeat
        toks = rng.integers(0, vocab, int(rng.integers(0, 40))).tolist()
        assert port.propose(toks, k) == ref.propose(toks, k), (toks, k)
    assert port.stats == ref.stats


def test_distilled_drafter_loads_jax_leaves_bit_equal_and_proposes_jax_ids():
    ref = jax_spec.TransformerDrafter.load(DRAFTER_NPZ)
    port = TransformerDrafter.load(DRAFTER_NPZ, device="cpu")
    ref_leaves, _ = jax.tree_util.tree_flatten(ref.params)
    port_leaves = list(jax_leaf_order(port.params))
    assert len(ref_leaves) == len(port_leaves) == 14
    for want, (path, got) in zip(ref_leaves, port_leaves):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=path)
    assert port.window == ref.window == 64
    assert port.distill_summary == ref.distill_summary
    rng = np.random.default_rng(0)
    for _ in range(12):
        hist = rng.integers(0, 256, int(rng.integers(1, 90))).tolist()
        k = int(rng.integers(1, 6))
        assert port.propose(hist, k) == ref.propose(hist, k), (len(hist), k)


def test_jax_loads_the_port_save(tmp_path):
    port = TransformerDrafter.small(256, window=16, seed=5, device="cpu")
    port.distill_summary = {"steps": 0}
    path = str(tmp_path / "drafter.npz")
    port.save(path)
    ref = jax_spec.TransformerDrafter.load(path)
    ref_leaves, _ = jax.tree_util.tree_flatten(ref.params)
    for want, (_, got) in zip(ref_leaves, jax_leaf_order(port.params)):
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert ref.window == 16 and ref.distill_summary == {"steps": 0}
    again = TransformerDrafter.load(path, device="cpu")
    ctx = list(range(30))
    assert again.propose(ctx, 4) == port.propose(ctx, 4) \
        == ref.propose(ctx, 4)


def test_jax_drafter_params_carry_across():
    """A JAX drafter's params through ``fp32_tree``: the same
    forward (the C5 shape, head dim 16, on the dense path) and ids."""
    ref = jax_spec.TransformerDrafter.small(256, window=16, seed=2)
    port = TransformerDrafter(
        TransformerDrafter.small(256, window=16, device="cpu").model,
        params=fp32_tree(jax.tree.map(np.asarray, ref.params),
                             device="cpu"),
        window=16, dtype=torch.bfloat16)
    toks = np.random.default_rng(1).integers(0, 256, (2, 16)).astype(
        np.int32)
    want = np.asarray(ref.model.apply(ref.params, jnp.asarray(toks)),
                      np.float32)
    got = port._logits(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)
    for hist in ([3], list(range(40)), [7, 7, 7, 9]):
        assert port.propose(hist, 3) == ref.propose(hist, 3)


def test_transformer_drafter_window_and_edge_cases():
    d = TransformerDrafter.small(64, window=8, device="cpu")
    out = d.propose(list(range(20)), k=3)  # history > window: trails
    assert len(out) == 3 and all(0 <= t < 64 for t in out)
    assert d.propose(list(range(20)), k=3) == out
    assert d.propose([], k=3) == []
    assert d.propose([1, 2, 3], k=0) == []
    assert d.stats["empty"] == 2
    with pytest.raises(ValueError, match="window"):
        TransformerDrafter.small(64, window=1, device="cpu")
    # a window that slides inside one proposal equals one JAX-style
    # re-windowed rollout per token
    d2 = TransformerDrafter.small(64, window=8, device="cpu")
    ctx = list(range(6))
    one = d2.propose(ctx, 5)
    step = []
    for _ in range(5):
        step += d2.propose(ctx + step, 1)
    assert one == step


def test_drafter_stats_uniform_across_drafters():
    for drafter in (PromptLookupDrafter(max_ngram=3),
                    TransformerDrafter.small(256, window=16, device="cpu")):
        assert drafter.stats["calls"] == 0
        drafter.propose(list(range(12)), 2)
        assert drafter.stats["calls"] == 1
        drafter.note_result(2, 1)
        assert drafter.stats["drafted_tokens"] == 2
        assert drafter.stats["accepted_tokens"] == 1
        assert drafter.acceptance_rate == pytest.approx(0.5)


def test_distill_improves_agreement_and_roundtrips(tiny, tmp_path):
    model = make_engine(tiny).model
    d = TransformerDrafter.small(model.config.vocab_size, window=16, seed=3,
                                 device="cpu")
    before = d.distill_from(model, steps=0, batch=4,
                            prefix_len=6)["top1_agreement"]
    after = d.distill_from(model, steps=60, batch=4, prefix_len=6,
                           resample_every=30)["top1_agreement"]
    # an untrained drafter agrees with the target near chance (1/vocab);
    # distillation must move it decisively (JAX's own bar)
    assert after > before + 0.05
    assert d.distill_summary["steps"] == 60
    path = str(tmp_path / "drafter.npz")
    d.save(path)
    loaded = TransformerDrafter.load(path, device="cpu")
    ctx = list(range(10))
    assert loaded.propose(ctx, 4) == d.propose(ctx, 4)
    assert loaded.window == d.window
    assert jax_spec.TransformerDrafter.load(path).propose(ctx, 4) \
        == d.propose(ctx, 4)


# -- the speculative engine against JAX's ------------------------------------


def _drafters(kind):
    if kind == "distilled":
        return (TransformerDrafter.load(DRAFTER_NPZ, device="cpu"),
                jax_spec.TransformerDrafter.load(DRAFTER_NPZ))
    if kind == "junk":
        return _JunkDrafter(), _JunkDrafter()
    if kind == "wrong":
        return _WrongDrafter(), _WrongDrafter()
    return None, None


@pytest.mark.parametrize("case", [
    dict(drafter=None, spec_k=4, max_new=12),
    dict(drafter=None, spec_k=2, max_new=12),
    dict(drafter=None, spec_k=4, max_new=12, spec_adaptive_k=True),
    dict(drafter="distilled", spec_k=3, max_new=10),
    dict(drafter="distilled", spec_k=4, max_new=10, spec_adaptive_k=True),
    dict(drafter="junk", spec_k=3, max_new=8),
    dict(drafter="wrong", spec_k=4, max_new=12, spec_adaptive_k=True),
    dict(drafter=None, spec_k=4, max_new=12, kv_quant_bits=8),
    dict(drafter=None, spec_k=4, max_new=12, decode_steps=1),
], ids=["lookup-k4", "lookup-k2", "lookup-adaptive", "distilled-k3",
        "distilled-adaptive", "junk", "wrong-adaptive", "lookup-int8",
        "lookup-no-burst"])
def test_spec_engine_matches_jax_and_spec_off(tiny, case):
    case = dict(case)
    max_new = case.pop("max_new")
    port_d, jax_d = _drafters(case.pop("drafter"))
    kw = dict(case, spec_decode=True)
    port = make_engine(tiny, drafter=port_d, **kw)
    ref = make_jax_engine(tiny, drafter=jax_d, **kw)
    got = _run(port, PROMPTS, max_new)
    want = _run(ref, PROMPTS, max_new)
    assert got == want
    assert _spec_counts(port) == _spec_counts(ref)
    assert port.stats["spec_steps"] > 0
    assert port.stats["spec_accepted"] <= port.stats["spec_proposed"]
    assert port._spec_accept_ewma == pytest.approx(ref._spec_accept_ewma)
    # spec on is token-identical to spec off (greedy acceptance)
    off = {k: v for k, v in case.items() if k != "spec_k"}
    plain = make_engine(tiny, **off)
    assert _run(plain, PROMPTS, max_new) == got
    if port_d is not None and hasattr(port_d, "stats"):
        assert port_d.stats["proposals"] > 0
        assert port_d.stats["drafted_tokens"] == port.stats["spec_proposed"]


def test_adaptive_matches_fixed_k_streams(tiny):
    prompts = _ramp_prompts(3, 7, 3)
    fixed = make_engine(tiny, spec_decode=True, spec_k=4,
                        drafter=PromptLookupDrafter(max_ngram=3))
    ada = make_engine(tiny, spec_decode=True, spec_k=4, spec_adaptive_k=True,
                      drafter=PromptLookupDrafter(max_ngram=3))
    assert _run(ada, prompts, 10) == _run(fixed, prompts, 10)


def test_wrong_drafter_backs_off_to_k0_and_output_is_intact(tiny):
    prompts = _ramp_prompts(2, 3, 5)
    ref = make_engine(tiny)
    eng = make_engine(tiny, spec_decode=True, spec_k=4, spec_adaptive_k=True,
                      drafter=_WrongDrafter())
    jeng = make_jax_engine(tiny, spec_decode=True, spec_k=4,
                           spec_adaptive_k=True, drafter=_WrongDrafter())
    out = _run(eng, prompts, 12)
    assert out == _run(ref, prompts, 12) == _run(jeng, prompts, 12)
    # every draft rejected: the EWMA collapses and k = 0 rounds follow
    assert eng._spec_accept_ewma is not None
    assert eng._spec_accept_ewma < 0.2
    assert eng.stats["spec_backoff_rounds"] >= 1
    assert eng._spec_wasted_verify_tokens > 0
    assert _spec_counts(eng) == _spec_counts(jeng)
    assert eng._spec_wasted_verify_tokens \
        == jeng.snapshot()["spec_wasted_verify_tokens"]


def test_junk_drafter_cannot_corrupt_output(tiny):
    prompts = {1: [4, 8, 15, 16, 23, 42]}
    eng = make_engine(tiny, drafter=_JunkDrafter(), spec_k=3)
    assert isinstance(_JunkDrafter(), Drafter)
    assert _run(eng, prompts, 8) == _run(make_engine(tiny), prompts, 8)
    assert eng.stats["spec_proposed"] > 0
    assert eng.stats["spec_accepted"] <= eng.stats["spec_proposed"]


_GRID = [(None, 0.0), (None, 1.0)] + [
    (a, occ) for a in (0.0, 0.1, 0.3, 0.5, 0.6, 0.8, 0.9, 0.95, 0.99, 1.0)
    for occ in (0.0, 0.25, 0.5, 1.0)]


def test_round_k_matches_jax_over_the_grid(tiny):
    port = make_engine(tiny, spec_decode=True, spec_k=4,
                       spec_adaptive_k=True)
    ref = make_jax_engine(tiny, spec_decode=True, spec_k=4,
                          spec_adaptive_k=True)
    seq = type("S", (), {"uid": 1})()
    other = type("S", (), {"uid": 2})()
    for a, occ in _GRID:
        for eng in (port, ref):
            eng._seq_accept_ewma.clear()
            if a is not None:
                eng._seq_accept_ewma[1] = a
            eng._spec_accept_ewma = 0.7  # the cold-start fallback
        assert port._spec_round_k(seq, occ) == ref._spec_round_k(seq, occ), \
            (a, occ)
        assert port._spec_round_k(other, occ) \
            == ref._spec_round_k(other, occ)
    # JAX's shape checks (tests/test_kv_tier.py)
    port._seq_accept_ewma.clear()
    port._spec_accept_ewma = None
    assert port._spec_round_k(seq, occ=0.0) == 4
    port._seq_accept_ewma[1] = 0.95
    assert port._spec_round_k(seq, occ=0.0) == 4
    port._seq_accept_ewma[1] = 0.5
    assert port._spec_round_k(seq, occ=1.0) == 0
    port._seq_accept_ewma[1] = 0.6
    assert 1 <= port._spec_round_k(seq, occ=0.0) < 4


def test_verify_rounds_take_the_prefill_segment_plan(tiny, monkeypatch):
    """Every verify round runs ``ragged_prefill_forward`` (the paged
    prefill kernel's path) with one segment a sequence and Tq bucketed
    to 8 for k 4; the padding rule's gather fallback is counted, and the
    streams are the same either way."""
    from deepspeed_tpu_torch.inference import model_runner

    shapes = []
    real = model_runner.ragged_prefill_forward

    def spy(cfg, params, kv, seg_tokens, *rest):
        shapes.append(tuple(seg_tokens.shape))
        return real(cfg, params, kv, seg_tokens, *rest)

    monkeypatch.setattr(model_runner, "ragged_prefill_forward", spy)
    eng = make_engine(tiny, spec_decode=True, spec_k=4)
    out = _run(eng, PROMPTS, 12)
    st = eng.stats
    assert st["spec_steps"] > 0
    assert st["spec_verify_kernel_rounds"] == st["spec_steps"]
    assert st["spec_verify_gather_fallbacks"] == 0
    assert (4, 8) in shapes  # 4 live sequences, 1 + 4 rows bucketed to 8
    # a token budget of 12 makes S 4 x Tq 8 > 2 x 12: the padding rule
    # sends every verify round to the gather path, counted, same streams
    small = make_engine(tiny, spec_decode=True, spec_k=4,
                        max_tokens_per_step=12)
    assert _run(small, PROMPTS, 12) == out
    st = small.stats
    assert st["spec_steps"] > 0
    assert st["spec_verify_gather_fallbacks"] == st["spec_steps"]
    assert st["spec_verify_kernel_rounds"] == 0
    # the manual switch to the gather path verifies there too, uncounted
    gather = make_engine(tiny, spec_decode=True, spec_k=4)
    gather._use_paged_kernel = False
    assert _run(gather, PROMPTS, 12) == out
    assert gather.stats["spec_verify_kernel_rounds"] == 0
    assert gather.stats["spec_verify_gather_fallbacks"] == 0


def test_page_out_and_in_keep_the_ewma(tiny):
    prompts = {1: [5, 6, 7, 5, 6, 7, 5, 6, 5, 6, 7, 5],
               2: [1, 2, 1, 2, 1, 2, 1, 2]}
    kw = dict(spec_decode=True, spec_k=4, spec_adaptive_k=True,
              host_kv_tier=True, host_tier_mb=8, decode_steps=1)
    ref = _run(make_engine(tiny), prompts, 24)
    eng = make_engine(tiny, **kw)
    eng.put(list(prompts), [np.asarray(p, np.int32)
                            for p in prompts.values()], max_new_tokens=24)
    got = {}
    while not (eng.stats["spec_steps"] and 1 in eng._seq_accept_ewma):
        for uid, toks in eng.serve_step().items():
            got.setdefault(uid, []).extend(toks)
    ewma = eng._seq_accept_ewma[1]
    assert eng.page_out(1)
    assert 1 not in eng._seq_accept_ewma
    sess = eng.kv_cache.host_tier.peek_session(1)
    assert sess.spec_accept_ewma == ewma
    while 1 not in eng.state.seqs:
        for uid, toks in eng.serve_step().items():
            got.setdefault(uid, []).extend(toks)
    assert eng.stats["paged_in"] == 1
    assert eng._seq_accept_ewma[1] == ewma
    while eng.state.seqs or eng._queue:
        for uid, toks in eng.serve_step().items():
            got.setdefault(uid, []).extend(toks)
    assert got == ref


def test_page_out_drops_blocks_that_rejected_drafts_grew(tiny):
    """A verify round allocates blocks for 1 + k rows; when the drafts
    are rejected the frontier stays behind and the session the host tier
    keeps holds only the blocks of ``seen_tokens``."""
    prompt = {1: list(range(3, 10))}  # 7 tokens: the next block is close
    eng = make_engine(tiny, drafter=_WrongDrafter(), spec_k=4,
                      host_kv_tier=True, host_tier_mb=8, decode_steps=1)
    eng.put([1], [np.asarray(prompt[1], np.int32)], max_new_tokens=16)
    got = []
    while not eng.stats["spec_steps"]:
        got.extend(eng.serve_step().get(1, []))
    seq = eng.state.seqs[1]
    keep = eng.kv_cache.blocks_needed(seq.seen_tokens)
    assert len(seq.kv_blocks) > keep  # the drafts' rows grew a block
    assert eng.page_out(1)
    assert eng.kv_cache.host_tier.peek_session(1).n_blocks == keep
    while eng.state.seqs or eng._queue:
        got.extend(eng.serve_step().get(1, []))
    assert got == _run(make_engine(tiny), prompt, 16)[1]


def test_serving_config_wires_speculation(tiny):
    serving = load_config({"serving": {
        "spec_decode": True, "spec_k": 3, "spec_ngram": 2,
        "spec_adaptive_k": True, "spec_accept_alpha": 0.5}}).serving
    assert isinstance(serving, ServingConfig)
    eng = make_engine(tiny, serving=serving)
    assert isinstance(eng._drafter, PromptLookupDrafter)
    assert eng._drafter.max_ngram == 2
    assert (eng.spec_k, eng._spec_adaptive, eng._spec_alpha) == (3, True,
                                                                 0.5)
    ref = make_jax_engine(tiny, spec_decode=True, spec_k=3, spec_ngram=2,
                          spec_adaptive_k=True, spec_accept_alpha=0.5)
    assert _run(eng, PROMPTS, 10) == _run(ref, PROMPTS, 10)
    assert _spec_counts(eng) == _spec_counts(ref)
    assert make_engine(tiny)._drafter is None


# -- C5: impl="auto" on head dims the flash kernels do not take --------------


@pytest.mark.parametrize("head_dim,dtype,want", [
    (16, torch.bfloat16, "xla"), (32, torch.bfloat16, "xla"),
    (64, torch.bfloat16, "flash"), (128, torch.bfloat16, "flash"),
    (16, torch.float32, "xla"), (64, torch.float32, "flash"),
    (128, torch.float16, "xla"), (96, torch.bfloat16, "xla"),
])
def test_c5_auto_route_on_the_card_is_decided_by_the_shape(head_dim, dtype,
                                                           want):
    assert port_attn.auto_impl("cuda", dtype, head_dim) == want
    assert port_attn.auto_impl("cpu", dtype, head_dim) == "xla"


def test_c5_auto_takes_the_dense_path_on_the_card_route(monkeypatch):
    """A bf16 [1, 64, 2, 16] input routed as the card routes it: "auto"
    computes the dense result without reaching the flash kernel (an
    explicit "flash" on CUDA tensors still raises on head dim 16:
    tests/test_torch_kernels_cuda.py::test_c5_flash_raises_and_auto_is_dense)."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 64, 2, 16)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(3))
    real = port_attn.auto_impl
    seen = []

    def card_route(device_type, dtype, head_dim):
        seen.append(real("cuda", dtype, head_dim))
        return seen[-1]

    def no_flash(*a, **kw):
        raise AssertionError("auto must not reach the flash kernel")

    monkeypatch.setattr(port_attn, "auto_impl", card_route)
    monkeypatch.setattr(port_attn, "flash_attention", no_flash)
    got = port_attn.multi_head_attention(q, k, v, impl="auto")
    assert seen == ["xla"]
    assert torch.equal(got, port_attn.xla_attention(q, k, v))
    with pytest.raises(AssertionError, match="must not reach"):
        port_attn.multi_head_attention(q, k, v, impl="flash")


def test_c5_drafter_sized_auto_forward_matches_jax():
    """The drafter's shape (hidden 32 over 2 heads, head dim 16) through
    ``multi_head_attention(impl="auto")`` in both packages, bf16."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 64, 2, 16)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jax_mha(*(jnp.asarray(x, jnp.bfloat16)
                                for x in (q, k, v)), causal=True,
                              impl="auto"), np.float32)
    got = port_attn.multi_head_attention(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
        causal=True, impl="auto").float().numpy()
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)
    # and a whole JAX drafter-sized model's forward, weights carried over
    cfg = JaxConfig(vocab_size=256, hidden_size=32, num_layers=1,
                    num_heads=2, max_seq_len=64, remat=False)
    jm = JaxLM(cfg)
    jp = jm.init(jax.random.PRNGKey(4))
    toks = rng.integers(0, 256, (2, 64)).astype(np.int32)
    want = np.asarray(jm.apply(jp, jnp.asarray(toks)), np.float32)
    port = TransformerDrafter(
        TransformerDrafter.small(256, window=64, device="cpu").model,
        params=fp32_tree(jax.tree.map(np.asarray, jp), device="cpu"),
        window=64, dtype=torch.bfloat16)
    got = port._logits(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)
