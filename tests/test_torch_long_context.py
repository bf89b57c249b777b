"""The port's long-context machinery against JAX's
(``tests/test_long_context.py`` contracts): ALST tiled compute
(``parallel/tiled_compute.py``), the blockwise online softmax
(``parallel/_blockwise.py``), FPDT chunked attention, host-KV streaming
and the hosted residual (``parallel/fpdt.py``), and the model's switches
(``tiled_logits``, ``tiled_mlp``, ``attn_chunks``, ``fpdt_host_kv``,
``fpdt_host_residual``).

Each function against its JAX counterpart on the same numpy inputs from
a seed, at JAX's own tolerances (rtol 1e-5 for the tiled functions, 2e-5
for chunked attention, 5e-5 for its gradients, atol 2e-5 / rtol 2e-4
for the host-KV block); ``loss_fn`` and every gradient leaf in each mode
against JAX's ``loss_fn`` at fp32 (weights through ``params_from_jax``;
``tests/test_torch_transformer_train.py``'s rtol 1e-5 / atol 1e-4); the
engine tests are JAX's (falling losses, tiled == untiled within 2e-3,
the hosted residual within 2e-5 of the host-KV path's loss and 2e-3 of
its gradients). FPDT over the sequence-parallel ranks (and JAX's
``test_fpdt_sp_engine_trains``, which fails in the reference itself) are
not oracles here: the ``sp_axis`` mode raises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as jax_tf
from deepspeed_tpu.ops.attention import xla_attention as jax_xla
from deepspeed_tpu.parallel import _blockwise as jbw
from deepspeed_tpu.parallel import fpdt as jfpdt
from deepspeed_tpu.parallel import tiled_compute as jtc
from deepspeed_tpu_torch.models import transformer as tf
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.ops.attention import xla_attention
from deepspeed_tpu_torch.parallel import _blockwise as bw
from deepspeed_tpu_torch.parallel import fpdt
from deepspeed_tpu_torch.parallel.tiled_compute import (
    sequence_tiled_compute, tiled_logits_loss, tiled_mlp)
from deepspeed_tpu_torch.utils import memspace

LOSS_RTOL, GRAD_ATOL = 1e-5, 1e-4
BASE = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            num_kv_heads=2, max_seq_len=64, pos_emb="rope", norm="rmsnorm",
            activation="swiglu", tie_embeddings=False, remat=False,
            attn_impl="xla")
TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            max_seq_len=64, pos_emb="learned", norm="layernorm",
            activation="gelu", tie_embeddings=True, remat=False)


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(x, grad=False):
    t = torch.from_numpy(np.asarray(x, np.float32).copy())
    return t.requires_grad_() if grad else t


# -- tiled compute ----------------------------------------------------------


def test_sequence_tiled_compute_matches_direct_and_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 37, 16)).astype(np.float32)
    w = rng.standard_normal((16, 16)).astype(np.float32)
    out = sequence_tiled_compute(
        lambda t: F.gelu(t @ _t(w), approximate="tanh"), _t(x), n_tiles=4)
    direct = F.gelu(_t(x) @ _t(w), approximate="tanh")
    np.testing.assert_allclose(out.numpy(), direct.numpy(), rtol=1e-6,
                               atol=1e-6)
    want = jtc.sequence_tiled_compute(lambda t: jax.nn.gelu(t @ w), x, 4)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_tiled_mlp_grads_match_direct_and_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 32, 8)).astype(np.float32)
    w = rng.standard_normal((8, 8)).astype(np.float32)
    wt = _t(w, grad=True)
    (tiled_mlp(lambda t: t @ wt, _t(x), 4) ** 2).sum().backward()
    wd = _t(w, grad=True)
    ((_t(x) @ wd) ** 2).sum().backward()
    np.testing.assert_allclose(wt.grad.numpy(), wd.grad.numpy(), rtol=1e-5,
                               atol=1e-5)
    want = jax.grad(lambda w: jnp.sum(jtc.tiled_mlp(
        lambda t: t @ w, x, 4) ** 2))(w)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _logits_inputs(seed, B, S, H, V, masked):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H)).astype(np.float32),
            rng.standard_normal((V, H)).astype(np.float32),
            rng.integers(0, V, (B, S)).astype(np.int32),
            rng.integers(0, 2, (B, S)).astype(np.float32) if masked
            else None)


def test_tiled_logits_loss_matches_dense_and_jax():
    hidden, emb, labels, mask = _logits_inputs(2, 2, 33, 16, 50, True)
    nll, tot = tiled_logits_loss(_t(hidden), _t(emb),
                                 torch.from_numpy(labels), _t(mask), 4,
                                 transpose_unembed=True)
    logits = _t(hidden) @ _t(emb).t()
    gold = torch.gather(logits, -1, torch.from_numpy(labels).long()[..., None])
    ref = ((torch.logsumexp(logits, -1) - gold[..., 0]) * _t(mask)).sum()
    np.testing.assert_allclose(nll.item(), ref.item(), rtol=1e-5)
    assert tot.item() == mask.sum()
    jn, jt = jtc.tiled_logits_loss(hidden, emb, labels, mask, 4,
                                   transpose_unembed=True)
    np.testing.assert_allclose(nll.item(), float(jn), rtol=1e-5)
    assert tot.item() == float(jt)


@pytest.mark.parametrize("transpose", [True, False])
def test_tiled_logits_loss_grads_match_jax(transpose):
    hidden, emb, labels, _ = _logits_inputs(3, 2, 16, 8, 20, False)
    if not transpose:
        emb = np.ascontiguousarray(emb.T)
    e = _t(emb, grad=True)
    h = _t(hidden, grad=True)
    nll, tot = tiled_logits_loss(h, e, torch.from_numpy(labels), None, 4,
                                 transpose_unembed=transpose)
    (nll / tot).backward()

    def loss(emb, hidden):
        n, t = jtc.tiled_logits_loss(hidden, emb, labels, None, 4,
                                     transpose_unembed=transpose)
        return n / t

    ge, gh = jax.grad(loss, argnums=(0, 1))(emb, hidden)
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(ge), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(gh), rtol=1e-5,
                               atol=1e-6)


# -- blockwise numerics -----------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
def test_block_partial_merge_and_finalize_match_jax(causal):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 8, 3, 16)).astype(np.float32)
    k = rng.standard_normal((2, 24, 3, 16)).astype(np.float32)
    v = rng.standard_normal((2, 24, 3, 16)).astype(np.float32)
    seg = rng.integers(0, 2, (2, 24)).astype(np.int32)
    got = bw.init_accumulators(2, 3, 8, 16)
    want = jbw.init_accumulators(2, 3, 8, 16)
    q_pos = np.arange(8) + 10
    for t in range(3):
        k_pos = np.arange(8) + 8 * t
        sl = slice(8 * t, 8 * t + 8)
        seg_q = seg[:, 10:18]
        b = bw.block_attn_partial(_t(q), _t(k[:, sl]), _t(v[:, sl]),
                                  torch.from_numpy(q_pos),
                                  torch.from_numpy(k_pos), causal, 22,
                                  torch.from_numpy(seg_q),
                                  torch.from_numpy(seg[:, sl]))
        jb = jbw.block_attn_partial(q, k[:, sl], v[:, sl], q_pos, k_pos,
                                    causal, 22, seg_q, seg[:, sl])
        for a, c in zip(b, jb):
            np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-5,
                                       atol=1e-5)
        got = bw.online_merge(*got, b)
        want = jbw.online_merge(*want, jb)
    np.testing.assert_allclose(
        bw.finalize(got[0], got[2], torch.float32).numpy(),
        np.asarray(jbw.finalize(want[0], want[2], jnp.float32)),
        rtol=1e-5, atol=1e-5)


# -- chunked attention ------------------------------------------------------


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,chunks", [(32, 4), (33, 4), (40, 8)])
def test_chunked_attention_matches_dense_and_jax(causal, S, chunks):
    q, k, v = _qkv(4, (2, S, 4, 8))
    out = fpdt.chunked_attention(_t(q), _t(k), _t(v), causal=causal,
                                 q_chunks=chunks)
    ref = xla_attention(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-5,
                               atol=2e-5)
    want = jfpdt.chunked_attention(q, k, v, causal=causal, q_chunks=chunks)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(ref.numpy(), np.asarray(
        jax_xla(q, k, v, causal=causal)), rtol=2e-5, atol=2e-5)


def test_chunked_attention_grads_match_dense_and_jax():
    q, k, v = _qkv(5, (1, 24, 2, 8))
    qt = _t(q, grad=True)
    (fpdt.chunked_attention(qt, _t(k), _t(v), q_chunks=4) ** 2).sum() \
        .backward()
    qd = _t(q, grad=True)
    (xla_attention(qd, _t(k), _t(v)) ** 2).sum().backward()
    np.testing.assert_allclose(qt.grad.numpy(), qd.grad.numpy(), rtol=5e-5,
                               atol=5e-5)
    want = jax.grad(lambda a: jnp.sum(
        jfpdt.chunked_attention(a, k, v, q_chunks=4) ** 2))(q)
    np.testing.assert_allclose(qt.grad.numpy(), np.asarray(want), rtol=5e-5,
                               atol=5e-5)


def test_one_chunk_is_multi_head_attention(monkeypatch):
    from deepspeed_tpu_torch.ops import attention

    seen = []
    orig = attention.multi_head_attention
    monkeypatch.setattr(attention, "multi_head_attention",
                        lambda *a, **k: seen.append(k) or orig(*a, **k))
    q, k, v = _qkv(6, (1, 16, 2, 8))
    out = fpdt.chunked_attention(_t(q), _t(k), _t(v), q_chunks=1,
                                 impl="flash")
    assert seen and seen[0]["impl"] == "flash"
    np.testing.assert_allclose(out.numpy(), xla_attention(
        _t(q), _t(k), _t(v)).numpy(), rtol=2e-5, atol=2e-5)


def test_chunked_attention_saves_no_score_block():
    """The chunk and tile bodies are recomputed: the backward keeps only
    their inputs, never a [chunk x kv_tile] score block (JAX's
    test_chunked_attention_grad_memory_bounded, counted in saved bytes
    instead of compiled temporaries)."""
    B, S, N, D, CH = 1, 512, 4, 16, 8
    saved = {}

    def pack(t):
        store = t.untyped_storage()  # views of one tensor count once
        saved[store.data_ptr()] = store.nbytes()
        return t

    q = torch.zeros((B, S, N, D), requires_grad=True)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fpdt.chunked_attention(q, q, q, causal=True, q_chunks=CH)
    stacked = N * S * S // CH * 4  # one chunk's stacked probabilities
    assert sum(saved.values()) < stacked, (sum(saved.values()), stacked)
    (out ** 2).sum().backward()


# -- FPDT host-KV streaming -------------------------------------------------


def _block_inputs(kv_heads, S=48, H=32, N=4, D=8, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((2, S, H)).astype(np.float32)
    ap = {"wq": rng.standard_normal((H, N, D)).astype(np.float32) * 0.1,
          "wk": rng.standard_normal((H, kv_heads, D)).astype(np.float32)
          * 0.1,
          "wv": rng.standard_normal((H, kv_heads, D)).astype(np.float32)
          * 0.1,
          "wo": rng.standard_normal((N, D, H)).astype(np.float32) * 0.1}
    return y, ap


@pytest.mark.parametrize("S", [48, 45])
@pytest.mark.parametrize("kv_heads", [4, 2])
def test_fpdt_host_kv_block_matches_jax(kv_heads, S):
    """fpdt_attention_block (K/V tiles on the host, per-chunk queries,
    streamed tiles) against JAX's block and the dense path, forward and
    gradients, with GQA and rope; S 45 pads the chunk grid."""
    y, ap = _block_inputs(kv_heads, S=S)
    positions = torch.arange(S)[None, :]
    rope = tf.rope_tables(positions, 8, 10000.0)
    yt = _t(y, grad=True)
    apt = {k: _t(v, grad=True) for k, v in ap.items()}
    out = fpdt.fpdt_attention_block(
        yt, apt, rope, num_heads=4, kv_heads=kv_heads, head_dim=8,
        q_chunks=4, causal=True)
    (out ** 2).sum().backward()

    def jblock(y, ap):
        return jfpdt.fpdt_attention_block(
            y, ap, jnp.arange(S)[None, :], num_heads=4, kv_heads=kv_heads,
            head_dim=8, rope_theta=10000.0, q_chunks=4, causal=True)

    want = jblock(y, ap)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=2e-5, rtol=2e-4)
    gy, gap = jax.grad(lambda y, ap: jnp.sum(jblock(y, ap) ** 2),
                       argnums=(0, 1))(y, ap)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(gy), atol=1e-4,
                               rtol=1e-4)
    for name in ap:
        np.testing.assert_allclose(apt[name].grad.numpy(),
                                   np.asarray(gap[name]), atol=1e-4,
                                   rtol=1e-4, err_msg=name)
    # the dense path
    q = tf.apply_rope(tf._proj(_t(y), _t(ap["wq"])), *rope)
    k = tf.apply_rope(tf._proj(_t(y), _t(ap["wk"])), *rope)
    v = tf._proj(_t(y), _t(ap["wv"]))
    ref = xla_attention(q, k, v, causal=True).reshape(2, S, -1) @ \
        _t(ap["wo"]).reshape(-1, 32)
    np.testing.assert_allclose(out.detach().numpy(), ref.numpy(), atol=2e-5,
                               rtol=2e-4)


def test_fpdt_host_kv_stages_the_tiles_on_the_host():
    y, ap = _block_inputs(2)
    memspace.reset_transfer_stats()
    fpdt.fpdt_attention_block(_t(y), {k: _t(v) for k, v in ap.items()},
                              None, num_heads=4, kv_heads=2, head_dim=8,
                              q_chunks=4)
    # K and V of every tile down once; each chunk streams its causal tiles
    # (1 + 2 + 3 + 4 of 4) up
    tile = 2 * 12 * 2 * 8 * 4
    assert memspace.TRANSFER_STATS["to_host_bytes"] == 2 * 4 * tile
    assert memspace.TRANSFER_STATS["to_device_bytes"] == 2 * 10 * tile


def test_fpdt_sp_mode_raises():
    y, ap = _block_inputs(2)
    with pytest.raises(NotImplementedError, match="item 11's sp part"):
        fpdt.fpdt_attention_block(_t(y), {k: _t(v) for k, v in ap.items()},
                                  None, num_heads=4, kv_heads=2, head_dim=8,
                                  q_chunks=4, sp_axis="sp", sp_size=2)


# -- the model's switches against JAX --------------------------------------

MODES = {
    "tiled": dict(tiled_logits=4, tiled_mlp=4),
    "chunked": dict(attn_chunks=4),
    "tiled_chunked": dict(tiled_logits=4, tiled_mlp=4, attn_chunks=4),
    "host_kv": dict(attn_chunks=4, fpdt_host_kv=True),
    "host_kv_remat": dict(attn_chunks=4, fpdt_host_kv=True, remat=True),
    "hosted": dict(attn_chunks=4, fpdt_host_kv=True,
                   fpdt_host_residual=True),
}


def _flat(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _flat(tree[k], f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", tree[k]


def _copies(tree):
    return {k: (_copies(v) if isinstance(v, dict)
                else v.detach().clone().requires_grad_())
            for k, v in tree.items()}


def _port_grads(cfg, jparams, batch):
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    params = _copies(model.params())
    loss, aux = tf.loss_fn(cfg, params, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
    loss.backward()
    return loss.item(), aux, {p: t.grad.numpy() for p, t in _flat(params)}


@pytest.mark.parametrize("base", ["llama", "gpt"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_loss_and_gradients_match_jax(mode, base):
    over = dict(BASE if base == "llama" else TINY, **MODES[mode])
    if base == "gpt" and mode == "hosted":
        over["use_biases"] = True
    jcfg = jax_tf.TransformerConfig(dtype=jnp.float32, **over)
    jmodel = jax_tf.TransformerLM(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    batch = {"input_ids": rng.integers(0, 64, (2, 46)).astype(np.int32)}
    mask = (rng.random((2, 46)) < 0.8).astype(np.float32)
    batch["loss_mask"] = mask
    (want, waux), wgrads = jax.value_and_grad(
        lambda p: jax_tf.loss_fn(jcfg, p, {k: jnp.asarray(v)
                                           for k, v in batch.items()}),
        has_aux=True)(jparams)
    cfg = tf.TransformerConfig(dtype=torch.float32, **over)
    got, aux, grads = _port_grads(cfg, jparams, batch)
    np.testing.assert_allclose(got, float(want), rtol=LOSS_RTOL)
    assert aux["ntokens"].item() == float(waux["ntokens"])
    wflat = dict(_flat(jax.tree.map(np.asarray, wgrads)))
    assert sorted(grads) == sorted(wflat)
    for path in wflat:
        np.testing.assert_allclose(grads[path], wflat[path], atol=GRAD_ATOL,
                                   rtol=0, err_msg=path)


def test_hosted_apply_logits_match_jax():
    over = dict(BASE, **MODES["hosted"])
    jcfg = jax_tf.TransformerConfig(dtype=jnp.float32, **over)
    jparams = jax_tf.TransformerLM(jcfg).init(jax.random.PRNGKey(2))
    toks = np.random.default_rng(8).integers(0, 64, (2, 45)).astype(np.int32)
    want = np.asarray(jax_tf.apply(jcfg, jparams, jnp.asarray(toks)))
    cfg = tf.TransformerConfig(dtype=torch.float32, **over)
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    with torch.no_grad():
        got = model.apply(model.params(), torch.from_numpy(toks))
    assert got.shape == (2, 45, 64)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_hosted_switch_checks():
    with pytest.raises(ValueError, match="requires fpdt_host_kv"):
        tf.TransformerConfig(fpdt_host_residual=True)
    with pytest.raises(ValueError, match="sequential"):
        tf.TransformerConfig(fpdt_host_residual=True, fpdt_host_kv=True,
                             parallel_block=True)
    cfg = tf.TransformerConfig(dtype=torch.float32, **dict(
        BASE, **MODES["hosted"]))
    with pytest.raises(ValueError, match="apply_hidden_hosted"):
        tf.apply_hidden(cfg, {}, torch.zeros((1, 8), dtype=torch.long))


# -- the engine (JAX's engine tests) ----------------------------------------


def _engine(cfg_over, micro=1, stage=0, seed=0, dtype=torch.float32):
    from deepspeed_tpu_torch.models import zoo

    model = zoo.get_model("tiny", device="cpu", seed=seed, dtype=dtype,
                          **cfg_over)
    return deepspeed_tpu_torch.initialize(model=model, config={
        "train_micro_batch_size_per_chip": micro,
        "optimizer": {"type": "adamw", "params": {"lr": 1e-2}},
        "zero_optimization": {"stage": stage}, "steps_per_print": 100},
        device="cpu")[0]


def _cycle(batches):
    i = 0
    while True:
        yield batches[i % len(batches)]
        i += 1


def test_fpdt_host_kv_grads_and_training():
    """A tiny model trains with fpdt_host_kv and matches the standard
    path's first loss (JAX: rtol 1e-4)."""
    losses = {}
    rng = np.random.default_rng(0)
    batch = {"input_ids": rng.integers(0, 64, (1, 48)).astype(np.int32)}
    for host_kv in (False, True):
        eng = _engine(dict(BASE, attn_chunks=4, fpdt_host_kv=host_kv))
        it = _cycle([batch])
        losses[host_kv] = [float(eng.train_batch(it)) for _ in range(6)]
        assert all(np.isfinite(losses[host_kv]))
        assert losses[host_kv][-1] < losses[host_kv][0]
    np.testing.assert_allclose(losses[True][0], losses[False][0], rtol=1e-4)


def test_train_tiled_and_chunked():
    eng = _engine(dict(TINY, tiled_logits=4, tiled_mlp=4, attn_chunks=4),
                  micro=2, stage=2)
    rng = np.random.default_rng(0)
    it = _cycle([{"input_ids": rng.integers(0, 64, (2, 48)).astype(
        np.int32)} for _ in range(2)])
    losses = [float(eng.train_batch(it)) for _ in range(12)]
    assert losses[-1] < losses[0] - 0.3, losses


def test_tiled_model_loss_matches_dense_model():
    """Tiling reshapes the same math: bf16 engines, tiled within JAX's
    2e-3 of the untiled one from the same seed."""
    outs = {}
    for tiled in (False, True):
        eng = _engine(dict(TINY, max_seq_len=32,
                           tiled_logits=4 if tiled else 0,
                           tiled_mlp=4 if tiled else 0,
                           attn_chunks=4 if tiled else 0),
                      micro=2, stage=2, dtype=torch.bfloat16)
        rng = np.random.default_rng(9)
        it = _cycle([{"input_ids": rng.integers(0, 64, (2, 32)).astype(
            np.int32)} for _ in range(2)])
        outs[tiled] = [float(eng.train_batch(it)) for _ in range(3)]
    np.testing.assert_allclose(outs[True], outs[False], rtol=2e-3)


def test_fpdt_host_residual_matches_standard():
    """The residual stream as host chunks: loss within 2e-5 and gradients
    within 2e-3 of the host-KV path (JAX's bounds); a tiny model trains."""
    cfgs = {h: tf.TransformerConfig(dtype=torch.float32, **dict(
        BASE, max_seq_len=48, attn_chunks=4, fpdt_host_kv=True,
        fpdt_host_residual=h)) for h in (False, True)}
    jparams = jax_tf.TransformerLM(jax_tf.TransformerConfig(
        dtype=jnp.float32, **dict(BASE, max_seq_len=48))).init(
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    batch = {"input_ids": rng.integers(0, 64, (2, 45)).astype(np.int32)}
    l_std, _, g_std = _port_grads(cfgs[False], jparams, batch)
    l_host, _, g_host = _port_grads(cfgs[True], jparams, batch)
    assert abs(l_std - l_host) < 2e-5
    assert max(np.abs(g_std[p] - g_host[p]).max() for p in g_std) < 2e-3
    eng = _engine(dict(BASE, max_seq_len=48, attn_chunks=4,
                       fpdt_host_kv=True, fpdt_host_residual=True))
    it = _cycle([{"input_ids": rng.integers(0, 64, (1, 48)).astype(
        np.int32)}])
    losses = [float(eng.train_batch(it)) for _ in range(6)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 0.2, losses


def test_hosted_layer_keeps_the_residual_on_the_host():
    cfg = tf.TransformerConfig(dtype=torch.float32, **dict(
        BASE, attn_chunks=4, fpdt_host_kv=True, fpdt_host_residual=True))
    from deepspeed_tpu_torch.models import zoo

    model = zoo.get_model("tiny", device="cpu", dtype=torch.float32,
                          **dict(BASE, attn_chunks=4))
    tokens = torch.zeros((2, 45), dtype=torch.long)
    chunks, S, C = tf.apply_hidden_hosted(
        dataclasses.replace(cfg), model.params(), tokens)
    assert (len(chunks), S, C) == (4, 45, 12)
    assert all(c.shape == (2, 12, 32) and c.device.type == "cpu"
               for c in chunks)
