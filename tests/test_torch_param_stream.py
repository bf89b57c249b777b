"""ZeRO-Infinity parameter streaming in the port (``runtime/param_stream``,
the engine's ``offload_param``) against JAX's
(``tests/test_param_prefetch_ring.py`` and ``tests/test_offload.py``
:375-560 contracts).

The streamer: bit-identical to the plain loop over the stack, forward
and gradients, at every prefetch depth, with the gradients landed in
the host buffers (JAX asserts the same against its scan), under
an outer recompute too; its output equals JAX's streamer on the same
numpy stack. The engine: the stack lives on the host (in the compute
dtype), trains, follows the plain offload engine bit for bit on the CPU
(the same host optimizer on the same gradients) and JAX's offload_param
engine (fp32 losses rtol 1e-5, masters atol 1e-4,
``tests/test_torch_offload.py``'s), needs the host optimizer tier,
falls back from ZenFlow to the blocking step, carries the performance
block's knobs, and round-trips a checkpoint. The protocol: a model of
its own declares ``host_param_paths`` and streams them with
``scan_streamed``; the MoE model streams its expert stack.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as dstpu
import deepspeed_tpu_torch
from deepspeed_tpu.models.transformer import TransformerConfig as JaxConfig
from deepspeed_tpu.models.transformer import TransformerLM as JaxLM
from deepspeed_tpu.runtime.param_stream import \
    streamed_layers_prefetch as jax_streamed
from deepspeed_tpu_torch.models import zoo
from deepspeed_tpu_torch.models.convert import (params_from_jax,
                                                params_to_numpy)
from deepspeed_tpu_torch.models.transformer import TransformerConfig
from deepspeed_tpu_torch.runtime import param_stream as ps
from deepspeed_tpu_torch.runtime.optimizer import leaves
from deepspeed_tpu_torch.utils import memspace

L, B, H = 5, 2, 8
TINY = dict(vocab_size=64, hidden_size=32, num_layers=3, num_heads=4,
            max_seq_len=32, pos_emb="learned", norm="layernorm",
            activation="gelu", tie_embeddings=True, remat=False,
            attn_impl="xla")


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np_stack(seed=0):
    rng = np.random.default_rng(seed)
    return ({"w": (rng.standard_normal((L, H, H)) / np.sqrt(H)).astype(
        np.float32), "b": (0.01 * rng.standard_normal((L, H))).astype(
        np.float32)}, rng.standard_normal((B, H)).astype(np.float32))


def _stack(dtype, grad=True):
    s, x = _np_stack()
    st = {k: torch.from_numpy(v).to(dtype).requires_grad_(grad)
          for k, v in s.items()}
    return st, torch.from_numpy(x).to(dtype).requires_grad_(grad)


def _layer(x, p, scale=1.0):
    return torch.tanh(x @ p["w"] + p["b"]) * scale


def _loop(stack, x):
    for i in range(L):
        x = _layer(x, {k: v[i] for k, v in stack.items()})
    return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("depth", [1, 2, 4])
def test_forward_bit_identical_to_the_loop(dtype, depth):
    stack, x = _stack(dtype, grad=False)
    ref = _loop(stack, x)
    got = ps.streamed_layers_prefetch(_layer, stack, x, prefetch_depth=depth)
    assert got.dtype == ref.dtype and torch.equal(got, ref)


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_grads_bit_identical_to_the_loop(depth):
    stack, x = _stack(torch.float32)
    (_loop(stack, x) ** 2).sum().backward()
    ref = {k: v.grad.clone() for k, v in stack.items()}, x.grad.clone()
    stack2, x2 = _stack(torch.float32)
    y = ps.streamed_layers_prefetch(_layer, stack2, x2, prefetch_depth=depth)
    (y ** 2).sum().backward()
    assert torch.equal(x2.grad, ref[1])
    for k in ("w", "b"):
        # the stack's gradient lands in its fp32 host buffer, not .grad
        assert stack2[k].grad is None
        assert torch.equal(ps.host_grad(stack2[k]), ref[0][k]), k


def test_outer_recompute_composes_with_the_stream():
    """An outer checkpoint over the streamed region replays its forward;
    the replayed fetches give the same gradients."""
    stack, x = _stack(torch.float32)
    (ps.streamed_layers_prefetch(_layer, stack, x, prefetch_depth=2) ** 2) \
        .sum().backward()
    stack2, x2 = _stack(torch.float32)
    y = torch.utils.checkpoint.checkpoint(
        lambda s, xx: ps.streamed_layers_prefetch(
            _layer, {"w": s[0], "b": s[1]}, xx, prefetch_depth=2),
        (stack2["w"], stack2["b"]), x2, use_reentrant=False)
    (y ** 2).sum().backward()
    for k in ("w", "b"):
        assert torch.equal(ps.host_grad(stack2[k]), ps.host_grad(stack[k]))


def test_depths_agree_with_each_other_bf16():
    stack, x = _stack(torch.bfloat16, grad=False)
    outs = [ps.streamed_layers_prefetch(_layer, stack, x, prefetch_depth=d)
            for d in (1, 2, 4)]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


def test_streamer_matches_jax_and_counts_its_fetches():
    s, xn = _np_stack()
    stack, x = _stack(torch.float32)
    ps.reset_fetch_stats()
    y = ps.streamed_layers_prefetch(_layer, stack, x, prefetch_depth=2,
                                    extra=())
    (y ** 2).sum().backward()
    want = jax_streamed(lambda c, p: jnp.tanh(c @ p["w"] + p["b"]), s, xn,
                        prefetch_depth=2)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    gw = jax.grad(lambda st: jnp.sum(jax_streamed(
        lambda c, p: jnp.tanh(c @ p["w"] + p["b"]), st, xn,
        prefetch_depth=2) ** 2))(s)
    np.testing.assert_allclose(ps.host_grad(stack["w"]).numpy(),
                               np.asarray(gw["w"]), rtol=1e-5, atol=1e-6)
    # every layer once in the forward and once in the backward
    per_layer = (H * H + H) * 4
    assert ps.FETCH_STATS == {"layers": 2 * L, "bytes": 2 * L * per_layer}


def test_scan_streamed_and_fetch_slice_match_the_loop():
    stack, x = _stack(torch.float32)
    (ps.scan_streamed(lambda c, p: _layer(c, p), x, stack, device="cpu")
     ** 2).sum().backward()
    stack2, x2 = _stack(torch.float32)
    (_loop(stack2, x2) ** 2).sum().backward()
    for k in ("w", "b"):
        assert torch.equal(ps.host_grad(stack[k]), stack2[k].grad)
    # a second backward in the window adds on the host, in fp32
    (ps.scan_streamed(lambda c, p: _layer(c, p), x.detach(), stack,
                      device="cpu") ** 2).sum().backward()
    assert torch.equal(ps.host_grad(stack["w"]), 2 * stack2["w"].grad)
    ps.clear_host_grad(stack["w"])
    assert ps.host_grad(stack["w"]) is None
    got = ps.fetch_slice({k: v.detach() for k, v in stack.items()}, 3, "cpu")
    assert torch.equal(got["w"], stack["w"][3].detach())
    assert ps.pin_stage(1, 2) == (1, 2)


def test_pin_to_host_copies_in_the_compute_dtype():
    t = torch.randn(3, 4)
    out = ps.pin_to_host({"a": t}, torch.bfloat16)["a"]
    assert out.dtype == torch.bfloat16 and out.device.type == "cpu"
    assert out.data_ptr() != t.data_ptr()
    assert torch.equal(out, t.to(torch.bfloat16))


# -- the engine ---------------------------------------------------------------


def _cfg(param=True, gas=1, dtype="fp32", extra=None, off="cpu", micro=2):
    z = {"stage": 2, "offload_optimizer": {"device": off}}
    if param:
        z["offload_param"] = {"device": "cpu"}
    cfg = {"train_micro_batch_size_per_chip": micro,
           "gradient_accumulation_steps": gas,
           "optimizer": {"type": "adamw", "params": {"lr": 1e-2}},
           "gradient_clipping": 1.0, "steps_per_print": 100,
           "bf16": {"enabled": dtype == "bf16"}, "zero_optimization": z}
    cfg.update(extra or {})
    return cfg


def _engine(param=True, seed=0, model=None, **kw):
    if model is None:
        model = zoo.get_model("tiny", device="cpu", seed=seed,
                              dtype=torch.float32, **TINY)
    return deepspeed_tpu_torch.initialize(model=model,
                                          config=_cfg(param, **kw),
                                          device="cpu")[0]


def data_iter(batch, seq=17, seed=0, n_fixed=2):
    rng = np.random.default_rng(seed)
    fixed = [{"input_ids": rng.integers(0, 64, (batch, seq)).astype(np.int32)}
             for _ in range(n_fixed)]
    i = 0
    while True:
        yield fixed[i % n_fixed]
        i += 1


def _kinds(tree):
    return {memspace.memory_kind_of(t) for _, t in leaves(tree)}


def test_param_offload_trains_and_stays_on_the_host():
    eng = _engine()
    assert eng.model_config.param_host_offload
    assert _kinds(eng.params["layers"]) == {"unpinned_host"}  # no CUDA here
    assert all(t.device.type == "cpu" and t.requires_grad
               for _, t in leaves(eng.params["layers"]))
    ps.reset_fetch_stats()
    it = data_iter(eng.micro_batch_size)
    losses = [float(eng.train_batch(it)) for _ in range(8)]
    assert losses[-1] < losses[0] - 0.3, losses
    assert ps.FETCH_STATS["layers"] == 8 * 2 * 3  # fwd + bwd, 3 layers
    assert _kinds(eng.params["layers"]) == {"unpinned_host"}


@pytest.mark.parametrize("gas", [1, 2])
@pytest.mark.parametrize("extra", [
    None, {"performance": {"param_prefetch_depth": 1}}])
def test_param_offload_is_bit_equal_to_plain_offload(gas, extra):
    """On the CPU both engines run the same host optimizer on the same
    gradients: equal losses and masters (JAX holds the two within 3e-3,
    test_param_offload_matches_plain_offload)."""
    a = _engine(param=False, gas=gas, extra=extra)
    b = _engine(param=True, gas=gas, extra=extra)
    it_a, it_b = data_iter(2, seed=5), data_iter(2, seed=5)
    la = [float(a.train_batch(it_a)) for _ in range(4)]
    lb = [float(b.train_batch(it_b)) for _ in range(4)]
    assert la == lb
    for p in a._offload.optimizers:
        assert torch.equal(a._offload.full_fp32_param(p),
                           b._offload.full_fp32_param(p)), p


def test_param_offload_follows_the_jax_infinity_engine():
    """GAS 1: JAX's offload_param engine fails at GAS 2 on the CPU mesh
    (a host / device memory-kind assertion in its step), so it is no
    oracle there; the port's GAS 2 is held to its plain offload engine
    above. Masters at atol 8 lr: an Adam step moves an element by about
    lr at most, and near-zero gradients part the two frameworks' steps
    (``tests/test_torch_offload.py``)."""
    cfg = _cfg(True)
    jeng, *_ = dstpu.initialize(
        model=JaxLM(JaxConfig(dtype=jnp.float32, **TINY)), config=dict(cfg))
    flat, _ = jax.tree_util.tree_flatten_with_path(jeng.params)
    masters = {}
    for kp, _ in flat:
        node = masters
        keys = [k.key for k in kp]
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = np.asarray(jeng._offload.full_fp32_param(
            jax.tree_util.keystr(kp)))
    pcfg = dict(cfg, train_batch_size=jeng.train_batch_size)
    del pcfg["train_micro_batch_size_per_chip"]
    model = params_from_jax(masters, TransformerConfig(
        dtype=torch.float32, **TINY), device="cpu")
    eng = deepspeed_tpu_torch.initialize(model=model, config=pcfg,
                                         device="cpu")[0]
    rows = jeng.micro_batch_size * jeng.dp_world_size
    jit, pit = data_iter(rows, seed=5), data_iter(rows, seed=5)
    want = [float(jeng.train_batch(jit)) for _ in range(4)]
    got = [float(eng.train_batch(pit)) for _ in range(4)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for kp, _ in flat:
        path = "/" + "/".join(k.key for k in kp)
        np.testing.assert_allclose(
            eng._offload.full_fp32_param(path).numpy(),
            np.asarray(jeng._offload.full_fp32_param(
                jax.tree_util.keystr(kp))), atol=8 * 1e-2, err_msg=path)


def test_param_offload_requires_offload_optimizer():
    cfg = _cfg(True)
    cfg["zero_optimization"] = {"stage": 2,
                                "offload_param": {"device": "cpu"}}
    model = zoo.get_model("tiny", device="cpu", seed=0, dtype=torch.float32,
                          **TINY)
    with pytest.raises(ValueError, match="offload_param requires"):
        deepspeed_tpu_torch.initialize(model=model, config=cfg,
                                       device="cpu")
    with pytest.raises(ValueError, match="requires offload_optimizer"):
        dstpu.initialize(model=JaxLM(JaxConfig(**TINY)), config=cfg)


def test_zenflow_falls_back_to_the_blocking_step(caplog):
    extra = {"zero_optimization": {
        "stage": 2, "offload_optimizer": {"device": "cpu"},
        "offload_param": {"device": "cpu"},
        "zenflow": {"topk_ratio": 0.1}}}
    with caplog.at_level(logging.WARNING):
        eng = _engine(extra=extra)
    assert eng._zenflow is None and eng._offload is not None
    assert "zenflow does not compose with offload_param" in caplog.text
    assert np.isfinite(float(eng.train_batch(data_iter(2))))


def test_nvme_placement_warns_and_holds_the_stack_in_host_memory(caplog):
    extra = {"zero_optimization": {
        "stage": 2, "offload_optimizer": {"device": "cpu"},
        "offload_param": {"device": "nvme", "nvme_path": "/unused"}}}
    with caplog.at_level(logging.WARNING):
        eng = _engine(extra=extra)
    assert "held in pinned host RAM" in caplog.text
    assert all(t.device.type == "cpu"
               for _, t in leaves(eng.params["layers"]))


def test_performance_knobs_reach_the_model_config():
    """performance.param_prefetch_depth overrides the model's prefetch
    depth (JAX engine.py:223-246); overlap_depth reaches the model's
    config too and places nothing on one card (it acts under a ZeRO-3
    fetch over fsdp ranks: tests/test_torch_host_tiers.py)."""
    eng = _engine(extra={"performance": {"param_prefetch_depth": 3,
                                         "overlap_depth": 1}})
    assert eng.model_config.prefetch_depth == 3
    assert eng.config.performance.overlap_depth == 1
    assert eng.model_config.overlap_depth == 1
    ps.reset_fetch_stats()
    eng.train_batch(data_iter(2, seed=3))
    assert ps.RESIDENT_STATS["gathers"] == 0
    assert _engine().model_config.prefetch_depth == 2
    jeng, *_ = dstpu.initialize(
        model=JaxLM(JaxConfig(**dict(TINY, param_host_offload=True))),
        config={"train_micro_batch_size_per_chip": 1,
                "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
                "performance": {"param_prefetch_depth": 3}})
    assert jeng.module.config.prefetch_depth == 3


def test_the_serialized_mode_trains_the_same():
    a = _engine()
    b = _engine()
    b.model_config = b.model_config.__class__(**{
        **b.model_config.__dict__, "serialize_fetch": True})
    it_a, it_b = data_iter(2, seed=3), data_iter(2, seed=3)
    assert [float(a.train_batch(it_a)) for _ in range(3)] == \
        [float(b.train_batch(it_b)) for _ in range(3)]


def test_param_offload_checkpoint_roundtrip(tmp_path):
    eng = _engine()
    it = data_iter(eng.micro_batch_size)
    for _ in range(2):
        eng.train_batch(it)
    eng.save_checkpoint(str(tmp_path), tag="t")
    eng2 = _engine(seed=1)
    eng2.load_checkpoint(str(tmp_path), tag="t")
    assert all(t.device.type == "cpu"
               for _, t in leaves(eng2.params["layers"]))
    for (_, a), (_, b) in zip(leaves(eng.params), leaves(eng2.params)):
        assert torch.equal(a, b)
    batch = next(data_iter(eng.micro_batch_size))
    assert float(eng.eval_batch(batch)) == float(eng2.eval_batch(batch))
    nxt = next(it)
    assert float(eng.train_batch(iter([nxt]))) == \
        float(eng2.train_batch(iter([nxt])))


class _StackedMLP:
    """A model of its own on the protocol: ``host_param_paths`` names its
    stacked subtree, and ``loss`` streams it with ``scan_streamed`` when
    the engine turns ``param_host_offload`` on (JAX
    tests/test_offload.py::_StackedMLP)."""

    host_param_paths = ("blocks",)
    param_host_offload = False
    config = None
    L, H, V = 3, 16, 64

    def __init__(self, seed=0):
        g = torch.Generator().manual_seed(seed)
        self._params = {
            "emb": torch.randn(self.V, self.H, generator=g) * 0.1,
            "blocks": {"w": torch.randn(self.L, self.H, self.H,
                                        generator=g) * 0.1,
                       "b": torch.zeros(self.L, self.H)},
            "head": torch.randn(self.H, self.V, generator=g) * 0.1}
        self.device = torch.device("cpu")

    def params(self):
        return self._params

    def loss(self, params, batch):
        tokens = batch["input_ids"].long()
        inputs, labels = tokens[:, :-1], tokens[:, 1:]
        x = params["emb"][inputs]

        def body(x, blk):
            return torch.tanh(x @ blk["w"].to(x.dtype) + blk["b"].to(x.dtype))

        if self.param_host_offload:
            x = ps.scan_streamed(body, x, params["blocks"])
        else:
            for i in range(self.L):
                x = body(x, {k: v[i] for k, v in params["blocks"].items()})
        logits = (x @ params["head"]).float()
        nll = torch.logsumexp(logits, -1) - torch.gather(
            logits, -1, labels[..., None])[..., 0]
        loss = nll.mean()
        return loss, {"loss": loss,
                      "ntokens": torch.tensor(float(labels.numel()))}


def test_offload_param_protocol_custom_model():
    model = _StackedMLP()
    w0 = model.params()["blocks"]["w"].clone()
    eng = deepspeed_tpu_torch.initialize(
        model=model, config=_cfg(True, extra={
            "optimizer": {"type": "adamw", "params": {"lr": 3e-2}}}),
        device="cpu")[0]
    assert model.param_host_offload is True
    assert all(t.device.type == "cpu" and t is not model.params()[
        "blocks"][k] for k, t in eng.params["blocks"].items())
    ps.reset_fetch_stats()
    it = data_iter(2, n_fixed=1)
    losses = [float(eng.train_batch(it)) for _ in range(16)]
    assert losses[-1] < losses[0] - 0.1, losses
    assert ps.FETCH_STATS["layers"] == 16 * 2 * model.L
    # the streamed blocks moved: their grads reached the host optimizer
    assert not torch.allclose(eng.params["blocks"]["w"].float(), w0)


def test_param_offload_moe_model():
    """The expert stack (the bulk of an MoE model) streams from the host
    too, and the MoE engine trains."""
    model = zoo.get_model("tiny-moe", device="cpu", dtype=torch.float32,
                          seed=0, num_layers=2, hidden_size=32,
                          num_heads=4, vocab_size=256, attn_impl="xla")
    eng = deepspeed_tpu_torch.initialize(model=model, config=_cfg(True),
                                         device="cpu")[0]
    assert eng.model_config.param_host_offload
    assert all(t.device.type == "cpu"
               for _, t in leaves(eng.params["layers"]["moe"]))
    ps.reset_fetch_stats()
    rng = np.random.default_rng(0)
    fixed = {"input_ids": rng.integers(0, 256, (2, 17)).astype(np.int32)}
    losses = [float(eng.train_batch(iter([fixed]))) for _ in range(6)]
    assert losses[-1] < losses[0] - 0.2, losses
    assert ps.FETCH_STATS["layers"] == 6 * 2 * 2  # a fetch and a refetch
