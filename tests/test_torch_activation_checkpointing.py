"""The port's activation checkpointing (``runtime/activation_checkpointing``)
against JAX's (``tests/test_activation_checkpointing.py`` contracts).

Functions: ``checkpoint_wrapper`` under each policy gives the plain
function's value and gradients (JAX's rtol 1e-6 / 1e-5), on the same
numpy inputs as JAX's wrapper. The model: ``loss_fn`` and every gradient
leaf under every policy against JAX's ``loss_fn`` with the same
``remat_policy`` (fp32, weights from ``params_from_jax``; loss rtol 1e-5,
gradients atol 1e-4, ``tests/test_torch_transformer_train.py``'s), and
the policies against each other bit for bit. What each policy keeps is
counted: the flash forwards launched again in the recompute and the
matmuls the backward recomputes. The engine configures the module from
its ``activation_checkpointing`` block, as JAX's does, pins its own
policy, and trains under a named policy as JAX's engine does.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import deepspeed_tpu as dstpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as jax_tf
from deepspeed_tpu.runtime import activation_checkpointing as jac
from deepspeed_tpu_torch.config.config import (ActivationCheckpointingConfig,
                                               load_config)
from deepspeed_tpu_torch.models import transformer as tf
from deepspeed_tpu_torch.models import zoo
from deepspeed_tpu_torch.models.convert import (params_from_jax,
                                                params_to_numpy)
from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.parallel import topology
from deepspeed_tpu_torch.runtime import activation_checkpointing as ac

POLICIES = sorted(ac.POLICIES)
LLAMA = dict(vocab_size=64, hidden_size=64, num_layers=2, num_heads=4,
             num_kv_heads=2, max_seq_len=32, pos_emb="rope", norm="rmsnorm",
             activation="swiglu", tie_embeddings=False, remat=True,
             attn_impl="flash")
GPT = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
           max_seq_len=32, pos_emb="learned", norm="layernorm",
           activation="gelu", tie_embeddings=True, remat=True,
           attn_impl="xla", use_biases=True)
LOSS_RTOL, GRAD_ATOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _reset_config():
    ac._GLOBAL_CONFIG.clear()
    jac._GLOBAL_CONFIG.clear()
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    ac._GLOBAL_CONFIG.clear()
    jac._GLOBAL_CONFIG.clear()
    topology.set_global_mesh(None)
    torch.set_num_threads(prev)


def _xw(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((4, 8)).astype(np.float32),
            rng.standard_normal((8, 8)).astype(np.float32))


def f_t(x, w):
    return torch.tanh(x @ w) @ w.t()


def f_j(x, w):
    return jnp.tanh(x @ w) @ w.T


@pytest.mark.parametrize("policy", POLICIES)
def test_checkpoint_matches_plain_and_jax(policy):
    x, w = _xw()
    wrapped = ac.checkpoint_wrapper(f_t, policy=policy)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w)
    out = wrapped(xt, wt)
    np.testing.assert_allclose(out.detach().numpy(),
                               f_t(xt, wt).detach().numpy(), rtol=1e-6)
    (g,) = torch.autograd.grad(out.sum(), [xt])
    (g_plain,) = torch.autograd.grad(f_t(xt, wt).sum(), [xt])
    np.testing.assert_allclose(g.numpy(), g_plain.numpy(), rtol=1e-5)
    # against JAX's wrapper: two frameworks' tanh, GRAD_ATOL
    want = jax.grad(lambda a: jac.checkpoint_wrapper(
        f_j, policy=policy)(a, jnp.asarray(w)).sum())(jnp.asarray(x))
    np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=0,
                               atol=GRAD_ATOL)
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(f_j(x, w)), rtol=1e-5, atol=1e-5)


def test_direct_call_form():
    x, w = _xw(1)
    out = ac.checkpoint(f_t, torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(jac.checkpoint(f_j, x, w)),
                               rtol=1e-5, atol=1e-5)


def test_configure_from_config_model(caplog):
    block = load_config({"activation_checkpointing": {
        "partition_activations": True, "policy": "dots_saveable",
        "contiguous_memory_optimization": True}}).activation_checkpointing
    assert isinstance(block, ActivationCheckpointingConfig)
    with caplog.at_level("INFO"):
        state = ac.configure(block)
    assert state == {"partition_activations": True,
                     "cpu_checkpointing": False, "policy": "dots_saveable"}
    assert ac.is_configured()
    assert "contiguous_memory_optimization" in caplog.text
    assert state == jac.configure(block)


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="unknown activation"):
        ac.resolve_policy("bogus")


@pytest.mark.parametrize("cpu", [False, True])
@pytest.mark.parametrize("name", POLICIES)
def test_resolve_policy_kinds_match_jax(name, cpu):
    """Each name resolves to the same kind as in JAX: save nothing (None),
    no remat ("everything") or a policy; the cpu request offloads."""
    got, want = (ac.resolve_policy(name, cpu_checkpointing=cpu),
                 jac.resolve_policy(name, cpu_checkpointing=cpu))
    assert (got is None) == (want is None)
    assert (got == "everything") == (isinstance(want, str)
                                     and want == "everything")
    if isinstance(got, ac.SavePolicy):
        assert got.offload == (cpu or name == "offload_dots_host")


def test_cpu_checkpointing_selects_offload():
    ac.configure(cpu_checkpointing=True)
    p = ac.resolve_policy()
    assert isinstance(p, ac.SavePolicy) and p.offload and p.dots


def _model(kind, policy):
    over = dict(LLAMA if kind == "llama" else GPT, remat_policy=policy)
    jcfg = jax_tf.TransformerConfig(dtype=jnp.float32, **over)
    return jax_tf.TransformerLM(jcfg), tf.TransformerConfig(
        dtype=torch.float32, **over)


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


def _port_loss(cfg, jparams, batch):
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    params = _copies(model.params())
    loss, _ = tf.loss_fn(cfg, params, {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
    loss.backward()
    return loss.item(), {p: t.grad.numpy() for p, t in _flat(params)}


@pytest.mark.parametrize("kind", ["llama", "gpt"])
@pytest.mark.parametrize("policy", POLICIES)
def test_loss_and_gradients_match_jax_under_each_policy(kind, policy):
    jmodel, cfg = _model(kind, policy)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    batch = {"input_ids": np.random.default_rng(3).integers(
        0, 64, (2, 17)).astype(np.int32)}
    (want, _), wgrads = jax.value_and_grad(
        lambda p: jax_tf.loss_fn(jmodel.config, p, {
            k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jparams)
    got, grads = _port_loss(cfg, jparams, batch)
    np.testing.assert_allclose(got, float(want), rtol=LOSS_RTOL)
    wflat = dict(_flat(jax.tree.map(np.asarray, wgrads)))
    assert sorted(grads) == sorted(wflat)
    for path in wflat:
        np.testing.assert_allclose(grads[path], wflat[path], atol=GRAD_ATOL,
                                   rtol=0, err_msg=path)


@pytest.mark.parametrize("kind", ["llama", "gpt"])
def test_policies_are_bit_equal_to_each_other(kind):
    jmodel, _ = _model(kind, None)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    batch = {"input_ids": np.random.default_rng(4).integers(
        0, 64, (2, 17)).astype(np.int32)}
    runs = {p: _port_loss(_model(kind, p)[1], jparams, batch)
            for p in POLICIES}
    ref = runs["nothing_saveable"]
    for p, (loss, grads) in runs.items():
        assert loss == ref[0], p
        assert all(np.array_equal(grads[k], ref[1][k]) for k in grads), p


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.mm += 1
        return func(*args, **(kwargs or {}))


# policy -> (flash forwards, matmuls the backward runs) for LLAMA at 2
# layers: 30 gradient matmuls, and per layer the recompute's: 6 under
# nothing_saveable (q, k, v, wo, gate, up: the output projection's result
# is never unpacked, the recompute stops early), 3 when qkv_proj is kept,
# 5 when attn_out is, 2 when both are
WANT_COUNTS = {"nothing_saveable": (4, 42), "dots_saveable": (4, 30),
               "dots_with_no_batch_dims_saveable": (4, 30),
               "offload_dots_host": (4, 30), "save_qkv_proj": (4, 36),
               "save_attn_out": (4, 40), "save_qkv_attn_out": (2, 34),
               "save_attn_mlp": (2, 34), "none": (2, 30),
               "everything": (2, 30)}


@pytest.mark.parametrize("policy", POLICIES)
def test_each_policy_keeps_what_it_names(policy, monkeypatch):
    calls = []
    orig = fa._flash_fwd
    monkeypatch.setattr(fa, "_flash_fwd",
                        lambda *a: calls.append(1) or orig(*a))
    _, cfg = _model("llama", policy)
    model = zoo.get_model("tiny", device="cpu", dtype=torch.float32,
                          seed=0, **{k: v for k, v in LLAMA.items()})
    params = _copies(model.params())
    loss, _ = tf.loss_fn(cfg, params, {"input_ids": torch.randint(
        0, 64, (2, 17), generator=torch.Generator().manual_seed(0))})
    count = _CountMM()
    with count:
        loss.backward()
    assert (len(calls), count.mm) == WANT_COUNTS[policy]


def test_offload_policy_keeps_saves_on_the_host(monkeypatch):
    """offload_dots_host routes each kept output through the copy helpers
    (down in the forward, up in the recompute)."""
    from deepspeed_tpu_torch.utils import memspace

    moved = {"down": 0, "up": 0}
    down, up = memspace.offload, memspace.fetch
    monkeypatch.setattr(memspace, "offload", lambda *a, **k: (
        moved.__setitem__("down", moved["down"] + 1) or down(*a, **k)))
    monkeypatch.setattr(memspace, "fetch", lambda *a, **k: (
        moved.__setitem__("up", moved["up"] + 1) or up(*a, **k)))
    x, w = _xw(2)
    wt = torch.from_numpy(w).requires_grad_()
    out = ac.checkpoint_wrapper(f_t, policy="offload_dots_host")(
        torch.from_numpy(x), wt)
    out.sum().backward()
    ref = torch.from_numpy(w).requires_grad_()
    f_t(torch.from_numpy(x), ref).sum().backward()
    assert torch.equal(wt.grad, ref.grad)
    assert moved["down"] == 2 and moved["up"] >= 1


def test_a_recompute_that_differs_raises():
    state = {"n": 0}

    def flaky(x, w):
        state["n"] += 1
        return torch.tanh(x @ w) if state["n"] == 1 else torch.sin(x) @ w

    x, w = _xw(3)
    out = ac.checkpoint_wrapper(flaky, policy="dots_saveable")(
        torch.from_numpy(x).requires_grad_(), torch.from_numpy(w))
    with pytest.raises(RuntimeError, match="nondeterministic"):
        out.sum().backward()


def test_saved_call_and_names_outside_a_checkpoint_are_plain():
    """Outside a checkpointed call a name is a no-op and the flash
    forward's operator is the wrapper's plain call."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 8, h, 64)).astype(
        np.float32)) for h in (2, 1, 1))
    with ac.checkpoint_name("qkv_proj"):
        got = fa.FLASH_FWD_OP(q, k, v, None, True, 0.125)
    want = fa._flash_fwd(q, k, v, None, True, 0.125)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("policy, cpu, model_policy, want", [
    ("nothing_saveable", False, None, ac.SAVE_NOTHING),
    ("nothing_saveable", True, None,
     ac.SavePolicy(dots="no_batch", offload=True)),
    ("save_attn_out", True, None,
     ac.SavePolicy(names=("attn_out",), offload=True)),
    ("dots_saveable", False, "save_qkv_proj",
     ac.SavePolicy(names=("qkv_proj",))),
    ("none", True, None, "everything")])
def test_engine_policy_reads_its_own_block_alone(policy, cpu, model_policy,
                                                 want):
    """engine_policy resolves from the block and the model's name alone,
    whatever the module-level settings say; resolve_policy hands the
    pinned value back unchanged (a full recompute as None)."""
    ac.configure(policy="dots_saveable", cpu_checkpointing=not cpu)
    block = ActivationCheckpointingConfig(policy=policy,
                                          cpu_checkpointing=cpu)
    got = ac.engine_policy(block, model_policy)
    assert got == want
    assert ac.resolve_policy(got) == (None if want == ac.SAVE_NOTHING
                                      else want)


def test_each_engine_keeps_its_own_policy(monkeypatch):
    """An engine pins its block's policy and cpu_checkpointing at build:
    a second engine built with others leaves the first one's saves as
    they were (JAX's compiled step keeps the policy it was traced
    with)."""
    calls = []
    orig = fa._flash_fwd
    monkeypatch.setattr(fa, "_flash_fwd",
                        lambda *a: calls.append(1) or orig(*a))

    def build(policy, **block):
        cfg = _engine_cfg(policy)
        cfg["activation_checkpointing"].update(block)
        model = zoo.get_model("tiny", device="cpu", dtype=torch.float32,
                              seed=0, **LLAMA)
        return deepspeed_tpu_torch.initialize(model=model, config=cfg,
                                              device="cpu")[0]

    a = build("save_attn_mlp")
    b = build("nothing_saveable", cpu_checkpointing=True)
    assert ac._GLOBAL_CONFIG["policy"] == "nothing_saveable"
    assert a.model_config.remat_policy == ac.SavePolicy(
        names=("qkv_proj", "attn_kernel_out", "attn_out", "mlp_out"))
    assert b.model_config.remat_policy == ac.SavePolicy(dots="no_batch",
                                                        offload=True)
    # micro 2 x GAS 2 through 2 layers: a flash forward a layer and
    # microbatch where the policy keeps its output, two where not
    for eng, want in ((a, 4), (b, 8), (a, 4)):
        calls.clear()
        assert np.isfinite(float(eng.train_batch(_stream(2))))
        assert len(calls) == want


def test_partition_activations_identity_at_tp1_and_raises_beyond():
    """The identity at tp 1 (JAX's ``_partition_constraint``). On a tp
    mesh with no process group the tp collectives send nothing, so the
    wrapper is the identity there too; tests/test_torch_tp.py holds the
    partitioned gradients at tp 2 on gloo ranks."""
    ac.configure(partition_activations=True)
    x, w = _xw(4)
    out = ac.checkpoint_wrapper(f_t)(torch.from_numpy(x),
                                     torch.from_numpy(w))
    np.testing.assert_allclose(out.numpy(), np.asarray(f_j(x, w)),
                               rtol=1e-5, atol=1e-5)
    topology.set_global_mesh(types.SimpleNamespace(
        shape={"tp": 2}, issues=lambda axis: False))
    out2 = ac.checkpoint_wrapper(f_t)(torch.from_numpy(x),
                                      torch.from_numpy(w))
    assert torch.equal(out, out2)


def test_model_parallel_rng_differs_per_tp_rank():
    draws = []
    for rank in (0, 1, 0):
        topology.set_global_mesh(types.SimpleNamespace(
            shape={"tp": 2}, axis_index=lambda axis, r=rank: r))
        gen = ac.model_parallel_rng(1234)
        draws.append(torch.rand(4, generator=gen))
    assert torch.equal(draws[0], draws[2])
    assert not torch.equal(draws[0], draws[1])


def _engine_cfg(policy):
    return {"train_micro_batch_size_per_chip": 2,
            "gradient_accumulation_steps": 2,
            "optimizer": {"type": "adamw", "params": {"lr": 1e-2}},
            "zero_optimization": {"stage": 0}, "steps_per_print": 100,
            "bf16": {"enabled": False},
            "activation_checkpointing": {"policy": policy}}


def _stream(rows, seed=0):
    rng = np.random.default_rng(seed)
    fixed = [{"input_ids": rng.integers(0, 64, (rows, 17)).astype(np.int32)}
             for _ in range(2)]
    i = 0
    while True:
        yield fixed[i % 2]
        i += 1


@pytest.mark.parametrize("policy", ["save_qkv_attn_out", "dots_saveable"])
def test_engine_configures_the_policy_and_follows_jax(policy):
    """The engine's block reaches the module (JAX ``engine.py:168-170``)
    and the model's layers (``remat_policy`` None defers to it); 3 steps
    follow JAX's engine at fp32."""
    # GPT without biases: the key bias's exact gradient is 0, and Adam
    # scales the two frameworks' rounding noise there up to lr
    gpt = dict(GPT, use_biases=False)
    jcfg = jax_tf.TransformerConfig(dtype=jnp.float32, **gpt)
    jeng, *_ = dstpu.initialize(model=jax_tf.TransformerLM(jcfg),
                                config=_engine_cfg(policy))
    assert jac._GLOBAL_CONFIG["policy"] == policy
    jparams = jax.tree.map(np.asarray, jeng.opt_state.master)
    cfg = dict(_engine_cfg(policy), train_batch_size=jeng.train_batch_size)
    del cfg["train_micro_batch_size_per_chip"]
    model = params_from_jax(jparams, tf.TransformerConfig(
        dtype=torch.float32, **gpt), device="cpu")
    eng = deepspeed_tpu_torch.initialize(model=model, config=cfg,
                                         device="cpu")[0]
    assert ac._GLOBAL_CONFIG["policy"] == policy
    assert ac.resolve_policy(eng.model_config.remat_policy) == \
        ac.resolve_policy(policy)
    rows = jeng.micro_batch_size * jeng.dp_world_size
    it_j, it_p = _stream(rows), _stream(rows)
    want = [float(jeng.train_batch(it_j)) for _ in range(3)]
    got = [float(eng.train_batch(it_p)) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    masters = dict(_flat(params_to_numpy(eng.opt_state.master)))
    for path, w in _flat(jax.tree.map(np.asarray, jeng.opt_state.master)):
        np.testing.assert_allclose(masters[path], w, atol=GRAD_ATOL,
                                   err_msg=path)
