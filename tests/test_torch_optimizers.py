"""The engine's other optimizers and its remaining methods against the
JAX package's.

Optimizers: sgd, momentum, lion, adagrad, lamb, adafactor and muon
through the port's mixed-precision update, against optax 0.2.6 (and
JAX's own ``muon``) through the JAX ``apply_mixed_precision_update``, on
one seeded tree: stacked ``[L, ...]`` layer leaves (wq-, wo- and mlp-like,
the mlp ones factored by Adafactor, over 128 in both trailing dims), norm
scales and biases, an embedding under 128 on one side; the clip engaged
and a WarmupLR schedule; 5 steps, masters within rtol 1e-5 / atol 1e-6
(fp32 both sides, sums and products in other orders).

Muon's routing: ``is_matrix_path`` gives every leaf of the tiny (with and
without biases), GPT-2 and Llama trees JAX's label, the trees built from
configs without weights.

The engine: 4 steps of the port's device engine with lamb and muon follow
the JAX engine (fp32, losses at rtol 1e-5, masters at atol 1e-4, as
``tests/test_torch_engine.py``); ``set_lr``, ``zero_grad``, ``no_sync``,
``train`` / ``eval`` and the post-step hooks behave as JAX's.
"""

import copy
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as dstpu
import deepspeed_tpu_torch
from deepspeed_tpu.config import config as jax_config
from deepspeed_tpu.models import zoo as jzoo
from deepspeed_tpu.models.transformer import TransformerConfig as JaxConfig
from deepspeed_tpu.models.transformer import TransformerLM as JaxLM
from deepspeed_tpu.runtime import lr_schedules as jax_lr
from deepspeed_tpu.runtime import muon as jmuon
from deepspeed_tpu.runtime import optimizer as jax_opt
from deepspeed_tpu_torch.config import config as config_mod
from deepspeed_tpu_torch.models import transformer as tf
from deepspeed_tpu_torch.models import zoo
from deepspeed_tpu_torch.models.convert import (params_from_jax,
                                                params_to_numpy)
from deepspeed_tpu_torch.models.transformer import TransformerConfig
from deepspeed_tpu_torch.runtime import lr_schedules as lr
from deepspeed_tpu_torch.runtime import muon
from deepspeed_tpu_torch.runtime import optimizer as opt

TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            max_seq_len=32, pos_emb="learned", norm="layernorm",
            activation="gelu", tie_embeddings=True, remat=False,
            attn_impl="xla")
# stacked layer leaves (wq-like [L, h, nh, hd], wo-like [L, nh, hd, h],
# mlp [L, h, f] with both trailing dims >= 128: factored), norms, biases,
# an embedding with one dim under 128 (a full second moment), and a
# leaf outside the layers
SHAPES = {"layers": {"attn": {"wq": (2, 16, 4, 8), "wo": (2, 4, 8, 16),
                              "bq": (2, 4, 8)},
                     "mlp": {"wi": (2, 130, 160), "wo": (2, 160, 130)},
                     "ln1": {"scale": (2, 16), "bias": (2, 16)}},
          "embed": {"tokens": (200, 16)},
          "final_norm": {"scale": (16,)}}
OPTIMIZERS = {
    "sgd": {"lr": 0.05},
    "momentum": {"lr": 0.05, "betas": (0.8, 0.999)},
    "lion": {"lr": 3e-3, "weight_decay": 0.1},
    "adagrad": {"lr": 0.05},
    "lamb": {"lr": 2e-2, "weight_decay": 0.01},
    "adafactor": {"lr": 2e-2},
    "muon": {"lr": 2e-2, "weight_decay": 0.01},
}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _tree(rng, shapes, scale=1.0):
    return {k: (_tree(rng, v, scale) if isinstance(v, dict) else
                (rng.standard_normal(v) * scale).astype(np.float32))
            for k, v in shapes.items()}


def _flat(tree):
    return {p: np.asarray(v) for p, v in opt.leaves(tree)}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_update_follows_optax_over_five_steps(name):
    rng = np.random.default_rng(0)
    params = _tree(rng, SHAPES)
    ocfg = {"type": name, "params": dict(OPTIMIZERS[name])}
    scfg = {"type": "WarmupLR", "params": {"warmup_num_steps": 4}}
    base = OPTIMIZERS[name]["lr"]

    jcfg = jax_config.load_config({"optimizer": copy.deepcopy(ocfg),
                                   "scheduler": scfg})
    jtx, _ = jax_opt.get_base_optimizer(
        jcfg.optimizer, jax_lr.get_lr_schedule(jcfg.scheduler,
                                               base_lr=base))
    jstate = jax_opt.init_mixed_precision(jax.tree.map(jnp.asarray, params),
                                          jtx)
    cfg = config_mod.load_config({"optimizer": copy.deepcopy(ocfg),
                                  "scheduler": scfg})
    tx, got_base = opt.get_base_optimizer(
        cfg.optimizer, lr.get_lr_schedule(cfg.scheduler, base_lr=base))
    assert got_base == base
    state = opt.init_mixed_precision(
        opt.tree_map(lambda x: torch.from_numpy(x.copy()), params), tx)
    for _ in range(5):
        grads = _tree(rng, SHAPES, scale=0.1)  # the clip engages
        _, jstate, jnorm = jax_opt.apply_mixed_precision_update(
            jstate, jax.tree.map(jnp.asarray, grads), jtx, jnp.float32,
            grad_clip=1.0)
        norm = opt.apply_mixed_precision_update(
            state, opt.tree_map(torch.from_numpy, grads), tx, grad_clip=1.0)
        np.testing.assert_allclose(norm.item(), float(jnorm), rtol=1e-6)
        assert float(jnorm) > 1.0
    got, want = _flat(state.master), _flat(jstate.master)
    assert sorted(got) == sorted(want)
    moved = 0
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=1e-5,
                                   atol=1e-6, err_msg=path)
        moved += int((got[path] != _flat(params)[path]).sum())
    assert moved > 0 and state.count == 5


def test_optimizer_defaults_follow_jax():
    """The config's default betas (lion gets (0.9, 0.999)), eps 1e-8 and
    weight decay 0, and optax's own defaults beyond them."""
    def tx(name, **params):
        return opt.get_base_optimizer(config_mod.OptimizerConfig(
            type=name, params=params))[0]

    assert (tx("lion").b1, tx("lion").b2, tx("lion").weight_decay) == \
        (0.9, 0.999, 0.0)
    assert (tx("sgd").momentum, tx("momentum").momentum) == (0.0, 0.9)
    assert (tx("adagrad").eps, tx("adagrad").INITIAL_ACCUMULATOR) == \
        (1e-8, 0.1)
    assert (tx("lamb").eps, tx("lamb").weight_decay) == (1e-8, 0.0)
    a = tx("adafactor")
    assert (opt.MIN_DIM_TO_FACTOR, a.DECAY_RATE, a.CLIPPING_THRESHOLD,
            a.EPS) == (128, 0.8, 1.0, 1e-30)
    m = tx("muon", ns_steps=3, nesterov=False, adam_b1=0.8)
    assert (m.beta, m.ns_steps, m.nesterov, m.adam_b1, m.adam_b2,
            m.adam_eps, m.weight_decay) == (0.9, 3, False, 0.8, 0.999, 1e-8,
                                            0.0)
    assert opt.factored_dims((2, 130, 160)) == (1, 2)
    assert opt.factored_dims((200, 16)) is None
    assert opt.factored_dims((16,)) is None


def test_newton_schulz_and_matricize_match_jax():
    rng = np.random.default_rng(1)
    for shape in ((3, 24, 40), (2, 40, 24), (16, 16)):
        g = rng.standard_normal(shape).astype(np.float32)
        np.testing.assert_allclose(
            muon.newton_schulz(torch.from_numpy(g)).numpy(),
            np.asarray(jmuon.newton_schulz(jnp.asarray(g))),
            rtol=1e-4, atol=1e-5)
    for shape in ((2, 16, 4, 8), (2, 4, 8, 16), (2, 130, 160)):
        x = np.zeros(shape, np.float32)
        assert tuple(muon.matricize(torch.from_numpy(x)).shape) == \
            jmuon._matricize(jnp.asarray(x)).shape


@pytest.mark.parametrize("name,over", [
    ("tiny", {}), ("tiny", {"use_biases": True}), ("gpt2-125m", {}),
    ("llama3-8b", {})])
def test_muon_routing_labels_every_leaf_as_jax(name, over):
    shapes = jax.eval_shape(jzoo.get_model(name, **over).init,
                            jax.random.PRNGKey(0))
    want = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        path = "/" + "/".join(k.key for k in kp)
        want[path] = jmuon._is_matrix_path(jax.tree_util.keystr(kp),
                                           len(leaf.shape))
    got = {path: muon.is_matrix_path(path, len(spec[0]))
           for path, spec in opt.leaves(tf.param_shapes(
               zoo.get_config(name, **over)), )}
    assert got == want
    assert any(want.values()) and not all(want.values())


# -- the engine --------------------------------------------------------------------


def data_iter(batch, seq=17, seed=0, n_fixed=2):
    rng = np.random.default_rng(seed)
    fixed = [{"input_ids": rng.integers(0, 64, (batch, seq)).astype(np.int32)}
             for _ in range(n_fixed)]
    i = 0
    while True:
        yield fixed[i % n_fixed]
        i += 1


def _cfg(name="adamw", lr=1e-2, gas=1, **extra):
    cfg = {"train_micro_batch_size_per_chip": 2,
           "gradient_accumulation_steps": gas,
           "optimizer": {"type": name, "params": {"lr": lr}},
           "gradient_clipping": 1.0, "bf16": {"enabled": False},
           "zero_optimization": {"stage": 0}, "steps_per_print": 100}
    cfg.update(extra)
    return cfg


def _pair(cfg):
    """The JAX engine on the 8-device mesh and the port's engine from its
    initial masters, with its global batch."""
    jeng, *_ = dstpu.initialize(
        model=JaxLM(JaxConfig(dtype=jnp.float32, **TINY)),
        config=copy.deepcopy(cfg))
    masters = jax.tree.map(np.asarray, jeng.opt_state.master)
    model = params_from_jax(masters, TransformerConfig(
        dtype=torch.float32, **TINY), device="cpu")
    pcfg = dict(copy.deepcopy(cfg), train_batch_size=jeng.train_batch_size)
    del pcfg["train_micro_batch_size_per_chip"]
    eng = deepspeed_tpu_torch.initialize(model=model, config=pcfg,
                                         device="cpu")[0]
    return jeng, eng


def _assert_masters(jeng, eng):
    jm = jax.tree.map(np.asarray, jeng.opt_state.master)
    pm = params_to_numpy(eng.opt_state.master)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jm)[0]:
        node = pm
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(node, leaf, atol=1e-4, rtol=0,
                                   err_msg=str(path))


@pytest.mark.parametrize("name", ["lamb", "muon"])
def test_engine_follows_the_jax_engine(name):
    jeng, eng = _pair(_cfg(name, lr=2e-2))
    jit = data_iter(jeng.micro_batch_size * jeng.dp_world_size, seed=5)
    pit = data_iter(eng.micro_batch_size, seed=5)
    want = [float(jeng.train_batch(jit)) for _ in range(4)]
    got = [float(eng.train_batch(pit)) for _ in range(4)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]
    _assert_masters(jeng, eng)


def _warnings_of(name):
    """A handler on the JAX logger (it does not propagate)."""
    records = []

    class H(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    logging.getLogger(name).addHandler(H())
    return records


def test_set_lr_then_a_step_follows_jax(caplog):
    cfg = _cfg("adamw", scheduler={"type": "WarmupLR", "params": {
        "warmup_num_steps": 10}})
    jeng, eng = _pair(cfg)
    jit = data_iter(jeng.micro_batch_size * jeng.dp_world_size, seed=2)
    pit = data_iter(eng.micro_batch_size, seed=2)
    want = [float(jeng.train_batch(jit))]
    got = [float(eng.train_batch(pit))]
    jwarn = _warnings_of("deepspeed_tpu")
    jeng.set_lr(0.05)
    with caplog.at_level(logging.WARNING):
        eng.set_lr(0.05)
    assert any("disables the configured lr schedule" in w for w in jwarn)
    assert "disables the configured lr schedule" in caplog.text
    assert eng.get_lr() == jeng.get_lr() == [0.05]
    assert eng.lr_schedule is None and eng.optimizer.param_groups[0][
        "lr"] == 0.05
    want += [float(jeng.train_batch(jit)) for _ in range(2)]
    got += [float(eng.train_batch(pit)) for _ in range(2)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _assert_masters(jeng, eng)


def test_set_lr_on_the_host_tiers():
    for zero in ({"offload_optimizer": {"device": "cpu"}},
                 {"offload_optimizer": {"device": "cpu"},
                  "zenflow": {"topk_ratio": 0.1}}):
        eng = deepspeed_tpu_torch.initialize(
            model=zoo.get_model("tiny", device="cpu", dtype=torch.float32,
                                **TINY),
            config=_cfg(zero_optimization={"stage": 2, **zero}),
            device="cpu")[0]
        eng.set_lr(0.25)
        assert eng.get_lr() == [0.25]
        eng.train_batch(data_iter(eng.micro_batch_size))
        assert eng.last_metrics["lr"] == 0.25


def test_zero_grad_between_micro_steps_follows_jax():
    """GAS 2: the first microbatch's grads are dropped by zero_grad, so
    the update holds only the second's (times 1/GAS), as in JAX."""
    jeng, eng = _pair(_cfg("adamw", gas=2))
    jit = data_iter(jeng.micro_batch_size * jeng.dp_world_size, seed=4)
    pit = data_iter(eng.micro_batch_size, seed=4)
    for e, it in ((jeng, jit), (eng, pit)):
        for micro in range(2):
            e.backward(e(next(it)))
            if micro == 0:
                e.zero_grad()
            e.step()
        assert e.global_steps == 1
    _assert_masters(jeng, eng)
    # a zero_grad after the window's backwards leaves step() nothing
    eng.backward(eng(next(pit)))
    eng.backward(eng(next(pit)))
    eng.zero_grad()
    with pytest.raises(RuntimeError, match="without accumulated"):
        eng.step()


def test_no_sync_train_and_eval():
    def run(use_no_sync):
        eng = deepspeed_tpu_torch.initialize(
            model=zoo.get_model("tiny", device="cpu", dtype=torch.float32,
                                **TINY), config=_cfg(gas=2),
            device="cpu")[0]
        it = data_iter(eng.micro_batch_size)
        for _ in range(2):
            if use_no_sync:
                with eng.no_sync():
                    eng.backward(eng(next(it)))
            else:
                eng.backward(eng(next(it)))
            eng.backward(eng(next(it)))
            eng.step()
        return eng

    a, b = run(True), run(False)
    for (p, x), (_, y) in zip(opt.leaves(a.params), opt.leaves(b.params)):
        assert torch.equal(x, y), p
    assert a.eval() is a and not a.model.training
    assert a.train() is a and a.model.training
    assert a.train(False) is a and not a.model.training


@pytest.mark.parametrize("zero", [
    {}, {"offload_optimizer": {"device": "cpu"}},
    {"offload_optimizer": {"device": "cpu"}, "zenflow": {"topk_ratio": 0.1}}])
def test_post_step_hooks_run_in_order_on_both_paths(zero):
    """At every global_steps increment, in registration order, on the
    train_batch and micro-step paths; an fp16 step that skipped its
    update counts (JAX increments global_steps for it)."""
    eng = deepspeed_tpu_torch.initialize(
        model=zoo.get_model("tiny", device="cpu", dtype=torch.float32,
                            **TINY),
        config=_cfg(gas=2, fp16={"enabled": True,
                                 "initial_scale_power": 40},
                    zero_optimization={"stage": 2, **zero}),
        device="cpu")[0]
    seen = []
    first = eng.register_post_step_hook(
        lambda e: seen.append(("a", e.global_steps, e.skipped_steps)))
    eng.register_post_step_hook(lambda e: seen.append(("b", e.global_steps)))
    assert callable(first)
    it = data_iter(eng.micro_batch_size)
    eng.train_batch(it)
    for _ in range(2):
        eng.backward(eng(next(it)))
        eng.step()
    eng.train_batch(it)
    assert seen == [("a", 1, 0), ("b", 1), ("a", 2, 1), ("b", 2),
                    ("a", 3, 2), ("b", 3)]
    assert eng.skipped_steps == 3  # 2**40 overflows fp16: every step skips


def _tiny_engine(name, seed=0):
    return deepspeed_tpu_torch.initialize(
        model=zoo.get_model("tiny", device="cpu", dtype=torch.float32,
                            seed=seed, **TINY),
        config=_cfg(name, lr=OPTIMIZERS[name]["lr"]), device="cpu")[0]


@pytest.mark.parametrize("name", ["adagrad", "adafactor", "muon", "lion"])
def test_checkpoint_resume_of_every_optimizer_state(tmp_path, name):
    """Each optimizer's state trees (``opt_<name>``; Adafactor's factored
    rows and columns, Muon's mixed momentum / Adam leaves) save and load:
    the resumed losses equal the uninterrupted run's; without the
    optimizer state each starts from its own initial state (Adagrad's
    accumulator at 0.1)."""
    eng = _tiny_engine(name)
    it = data_iter(eng.micro_batch_size, seed=3)
    [eng.train_batch(it) for _ in range(2)]
    eng.save_checkpoint(str(tmp_path))
    want = [float(eng.train_batch(it)) for _ in range(2)]
    eng2 = _tiny_engine(name, seed=1)
    eng2.load_checkpoint(str(tmp_path))
    it2 = data_iter(eng2.micro_batch_size, seed=3)
    [next(it2) for _ in range(2)]
    assert [float(eng2.train_batch(it2)) for _ in range(2)] == want
    eng3 = _tiny_engine(name, seed=1)
    eng3.load_checkpoint(str(tmp_path), load_optimizer_states=False)
    fresh = opt.init_mixed_precision(eng3.opt_state.master, eng3.tx)
    assert sorted(fresh.named_trees()) == sorted(eng3.opt_state.named_trees())
    for tree, got in zip(fresh.named_trees().values(),
                         eng3.opt_state.named_trees().values()):
        for (p, a), (_, b) in zip(opt.leaves(tree), opt.leaves(got)):
            assert torch.equal(a, b), p
    assert eng3.opt_state.count == 0
