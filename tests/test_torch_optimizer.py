"""Port optimizer, LR schedules, loss scaler and batch-triple solver
against the JAX package's.

The AdamW update runs 5 steps on a random tree with clipping and a
WarmupLR schedule and is held to optax (through the JAX
``apply_mixed_precision_update``) at rtol 1e-6: both compute in fp32 and
differ only in rounding order. Schedules are Python floats in the port
and fp32 in JAX: rtol 1e-6, with atol 1e-9 (5e-7 of the peak LR) for the
fp32 cancellation in 1 + cos(pi * progress) near the cosine's end.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.config import config as jax_config
from deepspeed_tpu.runtime import loss_scaler as jax_ls
from deepspeed_tpu.runtime import lr_schedules as jax_lr
from deepspeed_tpu.runtime import optimizer as jax_opt
from deepspeed_tpu_torch.config import config as config_mod
from deepspeed_tpu_torch.runtime import loss_scaler as ls
from deepspeed_tpu_torch.runtime import lr_schedules as lr
from deepspeed_tpu_torch.runtime import optimizer as opt

SHAPES = {"a": (4, 8), "b": {"c": (16,), "d": (3, 5, 2)}, "e": (7,)}


def _tree(rng, shapes, scale=1.0):
    return {k: (_tree(rng, v, scale) if isinstance(v, dict) else
                (rng.standard_normal(v) * scale).astype(np.float32))
            for k, v in shapes.items()}


def _to_torch(tree):
    return opt.tree_map(torch.from_numpy, tree)


def _flat(tree):
    return {p: np.asarray(v) for p, v in opt.leaves(tree)}


@pytest.mark.parametrize("kind", ["adamw", "adam"])
def test_update_matches_optax_over_five_steps(kind):
    rng = np.random.default_rng(0)
    params = _tree(rng, SHAPES)
    ocfg = {"type": kind, "params": {"lr": 3e-2, "weight_decay": 0.1,
                                     "betas": (0.8, 0.95), "eps": 1e-6}}
    scfg = {"type": "WarmupLR", "params": {"warmup_num_steps": 4}}

    jcfg = jax_config.load_config({"optimizer": ocfg, "scheduler": scfg})
    jsched = jax_lr.get_lr_schedule(jcfg.scheduler, base_lr=3e-2)
    jtx, _ = jax_opt.get_base_optimizer(jcfg.optimizer, jsched)
    jstate = jax_opt.init_mixed_precision(
        jax.tree.map(jnp.asarray, params), jtx)

    cfg = config_mod.load_config({"optimizer": ocfg, "scheduler": scfg})
    tx, base = opt.get_base_optimizer(
        cfg.optimizer, lr.get_lr_schedule(cfg.scheduler, base_lr=3e-2))
    assert base == 3e-2 and tx.decoupled == (kind == "adamw")
    state = opt.init_mixed_precision(_to_torch(params), tx)
    compute = opt.tree_map(lambda m: m.to(torch.bfloat16), state.master)

    for step in range(5):
        grads = _tree(rng, SHAPES, scale=0.5)  # norm ~2: the clip engages
        jparams, jstate, jnorm = jax_opt.apply_mixed_precision_update(
            jstate, jax.tree.map(jnp.asarray, grads), jtx, jnp.bfloat16,
            grad_clip=1.0)
        norm = opt.apply_mixed_precision_update(
            state, _to_torch(grads), tx, compute, grad_clip=1.0)
        np.testing.assert_allclose(norm.item(), float(jnorm), rtol=1e-6)
        assert float(jnorm) > 1.0
    got, want = _flat(state.master), _flat(jstate.master)
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=1e-6,
                                   atol=1e-9, err_msg=path)
    for path, p in opt.leaves(compute):
        assert p.dtype == torch.bfloat16
        np.testing.assert_array_equal(p.float().numpy(), np.asarray(
            _flat(jparams)[path].astype(np.float32)))
    assert state.count == 5


def test_loss_scaled_grads_and_overflow_skip():
    rng = np.random.default_rng(1)
    params = _tree(rng, SHAPES)
    tx, _ = opt.get_base_optimizer(config_mod.OptimizerConfig(
        type="adamw", params={"lr": 1e-2}))
    jtx, _ = jax_opt.get_base_optimizer(jax_config.OptimizerConfig(
        type="adamw", params={"lr": 1e-2}))
    state = opt.init_mixed_precision(_to_torch(params), tx)
    jstate = jax_opt.init_mixed_precision(
        jax.tree.map(jnp.asarray, params), jtx)
    grads = _tree(rng, SHAPES, scale=256.0)
    _, jstate, jnorm = jax_opt.apply_mixed_precision_update(
        jstate, jax.tree.map(jnp.asarray, grads), jtx, jnp.float32,
        grad_scale=jnp.float32(256.0), skip=jnp.asarray(False))
    norm = opt.apply_mixed_precision_update(state, _to_torch(grads), tx,
                                            grad_scale=256.0)
    np.testing.assert_allclose(norm.item(), float(jnorm), rtol=1e-6)
    before = {p: v.clone() for p, v in opt.leaves(state.master)}
    bad = opt.tree_map(torch.tensor, grads)  # a copy
    bad["a"][0, 0] = float("inf")
    assert ls.has_overflow(g for _, g in opt.leaves(bad))
    assert not ls.has_overflow(g for _, g in opt.leaves(_to_torch(grads)))
    opt.apply_mixed_precision_update(state, bad, tx, grad_scale=256.0,
                                     skip=True)
    assert state.count == 1
    for p, v in opt.leaves(state.master):
        assert torch.equal(v, before[p])
        np.testing.assert_allclose(v.numpy(), _flat(jstate.master)[p],
                                   rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("name,params", [
    ("LRRangeTest", dict(lr_range_test_min_lr=1e-3,
                         lr_range_test_step_size=7,
                         lr_range_test_step_rate=2.0,
                         lr_range_test_staircase=True)),
    ("OneCycle", dict(cycle_min_lr=1e-4, cycle_max_lr=1e-2,
                      cycle_first_step_size=10, cycle_second_step_size=15,
                      decay_step_size=5, decay_lr_rate=0.5)),
    ("WarmupLR", dict(warmup_min_lr=1e-5, warmup_max_lr=3e-3,
                      warmup_num_steps=20)),
    ("WarmupLR", dict(warmup_num_steps=20, warmup_type="linear")),
    ("WarmupDecayLR", dict(total_num_steps=40, warmup_num_steps=10)),
    ("WarmupCosineLR", dict(total_num_steps=45, warmup_num_steps=8,
                            warmup_min_ratio=0.1, cos_min_ratio=0.01)),
])
def test_schedules_match_jax(name, params):
    block = {"type": name, "params": params}
    got = lr.get_lr_schedule(config_mod.SchedulerConfig(**block),
                             base_lr=2e-3)
    want = jax_lr.get_lr_schedule(jax_config.SchedulerConfig(**block),
                                  base_lr=2e-3)
    for step in range(51):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=1e-9, err_msg=f"{name} step {step}")
    assert lr.get_lr_schedule(None) is None
    with pytest.raises(ValueError, match="unknown scheduler"):
        lr.get_lr_schedule(config_mod.SchedulerConfig(type="Bogus"))


@pytest.mark.parametrize("static", [False, True])
def test_loss_scaler_transitions_match_jax(static):
    block = {"enabled": True, "initial_scale_power": 4,
             "loss_scale_window": 3, "min_loss_scale": 2.0,
             "loss_scale": 8.0 if static else 0.0}
    cfg = config_mod.FP16Config(**block)
    jcfg = jax_config.FP16Config(**block)
    state, jstate = ls.init_loss_scale(cfg), jax_ls.init_loss_scale(jcfg)
    flags = [False, False, False, True, True, True, True, False, False,
             False, False, True]
    for flag in flags:
        state = ls.update_loss_scale(state, flag, cfg)
        jstate = jax_ls.update_loss_scale(jstate, jnp.asarray(flag), jcfg)
        assert (state.scale, state.good_steps) == (
            float(jstate.scale), int(jstate.good_steps))


def test_batch_triple_solver_matches_jax():
    values = (None, 2, 4, 8, 12)
    for tb, mb, gas, dp in itertools.product(values, values, values,
                                             (1, 2, 8)):
        block = {"train_batch_size": tb,
                 "train_micro_batch_size_per_chip": mb,
                 "gradient_accumulation_steps": gas}
        cfg = config_mod.load_config(dict(block))
        jcfg = jax_config.load_config(dict(block))
        try:
            jcfg.resolve_batch_size(dp)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                cfg.resolve_batch_size(dp)
            assert str(got.value) == str(e)
            continue
        cfg.resolve_batch_size(dp)
        assert (cfg.train_batch_size, cfg.train_micro_batch_size_per_chip,
                cfg.gradient_accumulation_steps) == (
            jcfg.train_batch_size, jcfg.train_micro_batch_size_per_chip,
            jcfg.gradient_accumulation_steps)
    legacy = config_mod.load_config({"train_micro_batch_size_per_gpu": 3})
    legacy.resolve_batch_size(1)
    assert legacy.train_batch_size == 3


def test_optimizer_names():
    for name in ("Adam", "FusedAdam", "cpu_adam", "AdamW", "fused_adamw"):
        tx, _ = opt.get_base_optimizer(config_mod.OptimizerConfig(type=name))
        assert tx.decoupled == ("w" in name.lower())
    kinds = {"sgd": opt.SGD, "momentum": opt.SGD, "lion": opt.Lion,
             "FusedLion": opt.Lion, "cpu_lion": opt.Lion,
             "adagrad": opt.Adagrad, "cpu_adagrad": opt.Adagrad,
             "lamb": opt.Lamb, "fused_lamb": opt.Lamb,
             "adafactor": opt.Adafactor}
    for name, kind in kinds.items():
        tx, _ = opt.get_base_optimizer(config_mod.OptimizerConfig(type=name))
        assert type(tx) is kind, name
    from deepspeed_tpu_torch.runtime.muon import Muon

    assert type(opt.get_base_optimizer(
        config_mod.OptimizerConfig(type="muon"))[0]) is Muon
    for name in ("onebitadam", "OneBitLamb", "zero_one_adam"):
        # the engine builds the 1-bit optimizers (runtime/onebit.py)
        with pytest.raises(ValueError, match="1-bit"):
            opt.get_base_optimizer(config_mod.OptimizerConfig(type=name))
    with pytest.raises(ValueError, match="unknown optimizer"):
        opt.get_base_optimizer(config_mod.OptimizerConfig(type="bogus"))
