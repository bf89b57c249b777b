"""ZeRO stages 0-3 across ranks (the port's ``runtime/zero.py`` on gloo)
against the JAX engine on an fsdp mesh of the CPU devices.

The model is ``dryrun_multichip`` config A's dense Llama
(``__graft_entry__.py:108-118``) at tp = sp = 1, remat on so that the
stage-3 recompute gathers again; fp32, GAS 2, clip 1.0, AdamW. JAX runs
``initialize(mesh=build_mesh({"fsdp": n, "dp": 1}, devices=jax.devices()
[:n]))`` (stage 0: dp = n) on the global batch; the port runs n gloo
processes (``tests/torch_dist_worker.py``), rank r on rows r of it. One
launch of each world size serves every case of the file.
"""

import logging
import os

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu as dstpu
from deepspeed_tpu.models.zoo import get_model as jax_get_model
from deepspeed_tpu.parallel.topology import build_mesh as jax_build_mesh

import deepspeed_tpu_torch
from deepspeed_tpu_torch.config.config import load_config
from deepspeed_tpu_torch.models import transformer as tf
from deepspeed_tpu_torch.models import zoo
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.utils import telemetry
from deepspeed_tpu_torch.utils import tensor_fragment as tfr

from torch_dist_worker import Ranks

PRESET = "llama3-8b"
MODEL_KW = dict(num_layers=2, hidden_size=64, ffn_size=128, num_heads=8,
                num_kv_heads=4, vocab_size=256, max_seq_len=64, remat=True)
CONFIG = {"train_micro_batch_size_per_chip": 2,
          "gradient_accumulation_steps": 2, "bf16": {"enabled": False},
          "gradient_clipping": 1.0, "steps_per_print": 100,
          "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}}
STEPS, SEQ = 2, 16
WORLDS = (2, 4)
STAGES = (0, 1, 2, 3)
RTOL, ATOL = 1e-5, 1e-4


def _batches(world, seed=0):
    rng = np.random.default_rng(seed)
    rows = CONFIG["train_micro_batch_size_per_chip"] * world
    return [{"input_ids": rng.integers(0, MODEL_KW["vocab_size"],
                                       (rows, SEQ + 1)).astype(np.int32)}
            for _ in range(STEPS * CONFIG["gradient_accumulation_steps"])]


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _jax_run(world, stage, api="train_batch"):
    mesh = jax_build_mesh({"fsdp": world, "dp": 1} if stage else
                          {"dp": world}, devices=jax.devices()[:world])
    model = jax_get_model(PRESET, dtype=jax.numpy.float32, **MODEL_KW)
    engine, *_ = dstpu.initialize(
        model=model, mesh=mesh,
        config=dict(CONFIG, zero_optimization={"stage": stage}))
    init = _flat(_np_tree(engine.opt_state.master))
    gas = CONFIG["gradient_accumulation_steps"]
    batches = _batches(world)
    losses = []
    for s in range(STEPS):
        mbs = batches[s * gas:(s + 1) * gas]
        if api == "train_batch":
            losses.append(float(engine.train_batch(iter(mbs))))
            continue
        step_losses = []
        for mb in mbs:
            loss = engine(mb)
            engine.backward(loss)
            engine.step()
            step_losses.append(float(loss))
        losses.append(float(np.mean(step_losses)))
    masters = _flat(engine.opt_state.master)
    # device r's slice of each master under the plan's optimizer-state
    # sharding (the layout the state is born in; a compiled step's outputs
    # may come back in another)
    specs = _flat(engine._opt_shardings)
    shards = {p: {r: np.asarray(leaf)[specs[p].devices_indices_map(
                      leaf.shape)[jax.devices()[r]]]
                  for r in range(world)}
              for p, leaf in masters.items()}
    return {"init": init, "losses": losses,
            "full": {p: np.asarray(v) for p, v in masters.items()},
            "shards": shards}


def _port_engine(params, stage=3, **extra):
    cfg = zoo.get_config(PRESET, dtype=torch.float32, **MODEL_KW)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=params_from_jax(params, cfg, device="cpu"),
        config=dict(CONFIG, zero_optimization={"stage": stage}, **extra),
        device="cpu")
    return engine


def _state(engine):
    paths = [p for p in _flat(tf.logical_axes(engine.model_config))]
    return ({p: tfr.safe_get_full_fp32_param(engine, p) for p in paths},
            {p: (tfr.safe_get_full_optimizer_state(engine, p, "exp_avg"),
                 tfr.safe_get_full_optimizer_state(engine, p, "exp_avg_sq"))
             for p in paths})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("zero")
    # the JAX engine's own init (its config seed, 42): the ranks start at
    # once, and the JAX references run meanwhile
    params = _jax_params()
    ckpt1, ckpt2 = str(root / "ckpt1"), str(root / "ckpt2")
    # the world-size-1 checkpoint the 2-rank run loads (no process group)
    one = _port_engine(params)
    gas = CONFIG["gradient_accumulation_steps"]
    one.train_batch(iter(_batches(1, seed=5)[:gas]))
    one.save_checkpoint(ckpt1)
    saved1 = _state(one)
    del one
    base = {"preset": PRESET, "model_kw": MODEL_KW, "params": params,
            "config": CONFIG, "stages": STAGES}
    jobs = {1: Ranks("zero", str(root / "w1"), 1,
                     dict(base, batches=_batches(1))),
            2: Ranks("zero,raises,ckpt", str(root / "w2"), 2,
                     dict(base, batches=_batches(2), ckpt={
                         "stage": 3, "load_dir": ckpt1,
                         "save_dir": ckpt2})),
            4: Ranks("zero", str(root / "w4"), 4,
                     dict(base, batches=_batches(4)))}
    jax_ref = {(n, s): _jax_run(n, s) for n in WORLDS for s in STAGES}
    jax_ref["micro", 2, 3] = _jax_run(2, 3, api="micro")
    for path, want in _flat(params).items():
        assert np.array_equal(jax_ref[2, 0]["init"][path], want), path
    port = {n: job.join() for n, job in jobs.items()}
    return {"jax": jax_ref, "port": port, "params": params,
            "saved1": saved1, "ckpt2": ckpt2}


@pytest.mark.parametrize("api", ["train_batch", "micro"])
@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("world", WORLDS)
def test_zero_follows_jax(runs, world, stage, api):
    """Losses and the gathered fp32 masters of every rank follow JAX's
    engine at the same stage (JAX's train_batch)."""
    ref = runs["jax"][world, stage]
    for out in runs["port"][world]:
        got = out["zero"][stage, api]
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=RTOL,
                                   atol=ATOL)
        assert set(got["full"]) == set(ref["full"])
        for path, want in ref["full"].items():
            np.testing.assert_allclose(got["full"][path], want, rtol=RTOL,
                                       atol=ATOL, err_msg=path)


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("world", WORLDS)
def test_local_block_is_jax_device_shard(runs, world, stage):
    """Rank r's master block of each leaf is JAX's device-r shard: the
    r-th block of the embed dim from stage 1, the whole leaf at stage 0."""
    ref = runs["jax"][world, stage]
    for rank, out in enumerate(runs["port"][world]):
        local = out["zero"][stage, "train_batch"]["local"]
        for path, shards in ref["shards"].items():
            want = shards[rank]
            assert local[path].shape == want.shape, path
            np.testing.assert_allclose(local[path], want, rtol=RTOL,
                                       atol=ATOL, err_msg=path)
            if stage >= 1:  # sharded on the embed dim: a strict block
                assert local[path].size * world == \
                    ref["full"][path].size, path


def test_micro_step_follows_jax_micro_step(runs):
    ref = runs["jax"]["micro", 2, 3]
    got = runs["port"][2][0]["zero"][3, "micro"]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=RTOL,
                               atol=ATOL)
    for path, want in ref["full"].items():
        np.testing.assert_allclose(got["full"][path], want, rtol=RTOL,
                                   atol=ATOL, err_msg=path)


def test_loss_fn_params_model_follows_jax_at_stage_three(runs):
    """A ``(loss_fn, params)`` model at stage 3 over 2 ranks: its leaves
    shard on dim 0 (JAX's fallback) and the whole tree is gathered at
    the loss; the step is JAX's."""
    ref = runs["jax"][2, 3]
    for out in runs["port"][2]:
        got = out["zero"][3, "loss_fn"]
        assert got["fetch"]
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=RTOL,
                                   atol=ATOL)
        for path, want in ref["full"].items():
            np.testing.assert_allclose(got["full"][path], want, rtol=RTOL,
                                       atol=ATOL, err_msg=path)


@pytest.mark.parametrize("api", ["train_batch", "micro"])
@pytest.mark.parametrize("stage", [1, 2, 3])
def test_world_one_stages_equal_stage_zero(runs, stage, api):
    """On a one-rank group every collective runs and is the identity:
    each stage's losses, masters and moments equal stage 0's bit for
    bit."""
    res = runs["port"][1][0]["zero"]
    got, want = res[stage, api], res[0, api]
    assert got["losses"] == want["losses"]
    for path in want["full"]:
        assert np.array_equal(got["full"][path], want["full"][path]), path
        for a, b in zip(got["moments"][path], want["moments"][path]):
            assert np.array_equal(a, b), path


def _expected_counts(stage):
    """The collectives one step issues at world size 1, derived from the
    model's leaves (those with an embed dim shard) and the remat
    setting: per leaf and microbatch, or per leaf and step."""
    axes = _flat(tf.logical_axes(zoo.get_config(PRESET, **MODEL_KW)))
    sharded = [p for p, ax in axes.items() if "embed" in ax]
    rep = len(axes) - len(sharded)
    layer = len([p for p in sharded if p.startswith("layers/")])
    top = len(sharded) - layer
    gas, L = CONFIG["gradient_accumulation_steps"], MODEL_KW["num_layers"]
    remat = 2 if MODEL_KW["remat"] else 1
    # + the global norm's sum of squares and the mean loss
    per_step = {0: {"all_reduce": len(axes) + 2},
                1: {"all_reduce": len(axes) + 2, "all_gather": len(sharded)},
                2: {"reduce_scatter": len(sharded) * gas,
                    "all_reduce": rep + 2, "all_gather": len(sharded)},
                3: {"all_gather": (top + layer * L * remat) * gas,
                    "reduce_scatter": (top + layer * L) * gas,
                    "all_reduce": rep + 2}}[stage]
    return {k: v * STEPS for k, v in per_step.items()}


@pytest.mark.parametrize("stage", STAGES)
def test_world_one_collectives_match_the_plan(runs, stage):
    for api in ("train_batch", "micro"):
        got = runs["port"][1][0]["zero"][stage, api]["counts"]
        assert got == _expected_counts(stage), api


@pytest.mark.parametrize("case,item", [
    ("offload", "item 17"), ("zenflow", "item 17"), ("moe", "item 9"),
    ("qgz_offload", "item 17"),
    ("tp", "item 11"), ("lamb", "item 17"), ("client", "builds"),
    ("offload_sp", "item 17"), ("zenflow_pp", "item 17")])
def test_not_ported_across_ranks_raises(runs, case, item):
    """What runs on dp x fsdp but not yet at tp (the host tiers, qgZ with
    them, Lamb) raises there, naming its item."""
    for out in runs["port"][2]:
        msg = out["raises"][case]
        if case in ("tp", "moe", "client"):
            # ported: a dense or MoE model on a tp mesh builds (and
            # tests/test_torch_tp.py follows JAX's tp engines), and so
            # does a client optimizer, as JAX's optax transform trains
            # there (tests/test_torch_zeropp_3d_small.py follows it)
            assert msg is None, (case, msg)
            continue
        assert msg is not None and item in msg, (case, msg)


def test_restore_saved_at_one_rank_loads_at_two(runs):
    masters, moments = runs["saved1"]
    for out in runs["port"][2]:
        loaded = out["ckpt"]["loaded"]
        assert loaded["resharded"] == 1
        assert loaded["global_steps"] == 1
        for path, want in masters.items():
            assert np.array_equal(loaded["full"][path], want), path
            for a, b in zip(loaded["moments"][path], moments[path]):
                assert np.array_equal(a, b), path
        assert np.isfinite(loaded["loss_after"])


def test_restore_saved_at_two_ranks_loads_at_one(runs, caplog):
    ckpt2 = runs["ckpt2"]
    tag = os.path.join(ckpt2, "global_step2", "state", "opt_master",
                       "layers", "attn")
    # each rank wrote its own block of a sharded leaf
    assert sorted(os.listdir(tag))[:2] == ["wk.block0of2.pt",
                                           "wk.block1of2.pt"]
    engine = _port_engine(runs["params"])
    telemetry.reset()
    log = logging.getLogger("deepspeed_tpu_torch.checkpoint.state")
    log.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.WARNING):
            engine.load_checkpoint(ckpt2)
    finally:
        log.removeHandler(caplog.handler)
    assert telemetry.get("resilience.resharded_restore") == 1
    assert any("resharded restore" in r.getMessage() for r in caplog.records)
    masters, moments = _state(engine)
    saved = runs["port"][2][0]["ckpt"]["saved"]
    for path, want in saved["full"].items():
        assert np.array_equal(masters[path], want), path
        for a, b in zip(moments[path], saved["moments"][path]):
            assert np.array_equal(a, b), path


def test_tag_validation_fail_refuses_a_reshard(runs):
    engine = _port_engine(runs["params"],
                          checkpoint={"tag_validation": "Fail"})
    with pytest.raises(ValueError, match="resharded"):
        engine.load_checkpoint(runs["ckpt2"])


@pytest.mark.parametrize("key,value", [
    ("prescale_gradients", True), ("gradient_predivide_factor", 2.0),
    ("communication_data_type", "fp32")])
def test_switches_jax_never_reads_are_accepted(key, value):
    cfg = load_config({key: value})
    assert getattr(cfg, key) == value


def test_comms_logger_block_and_zero_knobs_are_accepted():
    cfg = load_config({"comms_logger": {"enabled": True, "prof_ops": [
        "all_gather"]}, "zero_optimization": {
            "stage": 3, "reduce_bucket_size": 10, "overlap_comm": True,
            "contiguous_gradients": True, "sub_group_size": 4,
            "param_persistence_threshold": 7}})
    assert cfg.comms_logger.enabled and cfg.comms_logger.prof_ops == [
        "all_gather"]
    assert cfg.zero_optimization.stage == 3


def test_one_process_engine_issues_no_collective():
    """Without a process group the engine runs as before: no mesh
    collective, no fetch hook, shards are whole leaves."""
    engine = _port_engine(_jax_params(),
                          comms_logger={"enabled": True})
    assert not engine.mesh.distributed and engine._zero is None
    assert engine._fetch is None and engine.dp_world_size == 1
    from deepspeed_tpu_torch.utils.comms_logging import get_comms_logger

    get_comms_logger().reset()
    engine.train_batch(iter(_batches(1)[:2]))
    assert get_comms_logger().counts() == {}


def _jax_params(seed=42):
    model = jax_get_model(PRESET, dtype=jax.numpy.float32, **MODEL_KW)
    return _np_tree(jax.jit(model.init)(jax.random.PRNGKey(seed)))
