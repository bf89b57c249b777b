"""The rest of the one-card engine against the JAX package (the cases of
tests/test_prefetch.py, and JAX's ``(loss_fn, params)`` engine with optax
client transforms): the ``PrefetchingIterator`` contract, the pipelined
loop (dispatch-ahead and input prefetch) bit-identical to the blocking
loop at fp32 and across fp16 overflow skips, ``synchronize`` at the
checkpoint, eval and state-export boundaries, ``(loss_fn, params)``
models, client ``torch.optim`` optimizers and LR schedulers.

JAX's engines run on the 8-device CPU mesh; the port's world size is 1,
so it gets the JAX engine's global batch. fp32 on the CPU.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import deepspeed_tpu as dstpu
import deepspeed_tpu_torch
from deepspeed_tpu.runtime.prefetch import \
    PrefetchingIterator as JaxPrefetchingIterator
from deepspeed_tpu_torch.config.config import load_config
from deepspeed_tpu_torch.models import transformer, zoo
from deepspeed_tpu_torch.models.convert import fp32_tree
from deepspeed_tpu_torch.runtime.dataloader import (DeepSpeedDataLoader,
                                                    RepeatingLoader)
from deepspeed_tpu_torch.runtime.optimizer import tree_map
from deepspeed_tpu_torch.runtime.prefetch import (PrefetchingIterator,
                                                  to_device_async, wait_ready)

TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            max_seq_len=32, pos_emb="learned", norm="layernorm",
            activation="gelu", tie_embeddings=True, remat=False)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def fixed_batches(batch, n, seq=17, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 64, (batch, seq)).astype(np.int32)}
            for _ in range(n)]


def make_engine(pipeline_depth, prefetch_depth=2, extra=None, seed=0):
    cfg = {
        "train_micro_batch_size_per_chip": 2,
        "optimizer": {"type": "adamw", "params": {"lr": 1e-2}},
        "zero_optimization": {"stage": 1},
        "bf16": {"enabled": False},
        "performance": {"pipeline_depth": pipeline_depth,
                        "prefetch_depth": prefetch_depth},
        "steps_per_print": 1_000_000,
    }
    cfg.update(extra or {})
    model = zoo.get_model("tiny", device="cpu", seed=seed,
                          dtype=torch.float32, **TINY)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config=cfg,
                                                     device="cpu")
    return engine


def _linear_loss(params, batch):
    # JAX promotes x @ w to the wider type; torch needs the cast said
    pred = batch["x"] @ params["w"].to(batch["x"].dtype)
    return ((pred - batch["y"]) ** 2).mean(), {}


def _jax_linear_loss(params, batch):
    pred = batch["x"] @ params["w"]
    return ((pred - batch["y"]) ** 2).mean(), {}


def _linear_cfg(pipeline_depth, fp16=False, rows=1, optimizer=True):
    cfg = {
        "train_micro_batch_size_per_chip": rows,
        "performance": {"pipeline_depth": pipeline_depth,
                        "prefetch_depth": 2},
        "bf16": {"enabled": False},
        "steps_per_print": 1_000_000,
    }
    if optimizer:
        cfg["optimizer"] = {"type": "adamw", "params": {"lr": 1e-2}}
    if fp16:
        cfg["fp16"] = {"enabled": True, "initial_scale_power": 4}
    return cfg


def make_linear_engine(pipeline_depth, fp16=False, **kw):
    """Tiny (loss_fn, params) engine; overflow is forceable by feeding
    huge-magnitude inputs."""
    params = {"w": np.ones((4, 1), np.float32)}
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=_linear_loss, model_parameters=params,
        config=_linear_cfg(pipeline_depth, fp16, rows=8), device="cpu", **kw)
    return engine


def linear_batches(n, seed=0, overflow_at=()):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        scale = 1e30 if i in overflow_at else 1.0
        out.append({"x": (rng.normal(size=(8, 4)) * scale).astype(np.float32),
                    "y": rng.normal(size=(8, 1)).astype(np.float32)})
    return out


# -- PrefetchingIterator contract ---------------------------------------------


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_prefetch_yields_in_order_and_ends_as_jax(depth):
    p = PrefetchingIterator(iter(range(7)), depth=depth)
    j = JaxPrefetchingIterator(iter(range(7)), depth=depth)
    assert list(p) == list(j) == list(range(7))
    with pytest.raises(StopIteration):
        next(p)
    assert (p.produced, p.consumed) == (j.produced, j.consumed) == (7, 7)
    p.close()
    j.close()


def test_prefetch_depth_zero_is_synchronous():
    p = PrefetchingIterator(iter([1, 2]), depth=0)
    assert p._thread is None
    assert [next(p), next(p)] == [1, 2]
    with pytest.raises(StopIteration):
        next(p)


def test_prefetch_worker_exception_propagates_at_next():
    def gen():
        yield 1
        yield 2
        raise ValueError("bad shard")

    p = PrefetchingIterator(gen(), depth=2)
    assert next(p) == 1
    assert next(p) == 2
    with pytest.raises(ValueError, match="bad shard"):
        next(p)
    with pytest.raises(StopIteration):  # the failure ends the stream
        next(p)
    p.close()


def test_prefetch_buffer_is_bounded():
    produced = []
    lock = threading.Lock()

    def gen():
        i = 0
        while True:
            with lock:
                produced.append(i)
            yield i
            i += 1

    depth = 2
    p = PrefetchingIterator(gen(), depth=depth)
    deadline = time.monotonic() + 5.0
    while p.buffered < depth and time.monotonic() < deadline:
        time.sleep(0.01)
    assert p.buffered == depth
    time.sleep(0.1)  # give an unbounded worker time to overshoot
    with lock:
        n = len(produced)
    assert n <= depth + 1, f"worker ran {n} items ahead (depth={depth})"
    assert [next(p) for _ in range(4)] == [0, 1, 2, 3]
    p.close()


def test_prefetch_close_mid_epoch_joins_worker():
    def gen():
        i = 0
        while True:
            yield i
            i += 1

    p = PrefetchingIterator(gen(), depth=2)
    assert next(p) == 0
    worker = p._thread
    p.close()
    assert not worker.is_alive()
    p.close()  # idempotent
    with pytest.raises(RuntimeError, match="after close"):
        next(p)


def test_prefetch_context_manager_closes():
    with PrefetchingIterator(iter(range(100)), depth=2) as p:
        assert next(p) == 0
        worker = p._thread
    assert not worker.is_alive()


def test_prefetch_callable_source():
    items = iter([10, 20])
    p = PrefetchingIterator(lambda: next(items), depth=1)
    assert [next(p), next(p)] == [10, 20]
    with pytest.raises(StopIteration):
        next(p)
    p.close()


def test_prefetch_rejects_negative_depth():
    with pytest.raises(ValueError):
        PrefetchingIterator(iter([]), depth=-1)


def test_device_copy_on_the_cpu_is_plain_and_keeps_the_tree():
    from collections import namedtuple

    Pair = namedtuple("Pair", "a b")
    tree = {"x": np.arange(6, dtype=np.int32).reshape(2, 3),
            "p": Pair(np.ones(2, np.float32), None),
            "l": [torch.zeros(3)]}
    out, event = to_device_async(tree, torch.device("cpu"))
    assert event is None
    assert wait_ready(out, event) is out
    assert isinstance(out["p"], Pair) and out["p"].b is None
    assert out["x"].dtype == torch.int32 and out["x"].shape == (2, 3)
    assert torch.equal(out["l"][0], torch.zeros(3))


# -- the pipelined loop --------------------------------------------------------


def test_pipelined_losses_identical_fp32():
    """Depth 2 runs the same ops on the same inputs as depth 0: the
    per-step losses are bit-identical over 12 steps."""
    e0 = make_engine(pipeline_depth=0)
    e2 = make_engine(pipeline_depth=2)
    batches = fixed_batches(e0.micro_batch_size, 12)
    blocking = [float(e0.train_batch(iter([b]))) for b in batches]
    it = iter(list(batches))
    async_losses = [e2.train_batch(it) for _ in batches]
    assert e2._prefetcher is not None  # the stream was promoted
    e2.synchronize()
    assert [float(x) for x in async_losses] == blocking  # bitwise
    assert e2.global_steps == 12
    assert len(e2._inflight) == 0


def test_pipelined_losses_identical_fp16_overflow():
    """A forced-overflow step is skipped (and counted) the same way in
    the pipelined loop, where the count is taken when the step drains;
    both agree with JAX's pipelined engine on the skips."""
    e0 = make_linear_engine(pipeline_depth=0, fp16=True)
    e2 = make_linear_engine(pipeline_depth=2, fp16=True)
    batches = linear_batches(12, overflow_at=(3, 7))
    blocking = [float(e0.train_batch(iter([b]))) for b in batches]
    it = iter(list(batches))
    async_losses = [e2.train_batch(it) for _ in batches]
    e2.synchronize()
    np.testing.assert_array_equal(
        np.asarray([float(x) for x in async_losses]), np.asarray(blocking))
    assert e0.skipped_steps == e2.skipped_steps >= 1
    assert e0.loss_scale == e2.loss_scale
    jeng, *_ = dstpu.initialize(
        model=_jax_linear_loss, model_parameters={"w": np.ones((4, 1),
                                                               np.float32)},
        config=_linear_cfg(2, fp16=True))
    jit = iter(list(batches))
    for _ in batches:
        jeng.train_batch(jit)
    jeng.synchronize()
    assert jeng.skipped_steps == e2.skipped_steps


def test_dispatch_ahead_env_override(monkeypatch):
    monkeypatch.setenv("DSTPU_DISPATCH_AHEAD", "3")
    assert make_linear_engine(pipeline_depth=0)._dispatch_ahead == 3
    monkeypatch.setenv("DSTPU_DISPATCH_AHEAD", "0")
    assert make_linear_engine(pipeline_depth=2)._dispatch_ahead == 0


def test_inflight_window_bounded():
    e = make_linear_engine(pipeline_depth=2)
    it = iter(linear_batches(8))
    for _ in range(8):
        e.train_batch(it)
        assert len(e._inflight) <= 2
    e.synchronize()
    assert len(e._inflight) == 0
    assert e.global_steps == 8


def test_blocking_paths_keep_a_window_of_zero():
    """Post-step hooks (and the host optimizer tiers) take the blocking
    loop whatever the depth, as in JAX."""
    e = make_linear_engine(pipeline_depth=2)
    seen = []
    e.register_post_step_hook(lambda eng: seen.append(eng.global_steps))
    it = iter(linear_batches(3))
    for _ in range(3):
        e.train_batch(it)
        assert len(e._inflight) == 0
    assert seen == [1, 2, 3]


def test_synchronize_before_save_checkpoint(tmp_path):
    e = make_engine(pipeline_depth=2)
    it = iter(fixed_batches(e.micro_batch_size, 4))
    for _ in range(4):
        e.train_batch(it)
    assert len(e._inflight) > 0  # the window is really in flight
    assert e.save_checkpoint(str(tmp_path)) is not None
    assert len(e._inflight) == 0
    e2 = make_engine(pipeline_depth=2, seed=1)
    e2.load_checkpoint(str(tmp_path))
    assert e2.global_steps == 4


def test_engine_promotes_repeated_iterator_only():
    e = make_linear_engine(pipeline_depth=0)
    batches = linear_batches(6)
    for b in batches[:3]:
        e.train_batch(iter([b]))
        assert e._prefetcher is None
    stream = iter(batches)
    e.train_batch(stream)          # first sighting: a synchronous pull
    assert e._prefetcher is None
    e.train_batch(stream)          # the same iterator again: promoted
    assert e._prefetcher is not None
    e.train_batch(iter([batches[0]]))  # another stream: the worker goes
    assert e._prefetcher is None
    e.synchronize()


@pytest.mark.parametrize("call", ["eval_batch", "module_state_dict",
                                  "offload_states"])
def test_boundaries_drain_the_window(call):
    e = make_linear_engine(pipeline_depth=2)
    batches = linear_batches(4)
    it = iter(batches)
    for _ in range(3):
        e.train_batch(it)
    assert len(e._inflight) > 0
    if call == "eval_batch":
        assert np.isfinite(float(e.eval_batch(batches[-1])))
    elif call == "module_state_dict":
        assert set(e.module_state_dict()) == {"w"}
    else:
        e.offload_states()
        e.reload_states()
    assert len(e._inflight) == 0


def test_prefetched_run_resumes_from_the_counts(tmp_path):
    """While the prefetcher runs the cursor leaves the loader's state out
    (its worker has pulled ahead); a resume from the counts replays the
    stream exactly."""
    rows = fixed_batches(1, 48, seed=3)
    rows = [r["input_ids"][0] for r in rows]

    def loader():
        return RepeatingLoader(DeepSpeedDataLoader(
            [{"input_ids": r} for r in rows], batch_size=2, shuffle=True,
            seed=7))

    ref = make_engine(pipeline_depth=2)
    it = loader()
    want = [float(ref.train_batch(it)) for _ in range(5)]
    a = make_engine(pipeline_depth=2)
    it = loader()
    got = [float(a.train_batch(it)) for _ in range(2)]
    a.save_checkpoint(str(tmp_path))
    b = make_engine(pipeline_depth=2, seed=1)
    b.load_checkpoint(str(tmp_path))
    assert "loader" not in b.loaded_data_cursor
    assert b.loaded_data_cursor["microbatches_consumed"] == 2
    fresh = loader()
    it = b.resume_data_iter(fresh, source=fresh)
    got += [float(b.train_batch(it)) for _ in range(3)]
    assert got == want


def test_performance_block_checks():
    cfg = load_config({"performance": {"pipeline_depth": 2,
                                       "prefetch_depth": 3}})
    assert (cfg.performance.pipeline_depth,
            cfg.performance.prefetch_depth) == (2, 3)
    assert load_config({}).performance.prefetch_depth == 0
    for block, err, match in (
            ({"pipeline_depth": -1}, ValueError, "pipeline_depth"),
            ({"prefetch_depth": -1}, ValueError, "prefetch_depth"),
            ({"overlap_depth": -1}, ValueError, "overlap_depth"),
            ({"param_prefetch_depth": 0}, ValueError, ">= 1")):
        with pytest.raises(err, match=match):
            load_config({"performance": block})
    # the streamed stack's knobs parse (A11; they reach the model's config
    # through the engine, tests/test_torch_param_stream.py)
    perf = load_config({"performance": {"param_prefetch_depth": 2,
                                        "overlap_depth": 1}}).performance
    assert (perf.param_prefetch_depth, perf.overlap_depth) == (2, 1)
    # the fp8 MLP is ported (A10): the switch parses
    assert load_config({"performance": {"fp8_mlp": True}}).performance.fp8_mlp


# -- (loss_fn, params) models and client optimizers against JAX ---------------


def _jax_linear_engine(optimizer=None, cfg_optimizer=True):
    params = {"w": np.ones((4, 1), np.float32)}
    jeng, _, _, _ = dstpu.initialize(
        model=_jax_linear_loss, model_parameters=params,
        config=_linear_cfg(0, optimizer=cfg_optimizer), optimizer=optimizer)
    return jeng


def _port_linear_engine(jeng, optimizer=None, cfg_optimizer=True):
    params = fp32_tree(jax.tree.map(np.asarray, jeng.opt_state.master),
                           device="cpu")
    cfg = _linear_cfg(0, rows=jeng.train_batch_size,
                      optimizer=cfg_optimizer)
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=_linear_loss, model_parameters=params, config=cfg,
        optimizer=optimizer, device="cpu")
    return eng


def _four_steps(eng, batches):
    return [float(eng.train_batch(iter([b]))) for b in batches]


def test_loss_fn_params_engine_follows_jax():
    batches = linear_batches(4, seed=5)
    jeng = _jax_linear_engine()
    eng = _port_linear_engine(jeng)
    np.testing.assert_allclose(_four_steps(eng, batches),
                               _four_steps(jeng, batches), rtol=1e-5)
    np.testing.assert_allclose(
        eng.opt_state.master["w"].numpy(),
        np.asarray(jeng.opt_state.master["w"]), rtol=1e-5)
    assert eng.update_count == 4


@pytest.mark.parametrize("name", ["adamw", "sgd", "sgd_momentum"])
def test_client_optimizer_follows_jax_optax(name):
    torch_opt, jax_tx = {
        "adamw": (lambda ps: torch.optim.AdamW(ps, lr=1e-2,
                                               weight_decay=1e-3),
                  optax.adamw(1e-2, weight_decay=1e-3)),
        "sgd": (lambda ps: torch.optim.SGD(ps, lr=5e-2),
                optax.sgd(5e-2)),
        "sgd_momentum": (lambda ps: torch.optim.SGD(ps, lr=5e-2,
                                                    momentum=0.9),
                         optax.sgd(5e-2, momentum=0.9)),
    }[name]
    batches = linear_batches(4, seed=6)
    jeng = _jax_linear_engine(optimizer=jax_tx, cfg_optimizer=False)
    eng = _port_linear_engine(jeng, optimizer=torch_opt,
                              cfg_optimizer=False)
    np.testing.assert_allclose(_four_steps(eng, batches),
                               _four_steps(jeng, batches), rtol=1e-5)
    np.testing.assert_allclose(
        eng.opt_state.master["w"].numpy(),
        np.asarray(jeng.opt_state.master["w"]), rtol=1e-5)
    # the optimizer view reads the client's lr (JAX's has none to read)
    assert eng.optimizer.param_groups[0]["lr"] == \
        eng._client_opt.param_groups[0]["lr"]


def test_client_optimizer_over_a_zoo_model_follows_the_config_adamw():
    """``torch.optim.AdamW(model.parameters())`` on an fp32 zoo model (its
    tensors are the engine's masters) against the engine's own adamw at
    the same hyperparameters."""
    batches = fixed_batches(2, 3, seed=2)
    ref = make_engine(pipeline_depth=0, extra={"optimizer": {
        "type": "adamw", "params": {"lr": 1e-2, "weight_decay": 0.01}}})
    model = zoo.get_model("tiny", device="cpu", seed=0,
                          dtype=torch.float32, **TINY)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-2, weight_decay=0.01)
    cfg = {"train_micro_batch_size_per_chip": 2, "bf16": {"enabled": False},
           "steps_per_print": 1_000_000}
    eng, view, _, sched = deepspeed_tpu_torch.initialize(
        model=model, config=cfg, optimizer=opt, device="cpu")
    assert eng._client_opt is opt and sched is None
    np.testing.assert_allclose(_four_steps(eng, batches),
                               _four_steps(ref, batches), rtol=1e-5)
    # the model's own tensors followed the training
    wq = model.params()["layers"]["attn"]["wq"]
    assert wq is eng.opt_state.master["layers"]["attn"]["wq"]
    np.testing.assert_allclose(
        wq.detach().numpy(),
        ref.opt_state.master["layers"]["attn"]["wq"].numpy(), atol=1e-5)


def test_client_optimizer_rules():
    eng = make_linear_engine(
        pipeline_depth=0, optimizer=lambda ps: torch.optim.SGD(ps, lr=0.1))
    with pytest.raises(NotImplementedError, match="client optimizer"):
        eng.set_lr(1e-3)
    assert eng.get_lr() == [0.1]
    stray = torch.optim.SGD([torch.zeros(4, 1)], lr=0.1)
    with pytest.raises(ValueError, match="fp32 parameters"):
        make_linear_engine(pipeline_depth=0, optimizer=stray)
    with pytest.raises(TypeError, match="torch.optim.Optimizer"):
        make_linear_engine(pipeline_depth=0, optimizer=lambda ps: object())
    with pytest.raises(ValueError, match="model_parameters"):
        deepspeed_tpu_torch.initialize(model=_linear_loss, config={},
                                       device="cpu")
    model = zoo.get_model("tiny", device="cpu", dtype=torch.float32, **TINY)
    with pytest.raises(ValueError, match="client optimizer"):
        deepspeed_tpu_torch.initialize(
            model=model, optimizer=torch.optim.SGD(model.parameters(),
                                                   lr=0.1),
            config={"zero_optimization": {
                "stage": 3, "offload_optimizer": {"device": "cpu"}}},
            device="cpu")


def test_client_lr_scheduler_is_stored_and_returned_as_jax_does():
    """JAX stores the client scheduler and returns it; it steps nothing
    with it. The caller steps it, and the optimizer's lr follows. The
    optimizer here is built over fp32 model_parameters, which the engine
    takes as its masters."""
    params = {"w": torch.ones(4, 1)}
    opt = torch.optim.SGD([params["w"]], lr=0.1)
    sched = torch.optim.lr_scheduler.StepLR(opt, step_size=1, gamma=0.5)
    eng, _, _, got = deepspeed_tpu_torch.initialize(
        model=_linear_loss, model_parameters=params,
        config=_linear_cfg(0, rows=8, optimizer=False), optimizer=opt,
        lr_scheduler=sched, device="cpu")
    assert got is sched and eng.lr_scheduler is sched
    assert eng.opt_state.master["w"] is params["w"]
    it = iter(linear_batches(2))
    eng.train_batch(it)
    eng.train_batch(it)
    assert sched.last_epoch == 0  # the engine never stepped it
    assert not torch.equal(params["w"], torch.ones(4, 1))  # trained
    sched.step()
    assert eng.get_lr() == [0.05]
    # JAX: the same -- the scheduler comes back untouched
    jeng, _, _, jgot = dstpu.initialize(
        model=_jax_linear_loss,
        model_parameters={"w": np.ones((4, 1), np.float32)},
        config=_linear_cfg(0), lr_scheduler=sched)
    assert jgot is sched


@pytest.mark.parametrize("name", ["adamw", "sgd_momentum"])
@pytest.mark.parametrize("gas", [1, 2])
def test_client_optimizer_state_resumes_bit_for_bit(tmp_path, name, gas):
    build = {"adamw": lambda ps: torch.optim.AdamW(ps, lr=1e-2),
             "sgd_momentum": lambda ps: torch.optim.SGD(ps, lr=1e-2,
                                                        momentum=0.9)}[name]
    batches = fixed_batches(2, 5 * gas, seed=4)
    extra = {"gradient_accumulation_steps": gas,
             "optimizer": None, "gradient_clipping": 1.0}

    def engine(seed):
        model = zoo.get_model("tiny", device="cpu", seed=seed,
                              dtype=torch.float32, **TINY)
        cfg = {"train_micro_batch_size_per_chip": 2,
               "bf16": {"enabled": False}, "steps_per_print": 1_000_000,
               **{k: v for k, v in extra.items() if v is not None}}
        return deepspeed_tpu_torch.initialize(model=model, config=cfg,
                                              optimizer=build,
                                              device="cpu")[0]

    ref = engine(0)
    it = iter(batches)
    want = [float(ref.train_batch(it)) for _ in range(5)]
    a = engine(0)
    it = iter(batches)
    got = [float(a.train_batch(it)) for _ in range(2)]
    a.save_checkpoint(str(tmp_path))
    b = engine(1)
    b.load_checkpoint(str(tmp_path))
    assert b.update_count == 2
    st_a, st_b = a._client_opt.state_dict(), b._client_opt.state_dict()
    assert st_a["param_groups"] == st_b["param_groups"]
    for idx, st in st_a["state"].items():
        for key, value in st.items():
            assert torch.equal(value, st_b["state"][idx][key]), (idx, key)
    it = iter(batches[2 * gas:])
    got += [float(b.train_batch(it)) for _ in range(3)]
    assert got == want
    # without the optimizer state: the masters re-seeded, state cleared
    c = engine(1)
    c.load_checkpoint(str(tmp_path), load_optimizer_states=False)
    assert c.update_count == 0 and not c._client_opt.state


def test_functional_loss_fn_engine_equals_the_module_engine():
    """The zoo model's functional forward as a ``(loss_fn, params)``
    pair trains exactly as the module engine does from the same
    masters."""
    batches = fixed_batches(2, 3, seed=9)
    ref = make_engine(pipeline_depth=0)
    params = tree_map(lambda t: t.detach().clone(), ref.opt_state.master)
    cfg = transformer.TransformerConfig(dtype=torch.float32, **TINY)
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=lambda p, b: transformer.loss_fn(cfg, p, b),
        model_parameters=params,
        config={"train_micro_batch_size_per_chip": 2,
                "optimizer": {"type": "adamw", "params": {"lr": 1e-2}},
                "bf16": {"enabled": False}, "steps_per_print": 1_000_000},
        device="cpu")
    np.testing.assert_allclose(_four_steps(eng, batches),
                               _four_steps(ref, batches), rtol=1e-6)
    assert set(eng.module_state_dict()) == set(ref.module_state_dict())
