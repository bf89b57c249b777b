"""The port's checkpoints and resilience layer against the JAX engine's
(``tests/test_resilience.py`` :288-398, ``tests/test_engine.py``
``test_checkpoint_save_load_roundtrip``).

The port's own guarantee is held exactly: train, "die", rebuild a fresh
engine (other weights) from the checkpoint and the data cursor, and the
remaining losses equal the uninterrupted run's (``==``), at GAS 1 and 2,
fp32 and bf16 compute, through ``train_batch`` and through ``forward``
/ ``backward`` / ``step``; fp16 resumes its loss scale too. Against JAX
(its engine on the 8-device CPU mesh, the port at world size 1 with the
JAX global micro batch; fp32, ``attn_impl="xla"``, weights carried over
by ``params_from_jax``): the data cursors are equal as dicts and the
resumed losses agree at rtol 1e-4 (``tests/test_torch_engine.py``'s
tolerance: fp32 sums in different orders). Each package validates the
other's manifests; JAX's ``corrupt_checkpoint`` on a port tag falls back
to the previous good tag, then refuses. C4: both packages warn on and
ignore DeepSpeed-style optimizer params, give the same first AdamW
update (rtol 1e-6, ``tests/test_torch_optimizer.py``'s) and raise on
``"fused-adam"``.
"""

import contextlib
import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as dstpu
import deepspeed_tpu_torch
from deepspeed_tpu.config import config as jax_config
from deepspeed_tpu.models.transformer import TransformerConfig as JaxConfig
from deepspeed_tpu.models.transformer import TransformerLM as JaxLM
from deepspeed_tpu.resilience import manifest as jax_manifest
from deepspeed_tpu.resilience.chaos import corrupt_checkpoint
from deepspeed_tpu.runtime import dataloader as jax_dl
from deepspeed_tpu.runtime import optimizer as jax_opt
from deepspeed_tpu.utils.logging import logger as jax_logger
from deepspeed_tpu_torch.config import config as config_mod
from deepspeed_tpu_torch.models import zoo
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.models.transformer import TransformerConfig
from deepspeed_tpu_torch.resilience import manifest
from deepspeed_tpu_torch.resilience.resume import data_cursor
from deepspeed_tpu_torch.runtime import dataloader as dl
from deepspeed_tpu_torch.runtime import optimizer as opt
from deepspeed_tpu_torch.utils import telemetry

TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            max_seq_len=32, pos_emb="learned", norm="layernorm",
            activation="gelu", tie_embeddings=True, remat=False,
            attn_impl="xla")
SEQ = 17  # 16 next-token targets
DTYPES = {"fp32": {"bf16": {"enabled": False}},
          "bf16": {"bf16": {"enabled": True}},
          # a window of 2 moves the scale during the run
          "fp16": {"fp16": {"enabled": True, "initial_scale_power": 8,
                            "loss_scale_window": 2}}}


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _config(gas=2, dtype="fp32", micro=2, **extra):
    cfg = {"train_micro_batch_size_per_chip": micro,
           "gradient_accumulation_steps": gas,
           "optimizer": {"type": "adamw", "params": {"lr": 1e-2}},
           "scheduler": {"type": "WarmupLR",
                         "params": {"warmup_num_steps": 4}},
           "gradient_clipping": 1.0, "steps_per_print": 10_000}
    cfg.update(DTYPES[dtype])
    cfg.update(extra)
    return cfg


def _engine(gas=2, dtype="fp32", seed=0, **extra):
    model = zoo.get_model("tiny", device="cpu", seed=seed,
                          dtype=torch.float32, **TINY)
    return deepspeed_tpu_torch.initialize(
        model=model, config=_config(gas, dtype, **extra), device="cpu")[0]


def _rows(n=12, seed=42):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, 64, (SEQ,)).astype(np.int32)}
            for _ in range(n)]


def _loader(batch=2, mod=dl, n=12):
    """Shuffled, seeded, repeating: 12 rows make 6 microbatches an epoch,
    so a 5-step GAS 2 run restarts the epoch mid-run."""
    return mod.RepeatingLoader(mod.DeepSpeedDataLoader(
        _rows(n), batch_size=batch, shuffle=True, seed=7))


def _steps(engine, it, n, api):
    """n optimizer steps; each step's mean microbatch loss."""
    out = []
    for _ in range(n):
        if api == "train_batch":
            out.append(float(engine.train_batch(it)))
            continue
        for _ in range(engine.gradient_accumulation_steps):
            engine.backward(engine(next(it)))
            engine.step()
        out.append(float(engine.last_metrics["loss"]))
    return out


def _resumed(tmp_path, gas, dtype, api, **extra):
    """(uninterrupted 5-step losses and engine, 2 + 3 resumed losses and
    the resumed engine)."""
    ref_eng = _engine(gas, dtype, **extra)
    ref = _steps(ref_eng, _loader(), 5, api)
    eng = _engine(gas, dtype, **extra)
    got = _steps(eng, _loader(), 2, api)
    eng.save_checkpoint(str(tmp_path))
    eng._ckpt_io.commit_pending()
    del eng
    eng2 = _engine(gas, dtype, seed=1, **extra)  # nothing carries over
    eng2.load_checkpoint(str(tmp_path))
    assert eng2.loaded_data_cursor["boundaries_consumed"] == 2
    loader = _loader()
    it = eng2.resume_data_iter(loader, source=loader)
    got += _steps(eng2, it, 3, api)
    return ref, ref_eng, got, eng2


@pytest.mark.parametrize("api", ["train_batch", "micro_steps"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("gas", [1, 2])
def test_kill_and_resume_is_bit_identical(tmp_path, gas, dtype, api):
    ref, ref_eng, got, eng = _resumed(tmp_path, gas, dtype, api)
    assert got == ref  # bit-identical, not allclose
    assert eng.global_steps == 5 and eng.get_lr() == ref_eng.get_lr()
    for (path, a), (_, b) in zip(opt.leaves(eng.opt_state.master),
                                 opt.leaves(ref_eng.opt_state.master)):
        assert torch.equal(a, b), path


def test_fp16_resume_keeps_the_loss_scale(tmp_path):
    ref, ref_eng, got, eng = _resumed(tmp_path, 2, "fp16", "train_batch")
    assert got == ref
    assert eng.loss_scale_state == ref_eng.loss_scale_state
    assert eng.loss_scale != 2.0 ** 8  # the scale moved and came back
    assert eng.skipped_steps == ref_eng.skipped_steps


def test_save_inside_an_accumulation_window(tmp_path):
    """As in JAX: a save between microbatches holds the last update's
    state and a cursor of whole windows; the running engine carries on
    undisturbed, and a resume replays the window's microbatches."""
    ref = _steps(_engine(), _loader(), 5, "micro_steps")
    eng = _engine()
    it = _loader()
    got = _steps(eng, it, 2, "micro_steps")
    eng.backward(eng(next(it)))  # half of step 3's window
    eng.save_checkpoint(str(tmp_path))
    eng.backward(eng(next(it)))
    eng.step()
    got.append(float(eng.last_metrics["loss"]))
    got += _steps(eng, it, 2, "micro_steps")
    assert got == ref
    eng2 = _engine(seed=1)
    eng2.load_checkpoint(str(tmp_path))
    assert eng2.global_steps == 2 and eng2.micro_steps == 0
    loader = _loader()
    it2 = eng2.resume_data_iter(loader, source=loader)
    assert _steps(eng2, it2, 3, "micro_steps") == ref[2:]


def test_checkpoint_save_load_roundtrip(tmp_path):
    eng = _engine(dtype="bf16")
    it = _loader()
    _steps(eng, it, 3, "train_batch")
    path = eng.save_checkpoint(str(tmp_path), client_state={"note": "hi"})
    assert path == os.path.join(str(tmp_path), "global_step3")
    assert (tmp_path / "latest").read_text() == "global_step3"
    eng2 = _engine(dtype="bf16", seed=1)
    ckpt_dir, client = eng2.load_checkpoint(str(tmp_path))
    assert ckpt_dir == path and client == {"note": "hi"}
    assert (eng2.global_steps, eng2.global_samples) == (3, 3 * 4)
    for (p, a), (_, b) in zip(opt.leaves(eng.params),
                              opt.leaves(eng2.params)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b), p
    assert np.isfinite(float(eng2.train_batch(it)))
    # an empty directory loads nothing
    assert _engine().load_checkpoint(str(tmp_path / "none")) == (None,
                                                                 None)


def test_restore_is_in_place():
    """The GAS > 1 hooks hang on the engine's compute params and an fp32
    model shares its tensors with the masters: a load copies into them."""
    import tempfile

    eng = _engine(gas=2)
    _steps(eng, _loader(), 2, "train_batch")
    d = tempfile.mkdtemp()
    eng.save_checkpoint(d)
    eng2 = _engine(gas=2, seed=1)
    before = {p: t.data_ptr() for p, t in opt.leaves(eng2.params)}
    model_wq = eng2.model.params()["layers"]["attn"]["wq"]
    eng2.load_checkpoint(d)
    assert {p: t.data_ptr() for p, t in opt.leaves(eng2.params)} == before
    assert torch.equal(model_wq,
                       eng.opt_state.master["layers"]["attn"]["wq"])


def test_load_without_optimizer_states(tmp_path, monkeypatch, caplog):
    eng = _engine(dtype="bf16")
    _steps(eng, _loader(), 2, "train_batch")
    eng.save_checkpoint(str(tmp_path))
    read = []
    real_load = torch.load

    def spy(f, *a, **kw):
        read.append(os.path.relpath(f, str(tmp_path)))
        return real_load(f, *a, **kw)

    monkeypatch.setattr(torch, "load", spy)
    eng2 = _engine(dtype="bf16", seed=1)
    with caplog.at_level(logging.WARNING):
        eng2.load_checkpoint(str(tmp_path), load_optimizer_states=False)
    assert "optimizer state not restored" in caplog.text
    assert read and not any(part.startswith("opt_") for f in read
                            for part in f.split(os.sep))
    for (p, m), (_, w) in zip(opt.leaves(eng2.opt_state.master),
                              opt.leaves(eng2.params)):
        assert torch.equal(m, w.float()), p
    for _, t in (*opt.leaves(eng2.opt_state.mu),
                 *opt.leaves(eng2.opt_state.nu)):
        assert not t.any()
    assert eng2.opt_state.count == 0 and eng2.global_steps == 2
    for (p, a), (_, b) in zip(opt.leaves(eng.params),
                              opt.leaves(eng2.params)):
        assert torch.equal(a, b), p


def test_a_payload_of_another_model_changes_nothing(tmp_path):
    eng = _engine()
    eng.save_checkpoint(str(tmp_path))
    other = zoo.get_model("tiny", device="cpu", seed=0, dtype=torch.float32,
                          **dict(TINY, hidden_size=48))
    eng2 = deepspeed_tpu_torch.initialize(model=other, config=_config(),
                                          device="cpu")[0]
    before = {p: t.clone() for p, t in opt.leaves(eng2.opt_state.master)}
    with pytest.raises(ValueError, match="saved"):
        eng2.load_checkpoint(str(tmp_path))
    for p, t in opt.leaves(eng2.opt_state.master):
        assert torch.equal(t, before[p]), p


@pytest.mark.parametrize("commit", ["next_boundary", "commit_pending"])
def test_async_save_publishes_after_the_write(tmp_path, commit):
    ref = _steps(_engine(), _loader(), 5, "train_batch")
    async_cfg = {"checkpoint": {"async_save": True}}
    eng = _engine(**async_cfg)
    it = _loader()
    got = _steps(eng, it, 2, "train_batch")
    d = eng.save_checkpoint(str(tmp_path))
    assert not (tmp_path / "latest").exists()
    assert not os.path.exists(os.path.join(d, manifest.MANIFEST_FILE))
    if commit == "next_boundary":
        # the update runs in place while the write may be in flight: the
        # checkpoint still holds step 2
        got += _steps(eng, it, 1, "train_batch")
        eng._ckpt_io.ckpt_engine._wait()
        eng._ckpt_io.maybe_commit()
    else:
        eng._ckpt_io.commit_pending()
    assert (tmp_path / "latest").read_text() == "global_step2"
    assert manifest.validate_manifest(d)["tag"] == "global_step2"
    eng2 = _engine(seed=1, **async_cfg)
    eng2.load_checkpoint(str(tmp_path))
    loader = _loader()
    got2 = got[:2] + _steps(eng2, eng2.resume_data_iter(loader, loader), 3,
                            "train_batch")
    assert got2 == ref


@pytest.mark.parametrize("mode", ["flip", "truncate", "manifest"])
def test_corrupt_checkpoint_falls_back_then_raises(tmp_path, mode):
    eng = _engine()
    it = _loader()
    eng.train_batch(it)
    eng.save_checkpoint(str(tmp_path))
    eng.train_batch(it)
    eng.save_checkpoint(str(tmp_path))
    corrupt_checkpoint(str(tmp_path / "global_step2"), mode=mode)

    telemetry.reset()
    eng2 = _engine(seed=1)
    eng2.load_checkpoint(str(tmp_path))  # falls back, never silent-bad
    assert eng2.global_steps == 1
    assert telemetry.get("resilience.corrupt_checkpoint") == 1

    # no good tag left -> typed refusal, not a garbage restore
    corrupt_checkpoint(str(tmp_path / "global_step1"), mode="truncate")
    with pytest.raises(manifest.CheckpointCorruptError):
        _engine().load_checkpoint(str(tmp_path))


def test_manifest_less_tag_is_accepted_with_a_warning(tmp_path, caplog):
    eng = _engine()
    eng.train_batch(_loader())
    eng.save_checkpoint(str(tmp_path))
    os.remove(tmp_path / "global_step1" / manifest.MANIFEST_FILE)
    with caplog.at_level(logging.WARNING):
        _engine().load_checkpoint(str(tmp_path))
    assert "has no manifest" in caplog.text


@pytest.mark.parametrize("api", ["train_batch", "micro_steps"])
def test_emergency_checkpoint_on_preemption(tmp_path, api):
    eng = _engine()
    it = _loader()
    _steps(eng, it, 1, api)
    eng.save_checkpoint(str(tmp_path))  # establishes the save dir
    eng._preempt_guard.request("test")
    _steps(eng, it, 1, api)  # the emergency save at the GAS boundary
    assert eng.preempted
    d = str(tmp_path / "global_step2")
    assert manifest.validate_manifest(d) is not None
    assert jax_manifest.validate_manifest(d) is not None


def test_module_state_dict_and_strict_load(parity):
    eng = _engine(dtype="bf16")
    sd = eng.module_state_dict()
    assert sorted(sd) == sorted(parity["jax_module_keys"])
    assert all(v.dtype == np.float32 for v in sd.values())
    eng2 = _engine(dtype="bf16", seed=1)
    eng2.load_module_state_dict(sd)
    for (p, a), (_, b) in zip(opt.leaves(eng.params),
                              opt.leaves(eng2.params)):
        assert torch.equal(a, b), p
    key = "layers.attn.wq"
    assert torch.equal(eng2.opt_state.master["layers"]["attn"]["wq"],
                       torch.from_numpy(sd[key]))
    with pytest.raises(KeyError, match="missing keys"):
        eng2.load_module_state_dict({k: v for k, v in sd.items()
                                     if k != key})
    with pytest.raises(KeyError, match="unexpected keys: \\['extra'\\]"):
        eng2.load_module_state_dict(dict(sd, extra=sd[key]))
    eng2.load_module_state_dict({key: np.zeros_like(sd[key])},
                                strict=False)
    assert not eng2.params["layers"]["attn"]["wq"].any()


# -- against the JAX engine ------------------------------------------------------


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    """The JAX engine and the port from the same fp32 masters: 2 steps,
    save, load into a fresh engine (JAX: the same one), reposition a new
    loader, 3 steps."""
    jdir = str(tmp_path_factory.mktemp("jax_ckpt"))
    pdir = str(tmp_path_factory.mktemp("port_ckpt"))
    cfg = _config(dtype="fp32", optimizer={
        "type": "adamw", "params": {"lr": 1e-3}})
    # the JAX cursor leaves the loader state out while its input
    # prefetcher runs; the port has none (ROADMAP queue A item 4)
    jeng, *_ = dstpu.initialize(
        model=JaxLM(JaxConfig(dtype=jnp.float32, **TINY)),
        config=dict(cfg, performance={"prefetch_depth": 0}))
    masters = jax.tree.map(np.asarray, jeng.opt_state.master)
    rows = jeng.micro_batch_size * jeng.dp_world_size
    pcfg = dict(cfg, train_batch_size=jeng.train_batch_size)
    del pcfg["train_micro_batch_size_per_chip"]

    def port():
        model = params_from_jax(masters, TransformerConfig(
            dtype=torch.float32, **TINY), device="cpu")
        return deepspeed_tpu_torch.initialize(model=model, config=pcfg,
                                              device="cpu")[0]

    jit = iter(_loader(rows, jax_dl, n=40))
    [float(jeng.train_batch(jit)) for _ in range(2)]
    jeng.save_checkpoint(jdir)
    jeng.load_checkpoint(jdir)
    jl = _loader(rows, jax_dl, n=40)
    jit = jeng.resume_data_iter(iter(jl), source=jl)
    jax_resumed = [float(jeng.train_batch(jit)) for _ in range(3)]

    eng = port()
    assert eng.micro_batch_size == rows
    pit = _loader(rows, n=40)
    [float(eng.train_batch(pit)) for _ in range(2)]
    cursor = data_cursor(eng)
    eng.save_checkpoint(pdir)
    eng2 = port()
    eng2.load_checkpoint(pdir)
    pl = _loader(rows, n=40)
    port_resumed = _steps(eng2, eng2.resume_data_iter(pl, source=pl), 3,
                          "train_batch")
    return {"jdir": jdir, "pdir": pdir, "jax_cursor": jeng.loaded_data_cursor,
            "cursor": cursor, "loaded_cursor": eng2.loaded_data_cursor,
            "jax_resumed": jax_resumed, "port_resumed": port_resumed,
            "jax_module_keys": list(jeng.module_state_dict())}


def test_data_cursor_equals_the_jax_engines(parity):
    assert parity["cursor"] == parity["jax_cursor"]
    assert parity["loaded_cursor"] == parity["jax_cursor"]
    # 2 microbatches an epoch: the fourth pull started epoch 1
    assert parity["cursor"]["loader"]["epoch"] == 1


def test_resumed_losses_match_the_jax_engine(parity):
    np.testing.assert_allclose(parity["port_resumed"], parity["jax_resumed"],
                               rtol=1e-4)


def test_each_package_validates_the_others_manifests(parity):
    jdir, pdir = parity["jdir"], parity["pdir"]
    for validate, find in ((jax_manifest.validate_manifest,
                            jax_manifest.find_latest_valid_tag),
                           (manifest.validate_manifest,
                            manifest.find_latest_valid_tag)):
        for d in (jdir, pdir):
            assert find(d) == "global_step2"
            doc = validate(os.path.join(d, "global_step2"))
            assert doc["tag"] == "global_step2" and doc["global_steps"] == 2
    with open(os.path.join(jdir, "global_step2", "metadata.json")) as f:
        jmeta = json.load(f)
    with open(os.path.join(pdir, "global_step2", "metadata.json")) as f:
        pmeta = json.load(f)
    assert sorted(pmeta) == sorted(jmeta)
    assert pmeta["world_size"] == 1
    assert set(pmeta["mesh_shape"]) == set(jmeta["mesh_shape"])
    assert pmeta["data_cursor"] == jmeta["data_cursor"]


# -- C4: optimizer params JAX ignores ------------------------------------------


@contextlib.contextmanager
def _warnings_of(logger):
    """The messages ``logger`` emits (the JAX logger does not propagate
    to the root, so caplog would not see it)."""
    got = []

    class _Handler(logging.Handler):
        def emit(self, record):
            got.append(record.getMessage())

    handler = _Handler(logging.WARNING)
    logger.addHandler(handler)
    try:
        yield got
    finally:
        logger.removeHandler(handler)


def test_c4_unknown_optimizer_params_warn_and_are_ignored():
    block = {"type": "AdamW", "params": {"lr": 1e-2, "bias_correction": True,
                                        "amsgrad": False}}
    with _warnings_of(jax_logger) as jwarn:
        jtx, _ = jax_opt.get_base_optimizer(
            jax_config.load_config({"optimizer": block}).optimizer)
    with _warnings_of(logging.getLogger(opt.__name__)) as warn:
        tx, _ = opt.get_base_optimizer(
            config_mod.load_config({"optimizer": block}).optimizer)
    assert jwarn == warn == [
        "optimizer 'AdamW': ignoring params ['amsgrad', 'bias_correction']"]

    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((4, 8)).astype(np.float32),
              "b": {"c": rng.standard_normal(16).astype(np.float32)}}
    grads = jax.tree.map(lambda x: rng.standard_normal(x.shape)
                         .astype(np.float32), params)
    jstate = jax_opt.init_mixed_precision(jax.tree.map(jnp.asarray, params),
                                          jtx)
    _, jstate, _ = jax_opt.apply_mixed_precision_update(
        jstate, jax.tree.map(jnp.asarray, grads), jtx, jnp.float32)
    state = opt.init_mixed_precision(opt.tree_map(torch.from_numpy, params),
                                     tx)
    opt.apply_mixed_precision_update(
        state, opt.tree_map(torch.from_numpy, grads), tx)
    want = dict(opt.leaves(jax.tree.map(np.asarray, jstate.master)))
    for path, got in opt.leaves(state.master):
        np.testing.assert_allclose(got.numpy(), want[path], rtol=1e-6,
                                   atol=1e-9, err_msg=path)


def test_c4_type_names_normalise_as_in_jax():
    for name in ("fused-adam", "adam-w"):
        with pytest.raises(ValueError, match="unknown optimizer type"):
            jax_opt.get_base_optimizer(jax_config.OptimizerConfig(type=name))
        with pytest.raises(ValueError, match="unknown optimizer type"):
            opt.get_base_optimizer(config_mod.OptimizerConfig(type=name))
    with pytest.raises(ValueError, match="unknown optimizer type"):
        deepspeed_tpu_torch.initialize(
            model=zoo.get_model("tiny", device="cpu", dtype=torch.float32,
                                **TINY),
            config={"optimizer": {"type": "fused-adam"}}, device="cpu")
