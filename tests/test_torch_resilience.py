"""The port's resilience layer (``deepspeed_tpu_torch/resilience``,
``utils/telemetry.py``) against the JAX package's, which imports no JAX
there: the same inputs through both give the same outputs (chaos specs
and their errors, retry backoff, preemption flags, manifest-walking
fallbacks, checkpoint corruption, the data-stream fast-forward,
telemetry counters). Then the SIGTERM drill of ``tests/test_resilience.py``
(``test_sigterm_drains_and_resumes_bit_identical``) on the port: a
worker process (this file run as a script) is sent SIGTERM by the chaos
injector at step 3, lands an emergency checkpoint at that step's GAS
boundary and exits 0; a restarted worker resumes from it, and the loss
stream equals a fault-free run's exactly.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from deepspeed_tpu.resilience import chaos as jax_chaos
from deepspeed_tpu.resilience import manifest as jax_manifest
from deepspeed_tpu.resilience import policy as jax_policy
from deepspeed_tpu.resilience import preemption as jax_preemption
from deepspeed_tpu.resilience import resume as jax_resume
from deepspeed_tpu.runtime import dataloader as jax_dl
from deepspeed_tpu.utils import telemetry as jax_telemetry
from deepspeed_tpu_torch.resilience import (chaos, manifest, policy,
                                            preemption, resume)
from deepspeed_tpu_torch.runtime import dataloader as dl
from deepspeed_tpu_torch.utils import telemetry

HERE = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(HERE))
STEPS = 4


def _fields(spec):
    return {k: getattr(spec, k) for k in spec.__dataclass_fields__
            if not k.startswith("_")}


@pytest.mark.parametrize("text", [
    "",
    "kill_rank=1,kill_step=3,kill_signal=SIGKILL",
    "kill_step=3, kill_signal=SIGTERM",
    "collective_k=5,collective_mode=delay,collective_delay_s=2",
    "collective_k=2,collective_op=all_reduce",
    "stall_input_step=2,stall_input_s=1.5",
    "net_drop_frac=0.05,net_seed=7",
    "net_partition=r1:20,net_dup=3,net_corrupt=4,net_delay_ms=1.5",
])
def test_chaos_spec_parse_and_to_env_match_jax(text):
    got, want = chaos.ChaosSpec.parse(text), jax_chaos.ChaosSpec.parse(text)
    assert _fields(got) == _fields(want)
    assert got.to_env() == want.to_env()
    assert _fields(chaos.ChaosSpec.parse(got.to_env())) == _fields(got)
    assert got.partition_target() == want.partition_target()
    assert got.has_net_faults == want.has_net_faults


@pytest.mark.parametrize("text", [
    "kill_stpe=3", "kill_step", "kill_signal=SIGINT",
    "collective_mode=stall", "net_drop_frac=1.5", "net_partition=1:20",
    "net_partition=r1:0",
])
def test_chaos_spec_errors_match_jax(text):
    with pytest.raises(ValueError) as want:
        jax_chaos.ChaosSpec.parse(text)
    with pytest.raises(ValueError) as got:
        chaos.ChaosSpec.parse(text)
    assert str(got.value) == str(want.value)


def test_chaos_injector_is_inert_without_a_spec(monkeypatch):
    monkeypatch.delenv(chaos.CHAOS_ENV, raising=False)
    chaos.reset_chaos_injector()
    inj = chaos.get_chaos_injector()
    assert not inj.armed
    inj.on_step(3)
    inj.on_input_batch()
    inj.on_collective("all_reduce")
    assert inj.on_wire_tx(b"frame") == [b"frame"]
    monkeypatch.setenv(chaos.CHAOS_ENV, "collective_k=2")
    chaos.reset_chaos_injector()
    inj = chaos.get_chaos_injector()
    inj.on_collective("all_reduce")
    with pytest.raises(chaos.ChaosCollectiveError, match="#2"):
        inj.on_collective("all_reduce")
    chaos.reset_chaos_injector()


@pytest.mark.parametrize("net", ["net_dup=2,net_corrupt=3",
                                 "net_drop_frac=0.5,net_seed=3",
                                 "net_partition=r1:2"])
def test_chaos_wire_hooks_match_jax(net):
    frames = [bytes(range(i, i + 20)) for i in range(6)]
    got = chaos.ChaosInjector(chaos.ChaosSpec.parse(net))
    want = jax_chaos.ChaosInjector(jax_chaos.ChaosSpec.parse(net))
    for f in frames:
        assert got.on_wire_tx(f, peer=1) == want.on_wire_tx(f, peer=1)
        assert got.on_wire_rx(f, peer=1) == want.on_wire_rx(f, peer=1)
    assert got.net_stats == want.net_stats


@pytest.mark.parametrize("base,cap,attempts", [
    (1.0, 4.0, range(1, 11)), (0.5, 30.0, range(1, 8)),
    (0.0, 1.0, range(1, 4))])
def test_retry_backoff_matches_jax(base, cap, attempts):
    got = policy.RetryPolicy(backoff_base_s=base, backoff_max_s=cap,
                             jitter=0.0)
    want = jax_policy.RetryPolicy(backoff_base_s=base, backoff_max_s=cap,
                                  jitter=0.0)
    assert [got.backoff_s(a) for a in attempts] == [
        want.backoff_s(a) for a in attempts]


def test_retry_policy_retries_then_raises_typed():
    calls = []

    def flaky():
        calls.append(1)
        raise OSError("transient")

    p = policy.RetryPolicy(max_retries=2, backoff_base_s=0.0, jitter=0.0)
    with pytest.raises(policy.CommTimeoutError) as ei:
        p.run("unit_op", flaky, timeout_s=10.0)
    assert len(calls) == 3 and ei.value.attempts == 3
    assert ei.value.exit_code == jax_policy.TRANSIENT_EXIT_CODE == 75
    assert p.run("noop", lambda: 42) == 42  # no timeout: a plain call


def test_preemption_guard_matches_jax():
    got = preemption.PreemptionGuard(save_deadline_s=5)
    want = jax_preemption.PreemptionGuard(save_deadline_s=5)
    seq = []
    for g in (got, want):
        flags = [g.should_checkpoint(), g.requested]
        g.request("test")
        flags += [g.requested, g.should_checkpoint(), g.should_checkpoint(),
                  g.reason]
        g.reset()
        flags += [g.requested, g.should_checkpoint()]
        seq.append(flags)
    assert seq[0] == seq[1] == [False, False, True, True, False, "test",
                                False, False]


def test_telemetry_matches_jax():
    for t in (telemetry, jax_telemetry):
        t.reset()
        t.count("a", reason="x")
        t.count("a", reason="x")
        t.count("b")
    assert telemetry.snapshot() == jax_telemetry.snapshot() == {"a": 2,
                                                                "b": 1}
    assert telemetry.reasons("a") == jax_telemetry.reasons("a") == {"x": 2}
    telemetry.reset()
    jax_telemetry.reset()
    assert telemetry.get("a") == jax_telemetry.get("a") == 0


def _tag(root, name, saved_at=None, files=None):
    d = os.path.join(root, name)
    os.makedirs(os.path.join(d, "state"), exist_ok=True)
    for rel, data in (files or {"state/w.pt": b"abc" * 100}).items():
        with open(os.path.join(d, rel), "wb") as f:
            f.write(data)
    if saved_at is not None:
        jax_manifest.write_manifest(d, name, global_steps=1)
        path = os.path.join(d, jax_manifest.MANIFEST_FILE)
        with open(path) as f:
            doc = json.load(f)
        doc["saved_at"] = saved_at
        with open(path, "w") as f:
            json.dump(doc, f)
    return d


def _tree(root, case):
    """A checkpoint directory tree for one fallback scenario."""
    if case == "empty":
        return
    _tag(root, "old", saved_at=1.0)
    if case == "newest_valid":
        _tag(root, "new", saved_at=2.0)
    elif case == "newest_flipped":
        d = _tag(root, "new", saved_at=2.0)
        jax_chaos.corrupt_checkpoint(d, "flip")
    elif case == "newest_truncated":
        d = _tag(root, "new", saved_at=2.0)
        jax_chaos.corrupt_checkpoint(d, "truncate")
    elif case == "torn_manifest":
        d = _tag(root, "new", saved_at=2.0)
        jax_chaos.corrupt_checkpoint(d, "manifest")
    elif case == "manifest_less_newer":
        _tag(root, "legacy")
    elif case == "all_bad":
        jax_chaos.corrupt_checkpoint(os.path.join(root, "old"), "truncate")
        _tag(root, "legacy")
    elif case == "a_file_missing":
        d = _tag(root, "new", saved_at=2.0)
        os.remove(os.path.join(d, "state", "w.pt"))


@pytest.mark.parametrize("case", [
    "empty", "one_valid", "newest_valid", "newest_flipped",
    "newest_truncated", "torn_manifest", "manifest_less_newer", "all_bad",
    "a_file_missing"])
@pytest.mark.parametrize("exclude", [None, ["old"]])
@pytest.mark.parametrize("checksums", [True, False])
def test_find_latest_valid_tag_matches_jax(tmp_path, case, exclude,
                                           checksums):
    _tree(str(tmp_path), case)
    got = manifest.find_latest_valid_tag(str(tmp_path), exclude=exclude,
                                         check_checksums=checksums)
    want = jax_manifest.find_latest_valid_tag(
        str(tmp_path), exclude=exclude, check_checksums=checksums)
    assert got == want
    for name in sorted(os.listdir(tmp_path)):
        d = str(tmp_path / name)
        outcome = []
        for mod in (manifest, jax_manifest):
            try:
                doc = mod.validate_manifest(d, check_checksums=checksums)
                outcome.append(None if doc is None else doc["tag"])
            except mod.CheckpointCorruptError as e:
                outcome.append(e.reason)
        assert outcome[0] == outcome[1], name


@pytest.mark.parametrize("mode", ["flip", "truncate", "manifest"])
def test_corrupt_checkpoint_matches_jax(tmp_path, mode):
    a = _tag(str(tmp_path / "a"), "t", saved_at=1.0, files={
        "state/w.pt": bytes(range(256)) * 4, "state/b.pt": b"xy" * 10})
    b = str(tmp_path / "b" / "t")
    shutil.copytree(a, b)
    pa = chaos.corrupt_checkpoint(a, mode)
    pb = jax_chaos.corrupt_checkpoint(b, mode)
    assert os.path.relpath(pa, a) == os.path.relpath(pb, b)
    with open(pa, "rb") as fa, open(pb, "rb") as fb:
        assert fa.read() == fb.read()


def _items(it, n):
    return [np.asarray(next(it)["input_ids"]).tolist() for _ in range(n)]


def _data(n=10):
    rng = np.random.default_rng(3)
    return [{"input_ids": rng.integers(0, 50, (4,)).astype(np.int32)}
            for _ in range(n)]


@pytest.mark.parametrize("kind", ["plain", "repeating_state",
                                  "repeating_no_source"])
@pytest.mark.parametrize("consumed", [0, 3, 5, 12])
def test_resume_data_iter_matches_jax(kind, consumed):
    """The same cursor positions each package's own loader on the same
    next batches."""
    streams = []
    for mod, res in ((dl, resume), (jax_dl, jax_resume)):
        def make():
            inner = mod.DeepSpeedDataLoader(_data(), batch_size=2,
                                            shuffle=True, seed=7)
            return (iter(inner) if kind == "plain"
                    else mod.RepeatingLoader(inner))

        live = make()
        if kind == "plain":
            live_items = _items(live, min(consumed, 5))
        else:
            live_items = _items(live, consumed)
        cursor = {"version": 1, "boundaries_consumed": consumed,
                  "gas": 1, "microbatches_consumed": consumed}
        if kind == "repeating_state":
            cursor["loader"] = live.state_dict()
        fresh = make()
        source = fresh if kind == "repeating_state" else None
        fresh = res.resume_data_iter(fresh, cursor, source=source)
        n = 5 - min(consumed, 5) if kind == "plain" else 6
        streams.append((live_items, _items(fresh, n)))
    assert streams[0] == streams[1]
    if kind != "plain":
        live = dl.RepeatingLoader(dl.DeepSpeedDataLoader(
            _data(), batch_size=2, shuffle=True, seed=7))
        assert _items(live, consumed + 6)[consumed:] == streams[0][1]


def test_resume_data_iter_fresh_run_is_untouched():
    it = iter(range(3))
    assert resume.resume_data_iter(it, None) is it
    assert resume.resume_data_iter(it, {}) is it


# -- the SIGTERM drill -----------------------------------------------------------


def _wenv(chaos_spec="", restart=0):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop(chaos.CHAOS_ENV, None)
    if chaos_spec:
        env[chaos.CHAOS_ENV] = chaos_spec
    if restart:
        env["DSTPU_ELASTIC_RESTART_COUNT"] = str(restart)
    return env


def _run_worker(run_dir, **env):
    out = subprocess.run(
        [sys.executable, HERE, run_dir, "--steps", str(STEPS)],
        capture_output=True, text=True, timeout=300, env=_wenv(**env))
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _losses(run_dir):
    with open(os.path.join(run_dir, "losses.jsonl")) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    return {r["step"]: r["loss"] for r in rows}


def test_sigterm_drains_and_resumes_bit_identical(tmp_path):
    base = str(tmp_path / "base")
    _run_worker(base)
    baseline = _losses(base)
    assert sorted(baseline) == list(range(1, STEPS + 1))

    run_dir = str(tmp_path / "drill")
    out = _run_worker(run_dir,
                      chaos_spec="kill_rank=0,kill_step=3,kill_signal=SIGTERM")
    assert '"preempted": true' in out
    ckpt = os.path.join(run_dir, "ckpt")
    # the emergency save is committed and manifest-valid, in both packages
    assert manifest.find_latest_valid_tag(ckpt) == "global_step3"
    assert jax_manifest.validate_manifest(
        os.path.join(ckpt, "global_step3")) is not None
    assert sorted(_losses(run_dir)) == [1, 2, 3]

    out = _run_worker(run_dir, restart=1)
    assert '"final_step": 4' in out
    assert _losses(run_dir) == baseline


def _worker(argv) -> int:
    """One training process: a tiny port engine on the CPU, a shuffled
    repeating loader, a checkpoint every 2 steps with auto-resume, the
    chaos injector armed by DSTPU_CHAOS (disarmed after a restart, or
    the resumed run would be killed at the same step again). Per-step
    losses go to <run_dir>/losses.jsonl."""
    import argparse

    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import zoo

    p = argparse.ArgumentParser()
    p.add_argument("run_dir")
    p.add_argument("--steps", type=int, default=STEPS)
    args = p.parse_args(argv)
    if int(os.environ.get("DSTPU_ELASTIC_RESTART_COUNT", "0")) > 0:
        os.environ.pop(chaos.CHAOS_ENV, None)
    torch.set_num_threads(1)
    model = zoo.get_model("tiny", device="cpu", seed=0, dtype=torch.float32,
                          num_layers=2, hidden_size=32, num_heads=4,
                          vocab_size=64, max_seq_len=32, remat=False)
    engine = deepspeed_tpu_torch.initialize(model=model, config={
        "train_micro_batch_size_per_chip": 2,
        "gradient_accumulation_steps": 2,
        "optimizer": {"type": "adamw", "params": {"lr": 1e-2}},
        "steps_per_print": 10_000}, device="cpu")[0]
    rng = np.random.default_rng(42)
    rows = [{"input_ids": rng.integers(0, 64, (17,)).astype(np.int32)}
            for _ in range(12)]
    loader = dl.RepeatingLoader(dl.DeepSpeedDataLoader(
        rows, batch_size=2, shuffle=True, seed=7))
    data_iter = loader
    ckpt = os.path.join(args.run_dir, "ckpt")
    if os.path.exists(os.path.join(ckpt, "latest")):
        engine.load_checkpoint(ckpt)
        data_iter = engine.resume_data_iter(loader, source=loader)
    os.makedirs(args.run_dir, exist_ok=True)
    path = os.path.join(args.run_dir, "losses.jsonl")
    loss = None
    while engine.global_steps < args.steps:
        loss = float(engine.train_batch(data_iter))
        with open(path, "a") as f:
            f.write(json.dumps({"step": engine.global_steps, "loss": loss,
                                "pid": os.getpid()}) + "\n")
        if engine.preempted:
            print(json.dumps({"preempted": True,
                              "step": engine.global_steps}))
            return 0
        if engine.global_steps % 2 == 0 and engine.global_steps < args.steps:
            engine.save_checkpoint(ckpt)
    engine.save_checkpoint(ckpt)
    print(json.dumps({"final_step": engine.global_steps,
                      "final_loss": loss}))
    return 0


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1:]))
