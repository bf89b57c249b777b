"""The engines' observability against the JAX package's.

Training: the port's and JAX's engines on one tiny Llama (fp32, the
dense path, the same fp32 masters through ``params_from_jax``) with the
same config and a JSONL path each give ``step_trace`` rows with the same
keys; loss, grad norm and lr agree at rtol 1e-5; tokens and
``flops_per_token`` are equal. The port's blocking and pipelined loops
give the same rows; the watchdog, the flight records, the profiler
window, the roofline and the dispatch export are driven on the CPU.
Serving: the port's and JAX's v2 engines serve the same requests with
the tracer on; ``snapshot()`` has JAX's keys (less ``handoff_wire``,
ROADMAP queue A item 13), the hub's serving counters are equal, and
every trace closes. The config keys that stopped raising are accepted,
and those that still raise name their item.
"""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as dstpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.models.transformer import TransformerConfig as JaxConfig
from deepspeed_tpu.models.transformer import TransformerLM as JaxLM
from deepspeed_tpu.models.zoo import get_model as jax_get_model
from deepspeed_tpu.observability import hub as j_hub
from deepspeed_tpu_torch.config.config import load_config
from deepspeed_tpu_torch.inference import InferenceEngineV2
from deepspeed_tpu_torch.models import zoo
from deepspeed_tpu_torch.models.convert import params_from_jax
from deepspeed_tpu_torch.models.transformer import TransformerConfig
from deepspeed_tpu_torch.observability import flight_recorder as p_fr
from deepspeed_tpu_torch.observability import hub as p_hub
from deepspeed_tpu_torch.observability.request_trace import \
    check_phase_closure
from deepspeed_tpu_torch.ops import attention as attn_ops

TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            max_seq_len=32, pos_emb="rope", norm="rmsnorm",
            activation="swiglu", tie_embeddings=False, remat=False)
LLAMA = dict(pos_emb="rope", norm="rmsnorm", activation="swiglu",
             num_kv_heads=1, ffn_size=128, tie_embeddings=False)
# the port's verify-round split of spec_steps (counters of its own)
PORT_STATS = {"spec_verify_kernel_rounds", "spec_verify_gather_fallbacks"}
# the JAX engine's migration ladder (ROADMAP queue A item 13)
MIGRATION_STATS = {"migrated_out", "migrated_in", "migrate_paged",
                   "migrate_recompute", "migrate_resume_tokens"}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch, tmp_path):
    monkeypatch.setenv("DSTPU_FLIGHT_DIR", str(tmp_path / "flight"))
    for mod in (j_hub, p_hub):
        mod.reset_hub()
    p_fr.reset_flight_recorder()
    yield
    for mod in (j_hub, p_hub):
        mod.reset_hub()
    p_fr.reset_flight_recorder()
    attn_ops.set_kernel_config(None)


@pytest.fixture(scope="module", autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def data_iter(batch, seq=17, seed=0, n_fixed=2):
    rng = np.random.default_rng(seed)
    fixed = [{"input_ids": rng.integers(0, 64, (batch, seq)).astype(np.int32)}
             for _ in range(n_fixed)]
    i = 0
    while True:
        yield fixed[i % n_fixed]
        i += 1


def _config(tmp_path, name, **obs):
    return {"train_micro_batch_size_per_chip": 2,
            "gradient_accumulation_steps": 2,
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
            "gradient_clipping": 1.0, "bf16": {"enabled": False},
            "zero_optimization": {"stage": 0}, "steps_per_print": 2,
            "observability": {"jsonl_path": str(tmp_path / f"{name}.jsonl"),
                              **obs}}


def _rows(path):
    return [json.loads(l) for l in open(path).read().splitlines()
            if json.loads(l).get("kind") == "step_trace"]


def _port_engine(cfg, masters=None, **perf):
    tcfg = TransformerConfig(dtype=torch.float32, attn_impl="xla", **TINY)
    if masters is None:
        model = zoo.get_model("tiny", device="cpu", seed=0,
                              dtype=torch.float32, attn_impl="xla", **TINY)
    else:
        model = params_from_jax(masters, tcfg, device="cpu")
    if perf:
        cfg = dict(cfg, performance=perf)
    eng, *_ = deepspeed_tpu_torch.initialize(model=model, config=cfg,
                                             device="cpu")
    return eng


def test_step_rows_match_the_jax_engine(devices, tmp_path):
    jcfg = _config(tmp_path, "jax")
    jmodel = JaxLM(JaxConfig(dtype=jnp.float32, attn_impl="xla", **TINY))
    jeng, *_ = dstpu.initialize(model=jmodel, config=dict(jcfg))
    masters = jax.tree.map(np.asarray, jeng.opt_state.master)
    pcfg = dict(_config(tmp_path, "port"),
                train_batch_size=jeng.train_batch_size)
    del pcfg["train_micro_batch_size_per_chip"]
    eng = _port_engine(pcfg, masters)
    rows_b = jeng.micro_batch_size * jeng.dp_world_size
    jit, pit = data_iter(rows_b, seed=5), data_iter(eng.micro_batch_size,
                                                    seed=5)
    for _ in range(3):
        jeng.train_batch(jit)
        eng.train_batch(pit)
    jeng.synchronize()
    eng.synchronize()
    want, got = _rows(tmp_path / "jax.jsonl"), _rows(tmp_path / "port.jsonl")
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w), set(g) ^ set(w)
        assert g["step"] == w["step"]
        assert g["tokens"] == w["tokens"] == 2 * 2 * 16 * 8
        assert g["flops_per_token"] == w["flops_per_token"]
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-5,
                                       err_msg=key)
        assert g["mfu"] == pytest.approx(
            g["tokens_per_sec_per_chip"] * g["flops_per_token"]
            / (g["peak_tflops"] * 1e12))
        assert g["n_chips"] == 1 and g["inflight"] == 0
    hub = p_hub.get_hub()
    assert hub.snapshot()["counters"]["train.steps"] == 3.0
    assert hub.window_mfu() == pytest.approx(
        sum(r["tokens"] for r in got)
        / (sum(r["wall_ms"] for r in got) / 1e3)
        * got[0]["flops_per_token"] / (got[0]["peak_tflops"] * 1e12))


def test_blocking_and_pipelined_loops_give_the_same_rows(tmp_path):
    rows = {}
    for depth in (0, 2):
        p_hub.reset_hub()
        cfg = _config(tmp_path, f"depth{depth}")
        eng = _port_engine(cfg, pipeline_depth=depth)
        it = data_iter(eng.micro_batch_size, seed=3)
        for _ in range(4):
            eng.train_batch(it)
        eng.synchronize()
        rows[depth] = _rows(tmp_path / f"depth{depth}.jsonl")
    for a, b in zip(rows[0], rows[2]):
        assert set(a) == set(b)
        for key in ("step", "tokens", "loss", "grad_norm", "lr",
                    "loss_scale", "overflow", "skipped_steps"):
            assert a[key] == b[key], key
    assert [r["inflight"] for r in rows[2]] == [2, 2, 1, 0]
    assert all(r["host_gap_ms"] > 0 for r in rows[2])


def test_flight_records_watchdog_and_stall_report(tmp_path):
    # a floor far above a tiny CPU step, even on a loaded machine: only
    # the held step may pass it
    cfg = _config(tmp_path, "wd", watchdog={"min_seconds": 1.0,
                                            "factor": 2.0})
    eng = _port_engine(cfg)
    it = data_iter(eng.micro_batch_size)
    for _ in range(6):  # the watchdog's warm-up
        eng.train_batch(it)
    kinds = [(k, f.get("step")) for _, k, f in eng.flight.events()]
    for step in range(1, 7):
        for kind in ("step_entry", "step_dispatch", "step_drain"):
            assert (kind, step) in kinds
    threshold = eng.watchdog.threshold()
    slept = []

    def hang(engine):
        if len(slept) == 1:
            time.sleep(threshold * 3 + 0.2)
        slept.append(True)

    eng.register_post_step_hook(hang)
    for _ in range(2):
        eng.train_batch(it)
    assert eng.watchdog.stalls == 1
    snap = p_hub.get_hub().snapshot()
    assert snap["counters"]["train.stalls"] == 1.0
    dump = json.load(open(tmp_path / "flight" /
                          "flight_rank0_watchdog.json"))
    events = [(e["kind"], e.get("step")) for e in dump["events"]]
    assert ("step_entry", 8) in events and ("step_drain", 7) in events
    reports = [json.loads(l) for l in open(tmp_path / "wd.jsonl")
               if '"stall_report"' in l]
    assert len(reports) == 1 and "python stacks:" in reports[0]["report"]
    eng.watchdog.stop()


def test_trace_window_roofline_and_dispatch_export(tmp_path, monkeypatch):
    monkeypatch.setenv("DSTPU_TRACE_STEPS", "2:3")
    monkeypatch.setenv("DSTPU_TRACE_DIR", str(tmp_path / "trace"))
    monkeypatch.setenv("DSTPU_ROOFLINE", "1")
    cfg = _config(tmp_path, "tr")
    model = zoo.get_model("tiny", device="cpu", seed=0, dtype=torch.float32,
                          attn_impl="auto", **dict(TINY, remat=True))
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=model, config=dict(cfg, performance={"pipeline_depth": 2}),
        device="cpu")
    it = data_iter(eng.micro_batch_size)
    for _ in range(4):
        eng.train_batch(it)
    eng.synchronize()
    cap = eng._trace_capture
    assert cap.done and os.path.exists(cap.trace_path)
    names = {e.get("name") for e in json.load(open(cap.trace_path))
             ["traceEvents"]}
    assert {"train_step#2", "train_step#3", "attention", "mlp", "norm",
            "rope", "vocab_head", "optimizer"} <= names
    assert "train_step#4" not in names
    events = [json.loads(l) for l in open(tmp_path / "tr.jsonl")]
    roof = [e for e in events if e["kind"] == "roofline"]
    assert len(roof) == 1 and roof[0]["bound"] in ("compute", "memory")
    assert roof[0]["peak_tflops"] == 1.0  # the CPU's placeholder
    summary = eng.roofline()
    assert summary["flops"] == roof[0]["flops"] > 0
    gauges = p_hub.get_hub().snapshot()["gauges"]
    assert "train.arithmetic_intensity" in gauges
    # one kernel_dispatch event per memoised decision (the engine's
    # set_kernel_config cleared the memo)
    dispatch = [e for e in events if e["kind"] == "kernel_dispatch"]
    assert len(dispatch) == len(attn_ops._DECISIONS) == 1
    assert dispatch[0]["source"] == "xla"
    assert gauges["kernel.attention.pallas"] == 0.0


def test_micro_step_api_timers_and_breakdown_switches(tmp_path, caplog):
    caplog.set_level("INFO")
    cfg = dict(_config(tmp_path, "micro"), wall_clock_breakdown=True,
               memory_breakdown=True, dump_state=True)
    eng = _port_engine(cfg)
    assert "engine init: ready" in caplog.text
    it = data_iter(eng.micro_batch_size)
    for _ in range(2):
        for _ in range(2):
            eng.backward(eng(next(it)))
            eng.step()
    for name in ("fwd", "bwd", "step"):
        assert len(eng.timers(name).records) >= 2
    kinds = [k for _, k, f in eng.flight.events() if f.get("api")]
    assert kinds == ["step_entry", "step_drain"] * 2
    it = data_iter(eng.micro_batch_size)
    eng.train_batch(it)
    eng.train_batch(it)
    assert "time (ms) | fwd:" in caplog.text
    assert eng.config.dump_state


def test_host_values_wait_on_the_step_event():
    """A step's host reads of its loss and grad norm wait on the step's
    event, after which the pinned copies have landed (the micro-step API
    reads them at once, with no drain between)."""
    from deepspeed_tpu_torch.runtime.engine import _InflightStep

    host = torch.zeros(2)

    class Event:
        def synchronize(self):
            host.copy_(torch.tensor([1.5, 0.25]))

    entry = _InflightStep(1, 1e-3, 1.0, False, Event(), host, 4)
    assert entry.values() == (1.5, 0.25)
    assert _InflightStep(1, 1e-3, 1.0, False, None, host, 4).values() == \
        (1.5, 0.25)


def test_observability_off_builds_nothing(tmp_path):
    eng = _port_engine(dict(_config(tmp_path, "off"),
                            observability={"enabled": False}))
    eng.train_batch(data_iter(eng.micro_batch_size))
    assert eng.hub is None and eng.watchdog is None and eng.flight is None
    assert not os.path.exists(tmp_path / "off.jsonl")


@pytest.mark.parametrize("extra", [
    {"observability": {"jsonl_path": "m.jsonl", "prometheus_path": "m.prom",
                       "prometheus_every_steps": 5, "step_history": 8,
                       "xla_cost_analysis": True, "flight_events": 0,
                       "publish_every_steps": 2, "stale_after_seconds": 9.0,
                       "watchdog": {"enabled": False, "factor": 4.0},
                       "request_trace": {"sample_rate": 1.0,
                                         "slo_deadline_ms": 50.0}}},
    {"monitor": {"csv_monitor": {"enabled": False}}},
    {"tensorboard": {"enabled": False}},
    {"csv_monitor": {"enabled": False, "job_name": "j"}},
    {"wandb": {"enabled": False}},
    {"comet": {"enabled": False}},
    {"wall_clock_breakdown": True},
    {"memory_breakdown": True},
    {"dump_state": True},
    {"observability": {"clock_sync": {"enabled": True},
                       "journal": {"enabled": False}}},
], ids=["observability", "monitor", "tensorboard", "csv_monitor", "wandb",
        "comet", "wall_clock_breakdown", "memory_breakdown", "dump_state",
        "clock_sync_journal_defaults"])
def test_ported_config_keys_are_accepted(extra):
    cfg = load_config(extra)
    assert cfg.observability.enabled
    if "tensorboard" in extra:
        assert cfg.monitor.tensorboard.enabled is False


@pytest.mark.parametrize("extra,error,match", [
    ({"observability": {"run_dir": "fleet"}}, NotImplementedError,
     "item 14's fleet part"),
    ({"compile": {"enabled": True}}, NotImplementedError, "item 16"),
    ({"observability": {"clock_sync": {"rounds": 4}}}, NotImplementedError,
     "item 13"),
    ({"observability": {"journal": {"enabled": True}}}, NotImplementedError,
     "item 13"),
    ({"flops_profiler": {"enabled": True}}, NotImplementedError, "item 16"),
    ({"observability": {"request_trace": {"sample_rate": 1.5}}}, ValueError,
     r"request_trace.sample_rate must be in \[0, 1\]"),
    ({"observability": {"request_trace": {"ring_size": 0}}}, ValueError,
     "ring_size must be >= 1"),
    ({"observability": {"request_trace": {"slo_deadline_ms": 0}}},
     ValueError, "slo_deadline_ms must be > 0"),
    ({"observability": {"flight_events": -1}}, ValueError,
     "flight_events must be >= 0"),
    ({"observability": {"publish_every_steps": 0}}, ValueError,
     "publish_every_steps must be >= 1"),
], ids=["run_dir", "compile", "clock_sync", "journal", "flops_profiler",
        "sample_rate", "ring_size", "slo_deadline", "flight_events",
        "publish_every"])
def test_config_keys_that_still_raise(extra, error, match):
    with pytest.raises(error, match=match):
        load_config(extra)
    if error is ValueError:  # JAX's message
        from deepspeed_tpu.config.config import load_config as jax_load

        with pytest.raises(ValueError, match=match):
            jax_load(extra)


# -- serving ------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_serve():
    jmodel = jax_get_model("tiny", dtype=jnp.float32,
                           param_dtype=jnp.float32, **LLAMA)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    cfg = zoo.get_config("tiny", dtype=torch.float32, **LLAMA)
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                            device="cpu")
    return jmodel, jparams, model


def _serve(eng, prompts, n):
    eng.put(list(range(len(prompts))), prompts, max_new_tokens=n)
    return eng.generate_all()


@pytest.mark.parametrize("kw", [
    {},
    {"kv_blocks": 13, "max_blocks_per_seq": 4, "prefix_cache": False},
    {"spec_decode": True, "spec_k": 3},
], ids=["plain", "overload", "spec"])
def test_v2_snapshot_keys_and_counters_equal_jax(tiny_serve, kw):
    jmodel, jparams, model = tiny_serve
    base = dict(kv_blocks=64, kv_block_size=8, max_tokens_per_step=32,
                max_seqs_per_step=4, max_blocks_per_seq=8,
                request_trace={"sample_rate": 1.0})
    base.update(kw)
    rng = np.random.default_rng(1)
    motif = rng.integers(0, 256, 6)
    prompts = [np.concatenate([motif, motif, motif,
                               rng.integers(0, 256, 2 + i)]).astype(np.int32)
               for i in range(6)]
    jeng = JaxEngine(jmodel, params=jparams, dtype=jnp.float32, **base)
    peng = InferenceEngineV2(model, device="cpu", **base)
    want, got = _serve(jeng, prompts, 8), _serve(peng, prompts, 8)
    assert got == want
    js, ps = jeng.snapshot(), peng.snapshot()
    assert set(ps) == set(js) - {"handoff_wire"}
    assert set(js["stats"]) - set(ps["stats"]) == MIGRATION_STATS
    assert set(ps["stats"]) - set(js["stats"]) == PORT_STATS
    for key in set(ps["stats"]) & set(js["stats"]):
        assert ps["stats"][key] == js["stats"][key], key
    for key in ("queue_depth", "queue_wait_depth", "kv_free_blocks",
                "scheduler", "request_trace", "batch_seq_occupancy"):
        assert ps[key] == js[key], key
    for key in ("ttft", "decode_token_latency", "step_latency",
                "admission_wait"):
        assert ps[key]["count"] == js[key]["count"], key
    jc = j_hub.get_hub().snapshot()["counters"]
    pc = p_hub.get_hub().snapshot()["counters"]
    assert pc == jc
    assert pc["serve.tokens_emitted"] == 6 * 8
    assert pc["serve.requests"] == 6
    traces = peng.request_traces()
    assert len(traces) == 6
    assert check_phase_closure(traces)["checked"] == 6
    summary = peng.log_summary()
    assert summary["admitted"] == js["stats"]["admitted"]


def test_monitor_that_cannot_write_warns_and_the_step_goes_on(
        tmp_path, monkeypatch, caplog):
    from deepspeed_tpu_torch.monitor import monitor

    cfg = dict(_config(tmp_path, "mon"), csv_monitor={
        "enabled": True, "output_path": str(tmp_path / "csv"),
        "job_name": "j"})
    eng = _port_engine(cfg)
    it = data_iter(eng.micro_batch_size)
    eng.train_batch(it)
    assert os.path.exists(tmp_path / "csv" / "j" /
                          "Train_Samples_train_loss.csv")

    def full_disk(self, events):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(monitor.CSVMonitor, "write_events", full_disk)
    eng.train_batch(it)
    eng.train_batch(it)
    assert eng.monitor is None and eng.global_steps == 3
    assert "monitor disabled after a write error" in caplog.text
    assert len(_rows(tmp_path / "mon.jsonl")) == 3
