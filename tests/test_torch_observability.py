"""The port's observability modules against the JAX package's.

The same inputs go through ``deepspeed_tpu.observability`` and
``deepspeed_tpu_torch.observability``: histogram percentiles and
Prometheus lines, the sinks' rendered text, ``StepTrace`` rows, the
roofline math, the hub's snapshot and page after one script of gauges,
counters and steps, the stall watchdog's cases, the flight recorder's
dump (and its SIGTERM chain with the preemption guard, in both orders,
in a subprocess with a deadline), the clock-sync estimator and the
profiler window parser. The rendered pages differ only in their first
line (a wall-clock stamp). The port's own parts: the card's peak table,
the timers, the memory counters on the CPU, the region ranges and the
kernel builds as compile events.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from deepspeed_tpu.observability import clocksync as j_clock
from deepspeed_tpu.observability import flight_recorder as j_fr
from deepspeed_tpu.observability import histogram as j_hist
from deepspeed_tpu.observability import hub as j_hub
from deepspeed_tpu.observability import profile_trace as j_prof
from deepspeed_tpu.observability import roofline as j_roof
from deepspeed_tpu.observability import sinks as j_sinks
from deepspeed_tpu.observability import step_trace as j_step
from deepspeed_tpu.observability import watchdog as j_wd
from deepspeed_tpu.utils import telemetry as j_tel
from deepspeed_tpu_torch.observability import clocksync as p_clock
from deepspeed_tpu_torch.observability import flight_recorder as p_fr
from deepspeed_tpu_torch.observability import histogram as p_hist
from deepspeed_tpu_torch.observability import hub as p_hub
from deepspeed_tpu_torch.observability import profile_trace as p_prof
from deepspeed_tpu_torch.observability import roofline as p_roof
from deepspeed_tpu_torch.observability import sinks as p_sinks
from deepspeed_tpu_torch.observability import step_trace as p_step
from deepspeed_tpu_torch.observability import watchdog as p_wd
from deepspeed_tpu_torch.utils import telemetry as p_tel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh():
    for mod in (j_hub, p_hub):
        mod.reset_hub()
    for tel in (j_tel, p_tel):
        tel.reset()
    yield
    for mod in (j_hub, p_hub):
        mod.reset_hub()
    for tel in (j_tel, p_tel):
        tel.reset()


def _values(seed=0, n=500):
    rng = np.random.default_rng(seed)
    vals = list(rng.lognormal(-4.0, 1.5, n))
    return vals + [0.0, 1e-7, 999.0, float("nan"), -1.0]


def _body(text):
    """A rendered page without its first (time-stamped) line."""
    return text.split("\n", 1)[1]


# -- histogram ---------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_histogram_percentiles_and_lines_equal_jax(seed):
    hs = [mod.Histogram("serve.ttft_seconds") for mod in (j_hist, p_hist)]
    for v in _values(seed):
        for h in hs:
            h.observe(v)
    for p in (0, 1, 10, 50, 90, 95, 99, 99.9, 100):
        assert hs[1].percentile(p) == hs[0].percentile(p)
    assert hs[1].snapshot() == hs[0].snapshot()
    assert hs[1].prometheus_lines("dstpu_x") == \
        hs[0].prometheus_lines("dstpu_x")
    assert hs[1]._bounds == hs[0]._bounds


def test_histogram_value_past_the_ladder_is_overflow():
    h = p_hist.Histogram("x")
    h.observe(5e3)  # past hi = 1e3 (JAX's index runs off the ladder)
    assert h._counts[-1] == 1 and h.count == 1
    assert h.percentile(50) == 5e3


# -- sinks -------------------------------------------------------------------


def _page_inputs(mod):
    h = mod.Histogram("serve.step_seconds")
    for v in _values(3, 50):
        h.observe(v)
    labeled = j_sinks.labeled_name("serve.queue_depth",
                                   {"replica": 'r"0\n'})
    gauges = {"train.loss": 1.25, labeled: 3.0, "9lives": 2.0}
    counters = {"train.steps": 4.0, "serve.requests_total": 2.0}
    hists = {"serve.step_seconds": h,
             j_sinks.labeled_name("serve.ttft_seconds",
                                  {"replica": "r1"}): h}
    return gauges, counters, hists


def test_sinks_render_equal_jax(tmp_path):
    for name in ("serve.ttft_seconds", "a/b.c-d", "9x", "x{y}"):
        assert p_sinks.prometheus_name(name) == j_sinks.prometheus_name(name)
    for value in ('a"b\\c\nd', "plain"):
        assert p_sinks.escape_label_value(value) == \
            j_sinks.escape_label_value(value)
    labels = {"replica": "r0", "zone": 'x"y'}
    assert p_sinks.labeled_name("m", labels) == \
        j_sinks.labeled_name("m", labels)
    pages = [mod.render_prometheus(*_page_inputs(hmod),
                                   labeled_counters={"capability_fallback":
                                                     {'a"b': 2.0}})
             for mod, hmod in ((j_sinks, j_hist), (p_sinks, p_hist))]
    assert _body(pages[1]) == _body(pages[0])
    # the JSONL line and the atomic text file
    rows = []
    for mod in (j_sinks, p_sinks):
        path = tmp_path / f"{mod.__name__}.jsonl"
        sink = mod.JSONLSink(str(path))
        sink.write({"kind": "x", "v": np.float32(1.5), "t": torch.tensor(2)})
        sink.close()
        rows.append(path.read_text())
        prom = mod.PrometheusTextSink(str(tmp_path / f"{mod.__name__}.prom"))
        prom.write_text("a 1\n")
        assert (tmp_path / f"{mod.__name__}.prom").read_text() == "a 1\n"
        assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    assert json.loads(rows[1]) == {"kind": "x", "v": 1.5, "t": 2}
    assert json.loads(rows[0])["v"] == 1.5


def test_sink_that_cannot_write_warns_and_goes_on(tmp_path, caplog):
    sink = p_sinks.JSONLSink(str(tmp_path / "m.jsonl"))
    sink._fh.close()  # a write now fails
    sink.write({"kind": "x"})
    sink.write({"kind": "y"})
    assert sink._failed
    assert "disabled after error" in caplog.text


# -- step trace and roofline ---------------------------------------------------


STEP = dict(step=3, wall_ms=120.5, tokens=4096, tokens_per_sec=3e4,
            tokens_per_sec_per_chip=3e4, loss=2.5, grad_norm=0.75,
            lr=1e-4, loss_scale=1.0, mfu=0.31, mfu_source="model",
            flops_per_token=6e9, peak_tflops=989.0, host_gap_ms=1.5,
            inflight=1, compile_events=1, compile_secs=0.5,
            comm_bytes_total={"all_reduce": 64.0}, timestamp=123.0)


def test_step_trace_rows_equal_jax():
    rows = [mod.StepTrace(**STEP).to_dict() for mod in (j_step, p_step)]
    assert rows[1] == rows[0]
    bare = [mod.StepTrace(step=1, wall_ms=1.0, timestamp=0.0).to_dict()
            for mod in (j_step, p_step)]
    assert bare[1] == bare[0]


@pytest.mark.parametrize("cost,peak,hbm,secs", [
    ({"flops": 2e12, "bytes_accessed": 1e9}, 989.0, 3350.0, None),
    ({"flops": 1e9, "bytes_accessed": 1e9}, 989.0, 3350.0, 0.01),
    ({"flops": 5e13, "bytes_accessed": 2e10}, 197.0, 819.0, 0.5),
    ({"flops": 0.0, "bytes_accessed": 0.0}, 1.0, 100.0, 1.0),
])
def test_roofline_summary_equals_jax(cost, peak, hbm, secs):
    assert p_roof.roofline_summary(cost, peak, hbm, secs) == \
        j_roof.roofline_summary(cost, peak, hbm, secs)
    assert p_roof.mfu(3e4, 6e9, peak) == j_roof.mfu(3e4, 6e9, peak)


def test_peak_table_is_the_cards(monkeypatch, caplog):
    assert p_roof.PEAK_TFLOPS == {"h100 80gb hbm3": 989.0}
    assert p_roof.HBM_GBPS == {"h100 80gb hbm3": 3350.0}
    # CPU tensors take the named placeholders
    assert p_roof.detect_peak_tflops("cpu") == p_roof.CPU_PEAK_TFLOPS == 1.0
    assert p_roof.detect_hbm_gbps("cpu") == p_roof.CPU_HBM_GBPS == 100.0
    monkeypatch.setenv("BENCH_PEAK_TFLOPS", "500")
    monkeypatch.setenv("BENCH_HBM_GBPS", "2000")
    assert p_roof.detect_peak_tflops("cpu") == 500.0
    assert p_roof.detect_hbm_gbps("cpu") == 2000.0
    monkeypatch.delenv("BENCH_PEAK_TFLOPS")
    monkeypatch.delenv("BENCH_HBM_GBPS")
    # a card in the table, and one that is not (warned once, no peak)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    assert p_roof.detect_peak_tflops("cuda") == 989.0
    assert p_roof.detect_hbm_gbps("cuda") == 3350.0
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "Some Other Card")
    assert p_roof.detect_peak_tflops("cuda") is None
    assert p_roof.detect_hbm_gbps("cuda") is None
    assert "Some Other Card" in caplog.text


# -- the hub -------------------------------------------------------------------


def _hub_script(hub_mod, step_mod):
    hub = hub_mod.get_hub()
    hub.gauge("x", 1.5)
    hub.gauge("serve.queue_depth", 2, labels={"replica": "r0"})
    hub.counter_add("y", 2)
    hub.counter_add("y")
    hub.counter_add("serve.requests", labels={"replica": 'r"1'})
    for v in (0.01, 0.02, 0.5):
        hub.histogram("serve.ttft_seconds").observe(v)
    hub.histogram("serve.step_seconds", labels={"replica": "r0"}).observe(0.1)
    for i, (wall, mfu) in enumerate(((100.0, 0.5), (200.0, 0.3),
                                     (150.0, 0.4)), 1):
        hub.record_step(step_mod.StepTrace(
            step=i, wall_ms=wall, tokens=32, loss=2.0 / i, mfu=mfu,
            flops_per_token=1e9, peak_tflops=100.0, host_gap_ms=i,
            overflow=i == 2, compile_events=i % 2, timestamp=1.0))
    return hub


def test_hub_snapshot_and_page_equal_jax():
    for tel in (j_tel, p_tel):
        tel.count("serve.prefill_gather_fallback", "padding")
    hubs = [_hub_script(j_hub, j_step), _hub_script(p_hub, p_step)]
    snaps = [h.snapshot() for h in hubs]
    assert snaps[1] == snaps[0]
    assert _body(hubs[1].to_prometheus()) == _body(hubs[0].to_prometheus())
    for last_n in (0, 2):
        assert hubs[1].window_mfu(last_n) == hubs[0].window_mfu(last_n)
        assert hubs[1].mean_mfu(last_n) == hubs[0].mean_mfu(last_n)
        assert hubs[1].window_host_gap_ms(last_n) == \
            hubs[0].window_host_gap_ms(last_n)
    assert p_hub.peek_hub() is hubs[1]


def test_hub_sinks_and_env(tmp_path, monkeypatch):
    from deepspeed_tpu_torch.config.config import ObservabilityConfig

    cfg = ObservabilityConfig(jsonl_path=str(tmp_path / "m.jsonl"),
                              prometheus_path=str(tmp_path / "m.prom"),
                              prometheus_every_steps=2, step_history=2)
    hub = p_hub.get_hub()
    hub.configure(cfg)
    for i in (1, 2, 3):
        hub.record_step(p_step.StepTrace(step=i, wall_ms=10.0, tokens=8))
    hub.record_event("stall_report", step=3, report="r")
    rows = [json.loads(l) for l in (tmp_path / "m.jsonl").read_text()
            .splitlines()]
    assert [r["kind"] for r in rows] == ["step_trace"] * 3 + ["stall_report"]
    assert "dstpu_train_steps_total 2" in (tmp_path / "m.prom").read_text()
    assert len(hub.step_history) == 2
    # the fleet publisher is A14's fleet part
    monkeypatch.setenv("DSTPU_RUN_DIR", str(tmp_path / "run"))
    with pytest.raises(NotImplementedError, match="item 14's fleet part"):
        hub.configure(None)


def test_compile_events_count_kernel_builds(monkeypatch, tmp_path):
    from deepspeed_tpu_torch.ops import build

    hub = p_hub.get_hub()
    before = p_hub.compile_stats()
    # a fake nvcc that writes an empty library
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\nwhile [ $# -gt 0 ]; do if [ \"$1\" = -o ]; "
                    "then shift; : > \"$1\"; fi; shift; done\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    secs = build.build(["paged_attention", "quantization"])
    assert set(secs) == {"paged_attention", "quantization"}
    now = p_hub.compile_stats()
    assert now["events"] == before["events"] + 2
    hub.record_step(p_step.StepTrace(step=1, wall_ms=1.0,
                                     **{"compile_events": int(
                                         hub.compile_delta()["events"])}))
    assert hub.snapshot()["counters"]["jit.compile_events"] == 2
    build.build(["paged_attention"])  # built already: no event
    assert p_hub.compile_stats()["events"] == now["events"]


# -- the stall watchdog (JAX's cases, tests/test_observability.py) -------------


@pytest.mark.parametrize("mod", [j_wd, p_wd], ids=["jax", "port"])
def test_watchdog_slow_step_flagged_and_baseline_unpoisoned(mod):
    wd = mod.StallWatchdog(factor=3.0, min_seconds=0.0, warmup_steps=3,
                           enabled=True)
    for _ in range(5):
        assert not wd.observe(0.1)
    assert wd.observe(1.0)
    assert wd.slow_steps == 1
    assert wd.rolling_mean() == pytest.approx(0.1)


def test_watchdog_fires_one_report_with_stacks_and_memory():
    reports = []
    wd = p_wd.StallWatchdog(factor=1.0, min_seconds=0.05, warmup_steps=2,
                            enabled=True, report_fn=reports.append)
    for _ in range(3):
        wd.observe(0.01)
    wd.arm(step=7)
    deadline = time.time() + 5.0
    while wd.stalls == 0 and time.time() < deadline:
        time.sleep(0.01)
    time.sleep(0.2)  # a second report would come within this
    wd.disarm()
    wd.stop()
    assert wd.stalls == 1 and len(reports) == 1
    assert "STALL WATCHDOG" in reports[0]
    assert "python stacks:" in reports[0]
    assert "step 7" in reports[0]
    # the CPU has no device section: JAX's "unavailable" line
    assert "device memory: unavailable" in reports[0]


def test_watchdog_disarm_env_and_warmup(monkeypatch):
    wd = p_wd.StallWatchdog(factor=1.0, min_seconds=0.05, warmup_steps=2,
                            enabled=True)
    for _ in range(3):
        wd.observe(0.01)
    wd.arm(step=1)
    wd.disarm()
    time.sleep(0.2)
    wd.stop()
    assert wd.stalls == 0
    wd = p_wd.StallWatchdog(factor=2.0, min_seconds=0.0, warmup_steps=5)
    assert wd.threshold() is None
    assert not wd.observe(99.0)
    monkeypatch.setenv("DSTPU_WATCHDOG", "0")
    monkeypatch.setenv("DSTPU_WATCHDOG_FACTOR", "3")
    for mod in (j_wd, p_wd):
        wd = mod.StallWatchdog.from_config(None)
        assert not wd.enabled and wd.factor == 3.0
        assert not wd.observe(100.0)


# -- the flight recorder ---------------------------------------------------------


def test_flight_dump_keys_equal_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("DSTPU_FLIGHT_DIR", str(tmp_path))
    docs = []
    for mod in (j_fr, p_fr):
        rec = mod.FlightRecorder(capacity=4, rank=0)
        for i in range(6):
            rec.record("step_entry", step=i, inflight=0)
        with rec.span("collective", op="all_reduce"):
            pass
        rec.add_dump_context("requests_in_flight", lambda: [{"uid": 1}])
        path = rec.dump("manual", step=5)
        docs.append(json.load(open(path)))
        assert len(rec.tail_lines(last=2).splitlines()) == 2
    assert set(docs[1]) == set(docs[0])
    assert [set(e) for e in docs[1]["events"]] == \
        [set(e) for e in docs[0]["events"]]
    assert docs[1]["n_events"] == 4
    assert [e["kind"] for e in docs[1]["events"]][-1] == "collective"


_CHAIN_WORKER = textwrap.dedent('''
    import os, signal, sys, time
    sys.path.insert(0, {repo!r})
    from deepspeed_tpu_torch.observability import flight_recorder as fr
    from deepspeed_tpu_torch.resilience.preemption import PreemptionGuard

    order = sys.argv[1]
    os.environ["DSTPU_FLIGHT_DIR"] = sys.argv[2]
    fr.get_flight_recorder().record("step_entry", step=1)
    guard = PreemptionGuard()
    if order == "guard_first":
        guard.install()
        fr.install_crash_handlers()
    else:
        fr.install_crash_handlers()
        guard.install()
    os.kill(os.getpid(), signal.SIGTERM)
    time.sleep(0.2)
    # the first notice: the guard noted it and the process goes on
    print("noticed", guard.requested, flush=True)
    os.kill(os.getpid(), signal.SIGTERM)  # the second escalates
    time.sleep(5)
    print("survived", flush=True)
''')


@pytest.mark.parametrize("order", ["guard_first", "flight_first"])
def test_sigterm_chains_with_the_preemption_guard(order, tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(_CHAIN_WORKER.format(repo=REPO))
    proc = subprocess.run([sys.executable, str(script), order,
                           str(tmp_path)], capture_output=True, text=True,
                          timeout=60)
    # the second signal ends the process as killed by SIGTERM
    assert proc.returncode == -signal.SIGTERM, (proc.stdout, proc.stderr)
    assert "noticed" in proc.stdout and "survived" not in proc.stdout
    dumps = sorted(os.listdir(tmp_path))
    assert "flight_rank0_sigterm.json" in dumps
    doc = json.load(open(tmp_path / "flight_rank0_sigterm.json"))
    kinds = [e["kind"] for e in doc["events"]]
    assert kinds[0] == "step_entry"
    assert "preempt_escalate" in kinds or order == "guard_first"


# -- clock sync and the profiler window -------------------------------------------


def test_clock_sync_estimator_equals_jax():
    ests = [mod.ClockSyncEstimator(k=3, window=8, min_samples=2)
            for mod in (j_clock, p_clock)]
    rng = np.random.default_rng(4)
    t = 100.0
    for _ in range(12):
        rtt = float(rng.uniform(0.001, 0.02))
        t0, t1 = t, t + 0.25 + rtt / 2
        t2, t3 = t1 + 0.0001, t + rtt + 0.0001
        for e in (ests):
            e.add_round_trip(t0, t1, t2, t3)
        t += 1.0
    assert ests[1].to_dict() == ests[0].to_dict()
    assert ests[1].rebase(50.0) == ests[0].rebase(50.0)


@pytest.mark.parametrize("spec", ["5:8", "12", "", "3:1", "x", " 2:2 "])
def test_parse_trace_steps_equals_jax(spec):
    assert p_prof.parse_trace_steps(spec) == j_prof.parse_trace_steps(spec)


def test_trace_capture_writes_a_chrome_trace(tmp_path):
    from deepspeed_tpu_torch.utils import annotate

    cap = p_prof.TraceCapture(window=(2, 3), out_dir=str(tmp_path))
    x = torch.ones(4, requires_grad=True)
    for step in (1, 2, 3, 4):
        cap.on_step_begin(step)
        with annotate.trace_range("mlp"):
            (x * 2).sum().backward()
        cap.on_step_end(step)
    assert cap.done and not cap.active
    names = {e["name"] for e in json.load(open(cap.trace_path))
             ["traceEvents"] if "name" in e}
    assert {"train_step#2", "train_step#3", "mlp"} <= names
    assert "train_step#1" not in names and "train_step#4" not in names


# -- the port's own parts: timers, memory, logging, region ranges ---------------


def test_timers_and_logging(monkeypatch, caplog):
    from deepspeed_tpu.utils import timer as j_timer
    from deepspeed_tpu_torch.utils import logging as p_log
    from deepspeed_tpu_torch.utils import timer as p_timer

    for name in ("FORWARD_GLOBAL_TIMER", "BACKWARD_GLOBAL_TIMER",
                 "STEP_GLOBAL_TIMER", "TRAIN_BATCH_TIMER"):
        assert getattr(p_timer, name) == getattr(j_timer, name)
    timers = p_timer.SynchronizedWallClockTimer()
    t = timers("train_batch")
    t.start(block=torch.ones(2))  # a CPU tensor is ready already
    t.stop(block=[torch.ones(1), {"a": torch.zeros(1)}])
    t.record_ms(12.0)
    assert len(t.records) == 2 and t.records[-1] == 12.0
    caplog.set_level("INFO")
    timers.log(["train_batch"])
    assert "time (ms) | train_batch:" in caplog.text
    tput = p_timer.ThroughputTimer(batch_size=4, start_step=1,
                                   steps_per_output=2)
    for _ in range(3):
        tput.record(0.5)
    assert tput.avg_samples_per_sec() == pytest.approx(8.0)
    monkeypatch.setenv("RANK", "3")
    assert p_log.process_rank() == 3
    p_log.log_dist("only rank 0", ranks=[0])
    assert "only rank 0" not in caplog.text
    p_log.log_dist("every rank")
    assert "[Rank 3] every rank" in caplog.text
    p_log.warning_once("once")
    p_log.warning_once("once")
    assert caplog.text.count("once") == 1


def test_memory_counters_on_the_cpu(caplog):
    from deepspeed_tpu_torch.utils import memory

    assert memory.device_memory_stats("cpu") is None
    caplog.set_level("INFO")
    assert memory.see_memory_usage("quiet") is None
    assert "quiet" not in caplog.text
    memory.see_memory_usage("loud", force=True, device="cpu")
    assert "loud | host rss=" in caplog.text
    memory.configure(True)
    try:
        memory.see_memory_usage("breakdown", device="cpu")
    finally:
        memory.configure(False)
    assert "breakdown" in caplog.text


def test_region_ranges_change_no_numerics_and_cover_the_backward():
    from torch.profiler import ProfilerActivity, profile

    from deepspeed_tpu_torch.models import zoo
    from deepspeed_tpu_torch.models.transformer import loss_fn
    from deepspeed_tpu_torch.utils import annotate

    model = zoo.get_model("tiny", device="cpu", seed=0, dtype=torch.float32,
                          num_layers=2, remat=True, pos_emb="rope")
    params = _tree_map(lambda p: p.detach().clone().requires_grad_(),
                       model.params())
    batch = {"input_ids": torch.from_numpy(
        np.random.default_rng(0).integers(0, 64, (2, 17)))}
    leaves = [p for p in _leaves(params)]

    def grads():
        loss, _ = loss_fn(model.config, params, batch)
        return [loss.detach()] + list(torch.autograd.grad(loss, leaves))

    plain = grads()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ranged = grads()
    annotate.close_open_ranges()
    for a, b in zip(plain, ranged):
        assert torch.equal(a, b)
    names = [e.name for e in prof.events()]
    for region in ("attention", "mlp", "norm", "rope", "vocab_head"):
        assert names.count(region) >= 2, region  # forward and backward
    assert not annotate.profiling()
    # no profiler: the wrappers call straight through, nothing opens
    assert annotate.range_push("x") is None
    assert not any(annotate._OPEN.values())

    @annotate.instrument_w_profiler(name="double")
    def double(t):
        return t * 2

    assert annotate.instrument_w_nvtx is annotate.instrument_w_profiler
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert torch.equal(double(torch.ones(2)), torch.full((2,), 2.0))
        handle = annotate.range_push("manual")
        annotate.range_pop(handle)
    names = [e.name for e in prof.events()]
    assert "double" in names and "manual" in names


def test_backward_ranges_pair_by_call_across_stacked_remat_layers():
    """Two stacked remat'd layers under the profiler: each layer's
    backward has a range of its own for the MLP and the attention half,
    holding the same count of matmuls as the other layer's, and every
    backward matmul lies in a range. A layer's output carries that
    layer's open hook and the next layer's close hooks of the same
    names; pairing them by name left one layer's MLP range empty."""
    from torch.profiler import ProfilerActivity, profile

    from deepspeed_tpu_torch.models import zoo
    from deepspeed_tpu_torch.models.transformer import loss_fn
    from deepspeed_tpu_torch.utils import annotate

    L = 2
    model = zoo.get_model("tiny", device="cpu", seed=0, dtype=torch.float32,
                          num_layers=L, remat=True, pos_emb="rope",
                          attn_impl="xla")
    params = _tree_map(lambda p: p.detach().clone().requires_grad_(),
                       model.params())
    batch = {"input_ids": torch.from_numpy(
        np.random.default_rng(0).integers(0, 64, (2, 17)))}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loss, _ = loss_fn(model.config, params, batch)
        loss.backward()
    assert not annotate._OPEN  # every backward range closed itself
    regions = {"attention", "mlp", "norm", "rope", "vocab_head"}

    def below(e):
        for c in e.cpu_children:
            yield c
            yield from below(c)

    def innermost(e):
        node = e.cpu_parent
        while node is not None and node.name not in regions:
            node = node.cpu_parent
        return node

    def in_backward(e):
        node = e.cpu_parent
        while node is not None and not node.name.startswith(
                "autograd::engine::evaluate_function"):
            node = node.cpu_parent
        return node is not None

    matmuls = [e for e in prof.events() if e.name in ("aten::mm", "aten::bmm")]
    held = {}
    for e in matmuls:
        r = innermost(e)
        if r is not None:
            held[id(r)] = held.get(id(r), 0) + 1
    backward = {name: [] for name in regions}
    for e in prof.events():
        if e.name in regions and any(
                d.name.startswith("autograd::engine::evaluate_function")
                for d in below(e)):
            backward[e.name].append(held.get(id(e), 0))
    assert len(backward["mlp"]) == len(backward["attention"]) == L
    assert len(backward["vocab_head"]) == 1
    for name in ("mlp", "attention", "vocab_head"):
        assert backward[name][0] > 0 and len(set(backward[name])) == 1, (
            name, backward[name])
    stray = [e.name for e in matmuls if in_backward(e) and innermost(e) is None]
    assert not stray


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _tree_map(fn, tree):
    return {k: (_tree_map(fn, v) if isinstance(v, dict) else fn(v))
            for k, v in tree.items()}


def test_resilience_flight_records_and_the_tail_at_raise():
    from deepspeed_tpu_torch.resilience.policy import (CommTimeoutError,
                                                       RetryPolicy)
    from deepspeed_tpu_torch.resilience.preemption import PreemptionGuard

    p_fr.reset_flight_recorder()
    try:
        rec = p_fr.get_flight_recorder()
        rec.record("step_entry", step=41)
        PreemptionGuard._record("preempt_notice", signum=15)
        assert [k for _, k, _ in rec.events()] == ["step_entry",
                                                   "preempt_notice"]
        policy = RetryPolicy(max_retries=0, backoff_base_s=0.0)

        def fail():
            raise OSError("link down")

        with pytest.raises(CommTimeoutError) as err:
            policy.run("barrier", fail, timeout_s=5.0)
        assert "step=41" in err.value.flight_tail
        assert "flight-recorder tail" in str(err.value)
    finally:
        p_fr.reset_flight_recorder()
