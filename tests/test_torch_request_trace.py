"""The port's request tracer against the JAX package's.

Both ``RequestTracer``s run the same span scripts on one scripted wall
clock (each module's ``_wall`` replaced by the same sequence of stamps),
so every timestamp, trace id, phase decomposition, SLO attribution
report (and its markdown), closure check and tail-sampling decision
must come out equal. The same holds for traces loaded back from the
JSONL dump.
"""

import itertools

import pytest

from deepspeed_tpu.observability import hub as j_hub
from deepspeed_tpu.observability import request_trace as j_rt
from deepspeed_tpu_torch.observability import hub as p_hub
from deepspeed_tpu_torch.observability import request_trace as p_rt


@pytest.fixture(autouse=True)
def _fresh_hubs():
    for mod in (j_hub, p_hub):
        mod.reset_hub()
    yield
    for mod in (j_hub, p_hub):
        mod.reset_hub()


def _clock(start=1000.0, step=0.003):
    """A wall clock that advances ``step`` seconds a read."""
    counter = itertools.count()
    return lambda: start + step * next(counter)


def _round_trip(tr, uid=7):
    """enqueue -> admit -> prefill -> emit -> preempt -> re-admit ->
    emit (with spec overhead) -> finish."""
    tr.on_enqueue(uid, 32, queue_depth=1)
    tr.on_admit(uid, wait_s=0.01)
    tr.on_prefix_hit(uid, 16)
    tr.on_prefill(uid, 1000.004, 2.5, tokens=32, start_pos=0)
    tr.on_emit(uid, 1)
    tr.on_spec(uid, drafted=4, accepted=2)
    tr.on_preempt(uid, "pool_exhausted", generated=1)
    tr.note(uid, "KV_STARVED", at="decode")
    tr.on_admit(uid, wait_s=0.005, requeued=True)
    tr.on_emit(uid, 2, spec_overhead_ms=1.0)
    tr.on_finish(uid, "finished")


def _many(tr, n=40):
    """n requests, interleaved, some truncated and one superseded."""
    for uid in range(n):
        tr.on_enqueue(uid, 8 + uid, queue_depth=uid % 3)
    tr.on_enqueue(3, 9)  # uid reuse while open: the old trace closes
    for uid in range(n):
        tr.on_admit(uid, wait_s=0.001 * uid)
        if uid % 4 == 0:
            tr.on_emit(uid, 1)
        if uid % 5 == 0:
            tr.on_emit(uid, 3)
    for uid in range(n):
        tr.on_finish(uid, "truncated" if uid % 7 == 0 else "finished")


def _both(script, monkeypatch, **kw):
    out = []
    for mod in (j_rt, p_rt):
        monkeypatch.setattr(mod, "_wall", _clock())
        hub = (j_hub if mod is j_rt else p_hub).get_hub()
        tr = mod.RequestTracer(hub=hub, **kw)
        script(tr)
        out.append((tr, hub))
    return out


@pytest.mark.parametrize("script,kw", [
    (_round_trip, {"sample_rate": 1.0}),
    (_many, {"sample_rate": 0.3, "slo_deadline_ms": 7.0, "seed": 3}),
    (_many, {"sample_rate": 0.0, "ring_size": 5}),
], ids=["round_trip", "sampled_with_deadline", "bounded_ring"])
def test_span_scripts_equal_jax(script, kw, monkeypatch):
    (jt, jh), (pt, ph) = _both(script, monkeypatch, **kw)
    jf, pf = jt.finished(), pt.finished()
    assert [t.to_dict() for t in pf] == [t.to_dict() for t in jf]
    for a, b in zip(pf, jf):
        assert a.phases() == b.phases()
        assert a.ttft_phases() == b.ttft_phases()
    assert pt.stats == jt.stats
    assert pt.snapshot() == jt.snapshot()
    deadline = kw.get("slo_deadline_ms")
    dl = None if deadline is None else deadline / 1e3
    jr, pr = j_rt.slo_attribution(jf, dl), p_rt.slo_attribution(pf, dl)
    assert pr == jr
    assert p_rt.slo_attribution_markdown(pr) == \
        j_rt.slo_attribution_markdown(jr)
    assert p_rt.check_phase_closure(pf) == j_rt.check_phase_closure(jf)
    # the per-phase histograms the finished traces fed
    assert ph.snapshot()["histograms"] == jh.snapshot()["histograms"]
    assert ph.snapshot()["counters"] == jh.snapshot()["counters"]


def test_round_trip_phases_close(monkeypatch):
    (_, _), (pt, _) = _both(_round_trip, monkeypatch, sample_rate=1.0)
    t = pt.finished()[-1]
    assert set(t.phases()) == set(p_rt.PHASES)
    assert sum(t.phases().values()) == pytest.approx(t.e2e_s, abs=1e-9)
    assert sum(t.ttft_phases().values()) == pytest.approx(t.ttft_s,
                                                          abs=1e-9)
    assert t.phases()["spec_overhead"] == pytest.approx(1e-3)
    kinds = [s.kind for s in t.spans]
    assert kinds[0] == "ENQUEUE" and kinds[-1] == "FINISH"
    assert "KV_STARVED" in kinds and "PREFIX_HIT" in kinds


def test_jsonl_dump_loads_back_equal(monkeypatch, tmp_path):
    (jt, _), (pt, _) = _both(_many, monkeypatch, sample_rate=1.0,
                             slo_deadline_ms=7.0)
    loaded = []
    for mod, tr in ((j_rt, jt), (p_rt, pt)):
        path = tr.dump_jsonl(str(tmp_path / f"{mod.__name__}.jsonl"))
        loaded.append(mod.load_traces_jsonl(path))
    assert [t.to_dict() for t in loaded[1]] == \
        [t.to_dict() for t in loaded[0]]
    assert p_rt.slo_attribution(loaded[1], 0.007) == \
        j_rt.slo_attribution(loaded[0], 0.007)


def test_rebase_and_closure_drift_equal_jax(monkeypatch):
    (jt, _), (pt, _) = _both(_round_trip, monkeypatch, sample_rate=1.0)
    a, b = pt.finished()[-1], jt.finished()[-1]
    assert a.rebase(0.25, 0.004, "worker1").to_dict() == \
        b.rebase(0.25, 0.004, "worker1").to_dict()
    for t in (a, b):
        t.enqueue_ts -= 1.0  # e2e is measured from here, the walk is not
    with pytest.raises(AssertionError, match="phases sum off"):
        p_rt.check_phase_closure([a])
    with pytest.raises(AssertionError, match="phases sum off"):
        j_rt.check_phase_closure([b])


def test_from_config_and_env_equal_jax(monkeypatch):
    cfgs = [None, {"enabled": False}, {"sample_rate": 0.5, "ring_size": 8,
                                       "slo_deadline_ms": 20.0}]
    for cfg in cfgs:
        got = p_rt.RequestTracer.from_config(cfg).snapshot()
        want = j_rt.RequestTracer.from_config(cfg).snapshot()
        assert got == want
    monkeypatch.setenv("DSTPU_REQUEST_TRACE", "0")
    monkeypatch.setenv("DSTPU_REQ_TRACE_SAMPLE", "0.25")
    assert p_rt.RequestTracer.from_config(None).snapshot() == \
        j_rt.RequestTracer.from_config(None).snapshot()
    assert not p_rt.RequestTracer.from_config(None).enabled
