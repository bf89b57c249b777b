"""The port's kernel bench (``python -m deepspeed_tpu_torch.tools.
kernel_bench``) at its CPU tier, where each "kernel" is its plain PyTorch
version: JAX's ``kernel_bench/v1`` payload, the rows recorded into the
table it names (never the port's committed table), its gates passing, and
its dispatch probe holding a planted losing row to ``xla_attention`` bit
for bit. Also the environment report (``launcher/report.py``)."""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.launcher import report
from deepspeed_tpu_torch.ops import attention as attn_ops
from deepspeed_tpu_torch.ops import kernel_table
from deepspeed_tpu_torch.tools import kernel_bench as kb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    path = tmp_path_factory.mktemp("bench") / "table.json"
    mp = pytest.MonkeyPatch()
    mp.setenv("KERNEL_BENCH_RECORD_PATH", str(path))
    mp.delenv("KERNEL_BENCH_KERNELS", raising=False)
    mp.delenv("KERNEL_BENCH_FULL", raising=False)
    mp.delenv("DSTPU_KERNEL_TABLE", raising=False)
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        text, payload, ok = kb.run_kernel_bench()
    finally:
        torch.set_num_threads(prev)
        mp.undo()
    return path, text, payload, ok


def _jax_bench():
    spec = importlib.util.spec_from_file_location(
        "jax_kernel_bench", os.path.join(REPO, "tools", "kernel_bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_payload_has_jax_keys(bench, tmp_path, monkeypatch):
    path, text, payload, ok = bench
    # JAX's own bench (its paged arm only, one iteration) names the keys
    monkeypatch.setenv("KERNEL_BENCH_KERNELS", "paged")
    monkeypatch.setenv("KERNEL_BENCH_ITERS", "1")
    monkeypatch.setenv("KERNEL_BENCH_RECORD_PATH", str(tmp_path / "j.json"))
    _, jax_payload, jax_ok = _jax_bench().run_kernel_bench()
    assert jax_ok
    assert set(jax_payload) <= set(payload)
    assert payload["schema"] == jax_payload["schema"] == "kernel_bench/v1"
    assert set(jax_payload["entries"][0]) <= set(payload["entries"][0])
    assert payload["backend"] == "cpu" and payload["device"] == "cpu"
    assert payload["full"] is False and payload["table_path"] == str(path)
    assert payload["flash_fallback_ratio"] == 0.0
    assert "| flash_attention | s256_d64_causal |" in text


def test_every_arm_recorded_and_gates_pass(bench):
    path, _, payload, ok = bench
    assert ok and payload["violations"] == [] and payload["ok"]
    rows = payload["entries"]
    assert [r["kernel"] for r in rows] == [
        "flash_attention", "paged_attention", "grouped_matmul",
        "blocksparse_attention"]
    assert all(r["numerics_ok"] for r in rows)
    # the flash and gmm arms hold their gradients too
    assert {r["kernel"]: sorted(r["row_rel_err"]) for r in rows} == {
        "flash_attention": ["grads", "out"], "paged_attention": ["out"],
        "grouped_matmul": ["grads", "out"],
        "blocksparse_attention": ["out"]}
    assert all(r["blocks"]["template"] == "plain" for r in rows)
    # the table holds the payload's ratios, scoped to this backend
    table = json.loads(path.read_text())
    assert table["_meta"]["schema"] == kernel_table.SCHEMA
    for r in rows:
        e = table["entries"][r["kernel"]][r["bucket"]]
        assert e["ratio"] == r["ratio"] and e["backend"] == "cpu"
        assert e["ratio"] == pytest.approx(e["xla_ms"] / e["kernel_ms"],
                                           rel=1e-3)
    winning = sorted(f"{r['kernel']}:{r['bucket']}" for r in rows
                     if r["ratio"] >= 1.0)
    assert payload["winning_kernels"] == winning
    ratios = [r["ratio"] for r in rows]
    assert payload["value"] == pytest.approx(
        float(np.exp(np.mean(np.log(ratios)))), abs=1e-4)
    # the library yardstick where this torch has one (SDPA); no gmm call
    # on the CPU
    lib = {r["kernel"]: r["library_ms"] for r in rows}
    assert lib["grouped_matmul"] is None
    assert all(lib[k] > 0 for k in lib if k != "grouped_matmul")


def test_cpu_run_never_writes_the_committed_table(monkeypatch):
    """Rows land only where ``KERNEL_BENCH_RECORD_PATH`` says, else in a
    fresh temporary table: never the committed table nor the table the
    dispatch reads (``DSTPU_KERNEL_TABLE``)."""
    for var in ("KERNEL_BENCH_RECORD_PATH", "DSTPU_KERNEL_TABLE"):
        monkeypatch.delenv(var, raising=False)
    first = kb._record_path()
    assert first != kernel_table.DEFAULT_TABLE
    assert kb._record_path() != first and not os.path.exists(first)
    monkeypatch.setenv("DSTPU_KERNEL_TABLE", "/x/t.json")
    assert kb._record_path() not in ("/x/t.json", kernel_table.DEFAULT_TABLE)
    monkeypatch.setenv("KERNEL_BENCH_RECORD_PATH", "/y/t.json")
    assert kb._record_path() == "/y/t.json"


@pytest.mark.parametrize("arm,part", [("flash", "out"), ("flash", "grads"),
                                      ("gmm", "out"), ("gmm", "grads")])
def test_numerics_gate_fails_a_wrong_kernel(monkeypatch, tmp_path, arm,
                                            part):
    """A kernel whose output leaves the fallback's by 5% of a row, or
    whose gradients leave it by 25%, fails the bench's numerics gate."""
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import grouped_matmul as gm

    mod, name = (fa, "flash_attention") if arm == "flash" else (gm, "gmm")
    real = getattr(mod, name)

    class Skew(torch.autograd.Function):
        """The identity, its forward or its backward scaled."""

        @staticmethod
        def forward(ctx, x):
            return x * 1.05 if part == "out" else x.clone()

        @staticmethod
        def backward(ctx, g):
            return g * 1.25 if part == "grads" else g

    monkeypatch.setattr(mod, name,
                        lambda *a, **kw: Skew.apply(real(*a, **kw)))
    monkeypatch.setenv("KERNEL_BENCH_KERNELS", arm)
    monkeypatch.setenv("KERNEL_BENCH_RECORD_PATH", str(tmp_path / "t.json"))
    _, payload, ok = kb.run_kernel_bench()
    assert not ok
    (row,) = payload["entries"]
    assert [v["gate"] for v in payload["violations"]] == ["numerics"]
    tol = {"out": kb.ROW_TOL, "grads": kb.GRAD_ROW_TOL}
    other = "grads" if part == "out" else "out"
    assert row["row_rel_err"][part] > tol[part][torch.bfloat16]
    assert row["row_rel_err"][other] <= tol[other][torch.bfloat16]


def test_card_timing_runs_calls_back_to_back(monkeypatch):
    """On the card a row's time is one pair of events around
    KERNEL_BENCH_ITERS calls, REPEATS times, over the calls."""
    calls, events = [], []

    class Event:
        def __init__(self, enable_timing):
            self.at = None
            events.append(self)

        def record(self):
            self.at = len(calls)

        def elapsed_time(self, end):
            return 2.0 * (end.at - self.at)  # 2 ms a call

    monkeypatch.setattr(kb, "_on_card", lambda: True)
    monkeypatch.setattr(kb.torch.cuda, "Event", Event)
    monkeypatch.setattr(kb.torch.cuda, "synchronize", lambda: None)
    monkeypatch.setenv("KERNEL_BENCH_ITERS", "5")
    assert kb._time_ms(lambda: calls.append(1)) == 2.0
    assert len(calls) == 1 + 5 * kb.REPEATS
    assert len(events) == 2 * kb.REPEATS


@pytest.mark.parametrize("ratio", [0.25, 3.0])
def test_dispatch_probe_on_a_planted_row(bench, tmp_path, ratio):
    """A planted losing flash row routes through multi_head_attention to
    xla_attention bit for bit; a winning one dispatches to the kernel:
    the probe finds no violation either way, and the route is the
    planted one."""
    _, _, payload, _ = bench
    row = dict(next(r for r in payload["entries"]
                    if r["kernel"] == "flash_attention"), ratio=ratio)
    path = tmp_path / "planted.json"
    kernel_table.record(row["kernel"], row["bucket"], 1.0, ratio,
                        path=str(path))
    attn_ops._reset_dispatch_stats()
    assert kb._dispatch_probe([row], str(path)) == []
    source = "kernel" if ratio >= 1.0 else "xla"
    assert attn_ops.dispatch_stats()[source] == 1
    # the probe restores the environment and the installed config
    assert os.environ.get("DSTPU_KERNEL_TABLE") != str(path)
    q, k, v = kb._probe_qkv(256, 64)
    os.environ["DSTPU_KERNEL_TABLE"] = str(path)
    kernel_table.invalidate_cache()
    try:
        out = attn_ops.multi_head_attention(q, k, v, causal=True)
        want = attn_ops.xla_attention(q, k, v, causal=True)
        assert torch.equal(out, want) == (ratio < 1.0)
    finally:
        del os.environ["DSTPU_KERNEL_TABLE"]
        kernel_table.invalidate_cache()


def test_probe_flags_a_route_that_ignores_the_table(bench, tmp_path,
                                                    monkeypatch):
    """If the dispatch did not consult the table, the probe says so."""
    _, _, payload, _ = bench
    row = dict(next(r for r in payload["entries"]
                    if r["kernel"] == "flash_attention"), ratio=0.25)
    path = tmp_path / "planted.json"
    kernel_table.record(row["kernel"], row["bucket"], 1.0, 0.25,
                        path=str(path))
    from deepspeed_tpu_torch.ops import registry

    monkeypatch.setattr(attn_ops, "auto_decision",
                        lambda *a: registry.DispatchDecision(
                            "flash_attention", "kernel", "ignores the table"))
    gates = [v["gate"] for v in kb._dispatch_probe([row], str(path))]
    assert gates == ["losing_bucket_bit_identical"]


def test_unknown_arm_is_a_violation(monkeypatch, tmp_path):
    monkeypatch.setenv("KERNEL_BENCH_KERNELS", "nope")
    monkeypatch.setenv("KERNEL_BENCH_RECORD_PATH", str(tmp_path / "t.json"))
    _, payload, ok = kb.run_kernel_bench()
    assert not ok and payload["violations"][0]["gate"] == "unknown_kernel"


def test_report_runs_on_the_cpu_and_exits_0(capsys, tmp_path, monkeypatch):
    path = tmp_path / "t.json"
    kernel_table.record("flash_attention", "s256_d64_causal", 1.0, 0.5,
                        path=str(path))
    monkeypatch.setenv("DSTPU_KERNEL_TABLE", str(path))
    kernel_table.invalidate_cache()
    assert report.main() == 0
    out = capsys.readouterr().out
    assert "no CUDA device" in out
    assert f"torch version{'.' * 21} {torch.__version__}" in out
    for name in ("flash_attention", "quantize_blockwise",
                 "dequantize_blockwise", "xla_attention", "ragged_forward"):
        assert name in out
    assert str(path) in out
    assert "flash_attention s256_d64_causal" in out and "(loss)" in out
    kernel_table.invalidate_cache()
