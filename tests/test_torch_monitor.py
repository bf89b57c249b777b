"""The port's monitor backends against the JAX package's.

The same events through both ``CSVMonitor``s write the same files, row
for row; the JSONL backend writes the same rows; ``MonitorMaster`` builds
the same backends from the same config (the top-level blocks hoisted
into ``monitor`` as JAX does), and a backend whose package is missing
(W&B, Comet here) warns and stays off in both.
"""

import importlib.util
import json
import logging
import os

import pytest

from deepspeed_tpu.config.config import load_config as jax_config
from deepspeed_tpu.monitor import monitor as j_mon
from deepspeed_tpu_torch.config.config import load_config as port_config
from deepspeed_tpu_torch.monitor import monitor as p_mon

EVENTS = [("Train/Samples/train_loss", 2.5, 8),
          ("Train/Samples/lr", 1e-4, 8),
          ("Train/Samples/train_loss", 2.25, 16),
          ("Train/Samples/mfu", 0.3125, 16)]


def _files(root):
    out = {}
    for base, _, names in os.walk(root):
        for n in names:
            path = os.path.join(base, n)
            out[os.path.relpath(path, root)] = open(path).read()
    return out


def test_csv_rows_equal_jax(tmp_path):
    for mod, cfg_fn in ((j_mon, jax_config), (p_mon, port_config)):
        out = tmp_path / mod.__name__.split(".")[0]
        cfg = cfg_fn({"csv_monitor": {"enabled": True,
                                      "output_path": str(out),
                                      "job_name": "job"}})
        master = mod.MonitorMaster(cfg.monitor)
        assert [type(b).__name__ for b in master.backends] == ["CSVMonitor"]
        master.write_events(EVENTS[:2])
        master.write_events(EVENTS[2:])
    port = _files(tmp_path / "deepspeed_tpu_torch")
    assert port == _files(tmp_path / "deepspeed_tpu")
    assert sorted(port) == ["job/Train_Samples_lr.csv",
                            "job/Train_Samples_mfu.csv",
                            "job/Train_Samples_train_loss.csv"]
    assert port["job/Train_Samples_train_loss.csv"].splitlines() == \
        ["step,Train/Samples/train_loss", "8,2.5", "16,2.25"]


def test_jsonl_backend_rows_equal_jax(tmp_path):
    rows = []
    for mod, cfg_fn in ((j_mon, jax_config), (p_mon, port_config)):
        path = tmp_path / f"{mod.__name__}.jsonl"
        cfg = cfg_fn({"monitor": {"jsonl": {"enabled": True,
                                            "output_path": str(path)}}})
        master = mod.MonitorMaster(cfg.monitor)
        master.write_events(EVENTS)
        rows.append([json.loads(l) for l in path.read_text().splitlines()])
    assert rows[1] == rows[0]
    assert rows[1][0] == {"kind": "monitor_event",
                          "label": "Train/Samples/train_loss", "value": 2.5,
                          "step": 8}


@pytest.mark.parametrize("backend,package", [("wandb", "wandb"),
                                             ("comet", "comet_ml"),
                                             ("tensorboard", "tensorboard")])
def test_backends_load_lazily_and_warn_when_absent(backend, package,
                                                   tmp_path, caplog):
    present = importlib.util.find_spec(package) is not None
    if backend == "wandb" and present:
        pytest.skip("wandb is installed: enabling it would start a run")
    caplog.set_level(logging.WARNING)
    built = []
    for mod, cfg_fn in ((j_mon, jax_config), (p_mon, port_config)):
        cfg = cfg_fn({backend: {"enabled": True, "project": "p",
                                "output_path": str(tmp_path / mod.__name__),
                                "job_name": "j"}})
        built.append([type(b).__name__ for b in
                      mod.MonitorMaster(cfg.monitor).backends])
    assert built[1] == built[0]
    assert bool(built[1]) == present
    if not present:
        assert f"{backend} monitor unavailable" in caplog.text


def test_no_backend_is_built_by_default_or_off_rank_0(monkeypatch):
    assert not p_mon.MonitorMaster(port_config({}).monitor).enabled
    monkeypatch.setenv("RANK", "1")
    cfg = port_config({"csv_monitor": {"enabled": True}})
    assert not p_mon.MonitorMaster(cfg.monitor).enabled
