"""Experiment monitoring backends (port of
``deepspeed_tpu/monitor/monitor.py``).

Analog of the reference monitor subsystem (deepspeed/monitor/monitor.py:30
``MonitorMaster`` fanning out to TensorBoard/WandB/Comet/CSV/JSONL).
Events are ``(label, value, step)`` triples written only from rank 0
(``utils/logging.process_rank``: the process group's rank, else the
environment's). TensorBoard, W&B and Comet import their packages when
enabled and, as in JAX, warn and stay off when the package is missing.
"""

from __future__ import annotations

import csv
import os
from typing import List, Tuple

from deepspeed_tpu_torch.utils.logging import logger, process_rank

Event = Tuple[str, float, int]


class _Backend:
    enabled = False

    def write_events(self, events: List[Event]):
        raise NotImplementedError


class CSVMonitor(_Backend):
    """reference: monitor/csv_monitor.py"""

    def __init__(self, cfg):
        self.enabled = cfg.enabled
        self.output_path = cfg.output_path or "./csv_monitor"
        self.job_name = cfg.job_name
        self._files = {}
        if self.enabled:
            os.makedirs(os.path.join(self.output_path, self.job_name),
                        exist_ok=True)

    def write_events(self, events: List[Event]):
        for label, value, step in events:
            fname = os.path.join(self.output_path, self.job_name,
                                 label.replace("/", "_") + ".csv")
            new = not os.path.exists(fname)
            with open(fname, "a", newline="") as f:
                w = csv.writer(f)
                if new:
                    w.writerow(["step", label])
                w.writerow([step, value])


class TensorBoardMonitor(_Backend):
    """reference: monitor/tensorboard.py — torch's SummaryWriter (needs
    the tensorboard package)."""

    def __init__(self, cfg):
        self.enabled = False
        if not cfg.enabled:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter

            path = os.path.join(cfg.output_path or "./runs", cfg.job_name)
            self.writer = SummaryWriter(log_dir=path)
            self.enabled = True
        except Exception as e:
            logger.warning(f"tensorboard monitor unavailable: {e}")

    def write_events(self, events: List[Event]):
        for label, value, step in events:
            self.writer.add_scalar(label, value, step)
        self.writer.flush()


class WandbMonitor(_Backend):
    """reference: monitor/wandb.py — imports wandb when enabled."""

    def __init__(self, cfg):
        self.enabled = False
        if not cfg.enabled:
            return
        try:
            import wandb

            wandb.init(project=cfg.project, group=cfg.group, name=cfg.job_name)
            self._wandb = wandb
            self.enabled = True
        except Exception as e:
            logger.warning(f"wandb monitor unavailable: {e}")

    def write_events(self, events: List[Event]):
        for label, value, step in events:
            self._wandb.log({label: value}, step=step)


class CometMonitor(_Backend):
    """reference: monitor/comet.py — imports comet_ml when enabled."""

    def __init__(self, cfg):
        self.enabled = False
        if not cfg.enabled:
            return
        try:
            import comet_ml

            self._exp = comet_ml.Experiment(project_name=cfg.project)
            if cfg.job_name:
                self._exp.set_name(cfg.job_name)
            self.enabled = True
        except Exception as e:
            logger.warning(f"comet monitor unavailable: {e}")

    def write_events(self, events: List[Event]):
        for label, value, step in events:
            self._exp.log_metric(label, value, step=step)


class JSONLMonitor(_Backend):
    """Append-only JSON-lines event stream (observability hub sink
    reused as a monitor backend: one `{"label", "value", "step"}` row
    per event, greppable and pandas-loadable without a TB install)."""

    def __init__(self, cfg):
        self.enabled = False
        if not cfg.enabled:
            return
        from deepspeed_tpu_torch.observability.sinks import JSONLSink

        path = cfg.output_path or "./monitor_events.jsonl"
        if os.path.isdir(path) or path.endswith(os.sep):
            path = os.path.join(path, cfg.job_name + ".jsonl")
        self._sink = JSONLSink(path)
        self.enabled = True

    def write_events(self, events: List[Event]):
        for label, value, step in events:
            self._sink.write({"kind": "monitor_event", "label": label,
                              "value": value, "step": step})


class MonitorMaster:
    """Fan-out writer (reference monitor/monitor.py:30)."""

    def __init__(self, monitor_config):
        self.backends: List[_Backend] = []
        if process_rank() == 0:
            for backend_cls, cfg in (
                (TensorBoardMonitor, monitor_config.tensorboard),
                (CSVMonitor, monitor_config.csv_monitor),
                (WandbMonitor, monitor_config.wandb),
                (CometMonitor, monitor_config.comet),
                (JSONLMonitor, getattr(monitor_config, "jsonl", None)),
            ):
                if cfg is None:
                    continue
                b = backend_cls(cfg)
                if b.enabled:
                    self.backends.append(b)

    @property
    def enabled(self) -> bool:
        return bool(self.backends)

    def write_events(self, events: List[Event]):
        for b in self.backends:
            b.write_events(events)
