"""Experiment monitoring backends.

Port of ``deepspeed_tpu/monitor/monitor.py`` (reference
``deepspeed/monitor/``: MonitorMaster monitor.py:29; TensorBoard / W&B /
CSV writers). Events are (tag, value, step) triples; the master fans them
out to every enabled backend, writing only from rank 0 of the process
group (``comm.get_rank()``; 0 when no group is initialized).

TensorBoard (``torch.utils.tensorboard``) and wandb are imported only when
their block is enabled; where the package is missing the backend warns
and disables itself, and the engine trains on. ``csv_monitor`` writes one
file per tag, ``<output_path>/<job_name>/<tag with / as _>.csv``, with the
header ``step,<tag>`` and one ``step,value`` row per event, as the JAX
package does.
"""

import csv
import os
from typing import List, Tuple

from ..comm import comm
from ..utils.logging import logger

Event = Tuple[str, float, int]


def _rank() -> int:
    return comm.get_rank() if comm.is_initialized() else 0


class Monitor:
    def __init__(self, config):
        self.enabled = getattr(config, "enabled", False)

    def write_events(self, event_list: List[Event]):
        raise NotImplementedError


class TensorBoardMonitor(Monitor):
    """reference monitor/tensorboard.py:13 (torch SummaryWriter backend)."""

    def __init__(self, config):
        super().__init__(config)
        self.summary_writer = None
        if self.enabled and _rank() == 0:
            try:
                from torch.utils.tensorboard import SummaryWriter
                path = os.path.join(config.output_path or "./runs",
                                    config.job_name)
                self.summary_writer = SummaryWriter(log_dir=path)
            except Exception as e:
                logger.warning(f"tensorboard unavailable: {e}")
                self.enabled = False

    def write_events(self, event_list: List[Event]):
        if self.summary_writer is None:
            return
        for tag, value, step in event_list:
            self.summary_writer.add_scalar(tag, value, step)
        self.summary_writer.flush()


class WandbMonitor(Monitor):
    """reference monitor/wandb.py:12."""

    def __init__(self, config):
        super().__init__(config)
        self._wandb = None
        if self.enabled and _rank() == 0:
            try:
                import wandb
                wandb.init(project=config.project, group=config.group,
                           entity=config.team)
                self._wandb = wandb
            except Exception as e:
                logger.warning(f"wandb unavailable: {e}")
                self.enabled = False

    def write_events(self, event_list: List[Event]):
        if self._wandb is None:
            return
        for tag, value, step in event_list:
            self._wandb.log({tag: value}, step=step)


class CSVMonitor(Monitor):
    """reference monitor/csv_monitor.py:12 — one csv file per event tag."""

    def __init__(self, config):
        super().__init__(config)
        self.output_path = None
        if self.enabled and _rank() == 0:
            self.output_path = os.path.join(config.output_path or ".",
                                            config.job_name)
            os.makedirs(self.output_path, exist_ok=True)
        else:
            self.enabled = False

    def write_events(self, event_list: List[Event]):
        if not self.enabled:
            return
        for tag, value, step in event_list:
            fname = os.path.join(self.output_path,
                                 tag.replace("/", "_") + ".csv")
            new = not os.path.exists(fname)
            with open(fname, "a", newline="") as fh:
                w = csv.writer(fh)
                if new:
                    w.writerow(["step", tag])
                w.writerow([step, value])


class MonitorMaster(Monitor):
    """Fan-out master (reference monitor/monitor.py:29)."""

    def __init__(self, ds_config):
        self.tb = TensorBoardMonitor(ds_config.tensorboard)
        self.wandb = WandbMonitor(ds_config.wandb)
        self.csv = CSVMonitor(ds_config.csv_monitor)
        self.enabled = self.tb.enabled or self.wandb.enabled or \
            self.csv.enabled
        self.telemetry = None

    def attach_telemetry(self, registry=None, flush_interval: int = 1):
        """Attach a TelemetryBridge flushing the metrics registry's
        scalars into this master's backends every ``flush_interval``
        steps (telemetry/bridge.py)."""
        from ..telemetry.bridge import TelemetryBridge
        self.telemetry = TelemetryBridge(self, registry=registry,
                                         flush_interval=flush_interval)
        return self.telemetry

    def write_events(self, event_list: List[Event]):
        if _rank() != 0:
            return
        for backend in (self.tb, self.wandb, self.csv):
            if backend.enabled:
                backend.write_events(event_list)
