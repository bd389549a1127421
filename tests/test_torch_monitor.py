"""PyTorch port: the training engine's telemetry, diagnostics and monitor
backends against the JAX package.

A JAX engine and a port engine (the flagship small config of
``tests/test_torch_training.py``, fp32, ZeRO 0, the same weights moved by
name) train on the same batches with ``telemetry``, ``diagnostics`` and
``csv_monitor`` on (``telemetry.flush_interval`` 1, so the bridge writes
every registry scalar each step). Held:

* the training series of each package's registry (``training_loss``,
  ``training_grad_norm``, ``training_lr``, the step / skip / sample
  counters, the step-time histogram's count, the reduce-bucket and
  quantized-reduce gauges) equal, the losses and norms within 1e-5
  relative; the port's series equal the losses and norms ``train_batch``
  returned;
* the CSV files: ``Train/loss`` and ``Train/lr`` one row per step at the
  same steps and values (1e-5 relative), and the bridge's ``training_*``
  files, the time-valued ones aside;
* a NaN written into the embedding: the same ``nan_loss`` verdict in both
  packages, naming the same buckets, with a post-mortem bundle each; with
  ``grad_attribution`` off both name none;
* diagnostics off: no recorder events, no per-leaf fetch; telemetry off:
  no training series;
* the four step spans, the stall watchdog armed only inside a step
  (driven on a manual clock), ``telemetry.xla_annotations`` switching the
  spans' profiler ranges on, ``memory_breakdown``'s figures with the JAX
  keys;
* the monitor backends: the CSV writer byte-equal to JAX's; TensorBoard
  and wandb write where installed (``importorskip``) and, where the
  package is missing, warn and disable themselves.

Metric families, the flight recorder and the anomaly ledger are
process-global in both packages (shared by a test worker), so a fixture
gives every test fresh ones in both and restores the old after.
"""

import csv
import math
import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu import telemetry as jtel
from deepspeed_tpu.models import TransformerConfig as JCfg
from deepspeed_tpu.models import TransformerLM as JModel
from deepspeed_tpu.monitor import monitor as jmon
from deepspeed_tpu.parallel.topology import MeshTopology, TopologyConfig
from deepspeed_tpu.runtime.config import DeepSpeedConfig as JDSConfig
from deepspeed_tpu.runtime.engine import DeepSpeedTpuEngine as JEngine
from deepspeed_tpu.telemetry import anomaly as janomaly
from deepspeed_tpu.telemetry import postmortem as jpostmortem
from deepspeed_tpu.utils import memory as jmemory

import deepspeed_tpu_torch
from deepspeed_tpu_torch import telemetry as ttel
from deepspeed_tpu_torch.checkpoint.interop import params_from_numpy
from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM
from deepspeed_tpu_torch.monitor import monitor as tmon
from deepspeed_tpu_torch.runtime.config import (DeepSpeedConfig,
                                                unported_keys)
from deepspeed_tpu_torch.telemetry import anomaly as tanomaly
from deepspeed_tpu_torch.telemetry import postmortem as tpostmortem
from deepspeed_tpu_torch.telemetry import trace as ttrace
from deepspeed_tpu_torch.utils import memory as tmemory

torch.set_num_threads(2)

S, MICRO, GAS = 128, 2, 2
FLAGSHIP_SMALL = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
                      num_layers=2, num_heads=8, num_kv_heads=4,
                      max_seq_len=128, flash_min_seq=128)
REL = 1e-5


@pytest.fixture(autouse=True)
def fresh():
    """Fresh registries, recorders, anomaly ledgers and post-mortem
    state in both packages."""
    saved = []
    for tel, anom, pm in ((jtel, janomaly, jpostmortem),
                          (ttel, tanomaly, tpostmortem)):
        saved.append((tel, tel.set_registry(tel.MetricsRegistry()),
                      tel.set_recorder(tel.FlightRecorder())))
        anom.reset()
        pm._reset_for_tests()
    yield
    for tel, reg, rec in saved:
        tel.set_registry(reg)
        tel.set_recorder(rec)
    for anom, pm in ((janomaly, jpostmortem), (tanomaly, tpostmortem)):
        anom.reset()
        pm._reset_for_tests()


@pytest.fixture(scope="module")
def weights():
    jmodel = JModel(JCfg(**FLAGSHIP_SMALL))
    return jax.tree.map(lambda x: np.asarray(x, np.float32),
                        jmodel.init_params(jax.random.PRNGKey(0)))


def _config(tmp, name, **extra):
    cfg = {
        "train_micro_batch_size_per_gpu": MICRO,
        "gradient_accumulation_steps": GAS,
        "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
        "gradient_clipping": 1.0,
        "steps_per_print": 10 ** 9,
        "telemetry": {"enabled": True, "flush_interval": 1},
        "diagnostics": {"postmortem_dir": str(tmp / f"pm_{name}"),
                        "postmortem_on_anomaly": True,
                        "postmortem_min_interval_s": 0.0,
                        "stall_enabled": False},
        "csv_monitor": {"enabled": True, "output_path": str(tmp),
                        "job_name": name},
    }
    for k, v in extra.items():
        cfg[k] = dict(cfg.get(k, {}), **v) if isinstance(v, dict) else v
    return cfg


def _engines(tmp, weights, **extra):
    jcfg = _config(tmp, "jax", **extra)
    jeng = JEngine(JModel(JCfg(**FLAGSHIP_SMALL)),
                   JDSConfig(jcfg, world_size=1),
                   topology=MeshTopology(TopologyConfig(),
                                         devices=jax.devices()[:1]))
    jw = jax.tree.map(lambda x: np.asarray(x, np.float32), jeng.params)
    teng, *_ = deepspeed_tpu_torch.initialize(
        model=TransformerLM(TransformerConfig(**FLAGSHIP_SMALL)),
        config=_config(tmp, "port", **extra), params=params_from_numpy(jw),
        device="cpu")
    return jeng, teng


def _ids(seed):
    return np.random.default_rng(seed).integers(0, 256, (GAS, MICRO, S),
                                                dtype=np.int64)


def _close(a, b):
    return abs(a - b) <= REL * max(abs(a), abs(b), 1e-12)


def _rows(path):
    with open(path) as fh:
        return list(csv.reader(fh))


SERIES = ("training_loss", "training_grad_norm", "training_lr",
          "training_loss_scale",
          "training_steps_total", "training_skipped_steps_total",
          "training_samples_total", "training_reduce_bucket_bytes",
          "training_reduce_quantized_bytes",
          "training_quant_error_feedback_norm",
          "training_comm_exposed_fraction")


def test_training_series_and_csv_match_jax(tmp_path, weights):
    jeng, teng = _engines(tmp_path, weights)
    losses, norms = [], []
    for s in range(3):
        b = {"input_ids": _ids(s)}
        jl = float(jeng.train_batch(batch=b))
        tl = teng.train_batch(batch=b)
        assert _close(tl, jl), (tl, jl)
        losses.append(tl)
        norms.append(teng.get_global_grad_norm())
    jreg, treg = jtel.get_registry(), ttel.get_registry()
    assert {f.name for f in treg.families()
            if f.name.startswith("training_")} == set(SERIES + (
                "training_step_seconds",))
    for name in SERIES:
        a, b = jreg.get(name).value, treg.get(name).value
        assert _close(a, b), (name, a, b)
    assert treg.get("training_loss").value == losses[-1]
    assert treg.get("training_grad_norm").value == norms[-1]
    assert treg.get("training_steps_total").value == 3
    assert treg.get("training_step_seconds").count == \
        jreg.get("training_step_seconds").count == 3
    teng.close()
    jeng.destroy()
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    for tag in ("Train_loss", "Train_lr"):
        jr, tr = _rows(jdir / f"{tag}.csv"), _rows(tdir / f"{tag}.csv")
        assert jr[0] == tr[0] == ["step", tag.replace("_", "/")]
        assert [r[0] for r in tr[1:]] == [r[0] for r in jr[1:]] == \
            ["1", "2", "3"]
        for a, b in zip(jr[1:], tr[1:]):
            assert _close(float(a[1]), float(b[1])), (tag, a, b)
    assert [float(r[1]) for r in _rows(tdir / "Train_loss.csv")[1:]] == \
        losses
    common = sorted(f for f in os.listdir(tdir)
                    if f.startswith("training_") and "seconds" not in f
                    and f in os.listdir(jdir))
    assert "training_loss.csv" in common and "training_lr.csv" in common
    for f in common:
        jr, tr = _rows(jdir / f), _rows(tdir / f)
        assert [r[0] for r in jr] == [r[0] for r in tr], f
        for a, b in zip(jr[1:], tr[1:]):
            assert _close(float(a[1]), float(b[1])), (f, a, b)


def test_nan_leaf_verdict_matches_jax(tmp_path, weights):
    jeng, teng = _engines(tmp_path, weights)
    for s in range(3):
        jeng.train_batch(batch={"input_ids": _ids(s)})
        teng.train_batch(batch={"input_ids": _ids(s)})
    b = {"input_ids": _ids(9)}
    tok = int(b["input_ids"][0, 0, 0])
    jeng.params["embed"] = jeng.params["embed"].at[tok, 0].set(jnp.nan)
    with torch.no_grad():
        teng.params["embed"][tok, 0] = float("nan")
    assert math.isnan(float(jeng.train_batch(batch=b)))
    assert math.isnan(teng.train_batch(batch=b))
    (jv,), (tv,) = janomaly.recent(), tanomaly.recent()
    assert jv["kind"] == tv["kind"] == "nan_loss"
    assert [t["bucket"] for t in tv["top_buckets"]] == \
        [t["bucket"] for t in jv["top_buckets"]]
    assert tv["top_buckets"][0] == {"bucket": "embed", "grad_norm": None,
                                    "z": None, "non_finite": True}
    for pm, root in ((jpostmortem, "pm_jax"), (tpostmortem, "pm_port")):
        path = pm.last_bundle()
        assert path and root in path
        assert os.path.exists(os.path.join(path, "anomalies.json"))
    kinds = {e["kind"] for e in ttel.get_recorder().events()}
    assert {"train_step", "anomaly"} <= kinds
    teng.close()
    jeng.destroy()


def test_attribution_off_names_no_bucket(tmp_path, weights):
    jeng, teng = _engines(tmp_path, weights,
                          diagnostics={"grad_attribution": False})
    b = {"input_ids": _ids(1)}
    jeng.params["embed"] = jeng.params["embed"].at[0, 0].set(jnp.inf)
    with torch.no_grad():
        teng.params["embed"][0, 0] = float("inf")
    b["input_ids"][:, :, 0] = 0
    jeng.train_batch(batch=b)
    teng.train_batch(batch=b)
    assert janomaly.recent()[-1]["top_buckets"] == \
        tanomaly.recent()[-1]["top_buckets"] == []
    teng.close()
    jeng.destroy()


def test_diagnostics_and_telemetry_off(tmp_path, weights):
    _, teng = _engines(tmp_path, weights, diagnostics={"enabled": False})
    out = teng._run_step(teng._shard_batch({"input_ids": _ids(2)}))
    assert out["leaf_sqnorms"] is None
    teng.train_batch(batch={"input_ids": _ids(2)})
    assert ttel.get_recorder().events(kind="train_step") == []
    assert ttel.get_registry().get("training_loss") is not None
    teng.close()
    ttel.set_registry(ttel.MetricsRegistry())
    off, *_ = deepspeed_tpu_torch.initialize(
        model=TransformerLM(TransformerConfig(**FLAGSHIP_SMALL)),
        config=_config(tmp_path, "off", telemetry={"enabled": False}),
        device="cpu")
    off.train_batch(batch={"input_ids": _ids(2)})
    assert not off.telemetry_enabled and not off.diagnostics_enabled
    assert ttel.get_registry().get("training_loss") is None


def test_step_spans_and_stall_watchdog(tmp_path, weights):
    """The four spans of a step; the watchdog (on a manual clock) is
    armed inside the step only: a step that outlives its deadline trips
    it, the idle time between steps does not."""
    _, teng = _engines(tmp_path, weights,
                       diagnostics={"stall_enabled": True,
                                    "stall_min_deadline_s": 5.0,
                                    "stall_factor": 0.01,
                                    "stall_check_interval_s": 3600.0})
    now = [1000.0]
    teng._watchdog_clock = lambda: now[0]
    ttrace.clear()
    teng.train_batch(batch={"input_ids": _ids(3)})
    names = {s["name"] for s in ttrace.export()}
    assert {"train_data", "train_step", "train_device_dispatch",
            "train_host_sync"} <= names
    wd = teng._stall_watchdog
    now[0] += 100.0                    # idle between steps: silence
    assert wd.check_now() == []
    inner = teng._run_step
    seen = []

    def wedged(dev_batch):
        now[0] += 60.0                 # the step hangs past its deadline
        seen.extend(wd.check_now())
        return inner(dev_batch)

    teng._run_step = wedged
    teng.train_batch(batch={"input_ids": _ids(4)})
    assert [v["kind"] for v in seen] == ["stall"]
    assert seen[0]["channel"] == "train_step"
    assert wd.heartbeat_age("train_step") is None   # disarmed after it
    teng.close()
    assert teng._stall_watchdog is None


def test_xla_annotations_and_memory_breakdown(tmp_path, weights):
    try:
        _, teng = _engines(tmp_path, weights, memory_breakdown=True,
                           telemetry={"xla_annotations": True})
        assert ttrace._profiler_annotations
    finally:
        ttrace.enable_profiler_annotations(False)
    assert set(teng.memory_breakdown) == set(
        jmemory.see_memory_usage("probe")) == {
            "device_used_gb", "device_peak_gb", "device_limit_gb",
            "host_max_rss_gb"}
    assert teng.memory_breakdown["device_used_gb"] == 0.0
    assert teng.memory_breakdown["host_max_rss_gb"] > 0
    assert tmemory.see_memory_usage("probe", device="cpu")[
        "device_limit_gb"] == 0.0
    teng.close()


def test_config_blocks_are_ported(tmp_path):
    cfg = DeepSpeedConfig(_config(tmp_path, "x", memory_breakdown=True,
                                  tensorboard={"enabled": True},
                                  wandb={"enabled": True},
                                  checkpoint={"load_universal": True}))
    assert unported_keys(cfg) == []


# ---------------------------------------------------------------------------
# the backends
# ---------------------------------------------------------------------------
class _Block:
    def __init__(self, **kw):
        self.__dict__.update(dict(enabled=True, output_path="", job_name="j",
                                  project="p", group=None, team=None), **kw)


class _Blocks:
    def __init__(self, tmp, **enabled):
        for name in ("tensorboard", "wandb", "csv_monitor"):
            setattr(self, name, _Block(enabled=enabled.get(name, False),
                                       output_path=str(tmp / name)))


EVENTS = [("Train/loss", 1.5, 1), ("Train/lr", 1e-3, 1),
          ("Train/loss", 1.25, 2), ("eval/acc", 0.5, 2)]


def test_csv_monitor_files_equal_jax(tmp_path):
    jm = jmon.MonitorMaster(_Blocks(tmp_path / "jax", csv_monitor=True))
    tm = tmon.MonitorMaster(_Blocks(tmp_path / "port", csv_monitor=True))
    assert jm.enabled and tm.enabled
    jm.write_events(EVENTS)
    tm.write_events(EVENTS)
    jdir = tmp_path / "jax" / "csv_monitor" / "j"
    tdir = tmp_path / "port" / "csv_monitor" / "j"
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir)) == [
        "Train_loss.csv", "Train_lr.csv", "eval_acc.csv"]
    for f in os.listdir(jdir):
        assert (jdir / f).read_bytes() == (tdir / f).read_bytes(), f
    assert not tmon.MonitorMaster(_Blocks(tmp_path / "none")).enabled


def test_missing_backend_packages_disable_themselves(tmp_path, monkeypatch,
                                                     caplog):
    """No wandb / tensorboard installed (the card has neither): each
    enabled backend warns and turns itself off; training is not
    stopped."""
    monkeypatch.setitem(sys.modules, "wandb", None)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    m = tmon.MonitorMaster(_Blocks(tmp_path, tensorboard=True, wandb=True,
                                   csv_monitor=True))
    assert not m.tb.enabled and not m.wandb.enabled and m.csv.enabled
    m.write_events(EVENTS)
    assert (tmp_path / "csv_monitor" / "j" / "Train_loss.csv").exists()


def test_tensorboard_backend(tmp_path):
    pytest.importorskip("tensorboard")
    m = tmon.TensorBoardMonitor(_Block(output_path=str(tmp_path)))
    assert m.enabled and m.summary_writer is not None
    m.write_events(EVENTS)
    assert os.listdir(tmp_path / "j")


def test_wandb_backend(tmp_path, monkeypatch):
    pytest.importorskip("wandb")
    monkeypatch.setenv("WANDB_MODE", "disabled")
    m = tmon.WandbMonitor(_Block())
    assert m.enabled
    m.write_events(EVENTS)
