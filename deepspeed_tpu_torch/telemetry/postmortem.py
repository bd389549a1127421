"""Post-mortem bundles: one call writes everything a debugger needs.

A production incident's evidence is scattered across the registry, the
trace ring, the memory tables, the compiler fingerprint, the flight
recorder, and the anomaly ledger — and all of it is process-local, so
it dies with the process. :func:`write_bundle` snapshots the lot into a
dated directory::

    postmortems/postmortem-20260803-141523-nan_loss/
      manifest.json     # reason, time, versions, file index
      metrics.json      # registry snapshot() (every series)
      timeline.json     # Chrome-trace JSON of the span ring buffer
      memory.json       # memory.oom_report() (buffers + device readings)
      fingerprint.json  # compiler_fingerprint()
      recorder.json     # last-N flight-recorder events
      anomalies.json    # recent anomaly verdicts

Surfaces: ``POST /debug/postmortem`` on the serving API, the training
engine's anomaly hook (``diagnostics.postmortem_on_anomaly``), and
:func:`install_crash_handler` — an unhandled-exception hook (bundle +
re-raise) plus an ``atexit`` pass that writes a bundle only when
anomalies were recorded and none was captured yet (a clean exit stays
silent).

Bundles are rate-limited (``diagnostics.postmortem_min_interval_s``)
PER REASON KIND: an anomaly firing every step must not turn the disk
into the hot path, but a chatty ``slo_burn`` must also never suppress
the bundle for a subsequent ``nan_loss`` or ``stall`` verdict — each
kind owns its own interval.

Fleet bundles (:func:`write_fleet_bundle`): a routed deployment's
incident evidence spans the router and every replica. The router
collects one dated ``fleet-*`` bundle — its own routing state, the
shared process artifacts, and a per-replica section (metrics from the
replica's registry, the replica's lane of the trace ring) — under one
cross-replica manifest (docs/SERVING.md § Post-mortem bundles).

Port note: a copy of ``deepspeed_tpu/telemetry/postmortem.py``. There
the fingerprint comes from the JAX package's ``env_report`` (jax and
libtpu versions, XLA flags); :func:`compiler_fingerprint` here gives the
torch, CUDA, driver and ``nvcc`` versions.
"""

import atexit
import json
import os
import sys
import threading
import time
from typing import Any, Dict, Optional

from ..utils.logging import logger
from . import anomaly as ds_anomaly
from . import memory as ds_memory
from . import recorder as ds_recorder
from . import timeline
from .anomaly import DiagnosticsConfig
from .registry import get_registry

def _nvcc_version() -> Optional[str]:
    """``nvcc --version``'s release line, or None without a toolkit."""
    import shutil
    import subprocess
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
        nvcc = cand if os.path.exists(cand) else None
    if nvcc is None:
        return None
    try:
        out = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = [ln for ln in out.splitlines() if "release" in ln]
    return lines[-1].strip() if lines else out.strip() or None


def compiler_fingerprint() -> Dict[str, Any]:
    """The toolchain a run was built and launched under: torch, its CUDA
    and cuDNN, the CUDA driver (``nvidia-smi``), the card, and ``nvcc``."""
    import subprocess

    import torch
    fp: Dict[str, Any] = {
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "cudnn": (torch.backends.cudnn.version()
                  if torch.backends.cudnn.is_available() else None),
        "cuda_available": torch.cuda.is_available(),
        "device": (torch.cuda.get_device_name(0)
                   if torch.cuda.is_available() else None),
        "driver": None,
        "nvcc": _nvcc_version(),
    }
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=driver_version",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        if out.returncode == 0 and out.stdout.strip():
            fp["driver"] = out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        pass
    return fp


_lock = threading.Lock()
# rate-limit clocks keyed per reason kind (satellite fix: one chatty
# kind must not suppress bundles for the others inside its window)
_last_bundle_t: Dict[str, float] = {}
_last_bundle_path_by_kind: Dict[str, str] = {}
_last_bundle_path: Optional[str] = None
_installed = False


def _dump(path: str, obj: Any) -> str:
    with open(path, "w") as fh:
        json.dump(obj, fh, indent=2, default=str)
    return os.path.basename(path)


def last_bundle() -> Optional[str]:
    """Path of the most recent bundle this process wrote (None yet)."""
    return _last_bundle_path


# -- shared bundle scaffolding ---------------------------------------------
def _check_rate_limit(kind: str, cfg: DiagnosticsConfig, force: bool):
    """(now, prev_path): ``prev_path`` is non-None when ``kind`` is
    inside its rate window and the caller must return it unwritten."""
    with _lock:
        now = time.time()
        prev = _last_bundle_path_by_kind.get(kind)
        if (not force and prev is not None
                and now - _last_bundle_t.get(kind, 0.0)
                < cfg.postmortem_min_interval_s):
            return now, prev
        _last_bundle_t[kind] = now
    return now, None


def _bundle_dir(prefix: str, reason: str, now: float, root: str) -> str:
    """Create and return the dated, reason-sanitized, collision-suffixed
    bundle directory."""
    safe_reason = "".join(c if c.isalnum() or c in "-_" else "_"
                          for c in reason)[:48] or "manual"
    stamp = time.strftime("%Y%m%d-%H%M%S", time.localtime(now))
    path = os.path.join(root, f"{prefix}-{stamp}-{safe_reason}")
    suffix = 1
    while os.path.exists(path):   # several bundles in one second
        suffix += 1
        path = os.path.join(root,
                            f"{prefix}-{stamp}-{safe_reason}-{suffix}")
    os.makedirs(path, exist_ok=True)
    return path


def _section_writer(path: str):
    """(section, files, errors): ``section(name, fn, sub=None)`` dumps
    ``fn()`` to ``[sub/]name.json`` best-effort — a failing artifact is
    recorded in ``errors``, never raised out of a crash handler."""
    files: Dict[str, str] = {}
    errors: Dict[str, str] = {}

    def section(name: str, fn, sub: Optional[str] = None) -> None:
        key = f"{sub}/{name}" if sub else name
        try:
            d = os.path.join(path, sub) if sub else path
            os.makedirs(d, exist_ok=True)
            rel = _dump(os.path.join(d, f"{name}.json"), fn())
            files[key] = os.path.join(sub, rel) if sub else rel
        except Exception as e:   # pragma: no cover - defensive
            errors[key] = f"{type(e).__name__}: {e}"

    return section, files, errors


def _finish_bundle(path: str, kind: str, manifest: Dict[str, Any],
                   extra: Optional[Dict[str, Any]],
                   errors: Dict[str, str]) -> None:
    """Write the manifest and publish the path under ``kind``'s
    rate-limit clock."""
    global _last_bundle_path
    if extra:
        manifest["extra"] = extra
    if errors:
        manifest["collection_errors"] = errors
    _dump(os.path.join(path, "manifest.json"), manifest)
    with _lock:
        _last_bundle_path = path
        _last_bundle_path_by_kind[kind] = path


def write_bundle(reason: str = "manual",
                 config: Optional[DiagnosticsConfig] = None,
                 out_dir: Optional[str] = None,
                 extra: Optional[Dict[str, Any]] = None,
                 force: bool = True) -> Optional[str]:
    """Write one bundle; returns its directory path.

    ``force=False`` honors the rate limit
    (``postmortem_min_interval_s`` since the last bundle OF THIS REASON
    KIND → returns that kind's previous path instead of writing; a
    different kind inside the window still writes). Collection is
    best-effort per artifact: a failing section is recorded in the
    manifest, never an exception out of a crash handler."""
    cfg = config or DiagnosticsConfig()
    now, prev = _check_rate_limit(reason, cfg, force)
    if prev is not None:
        return prev
    path = _bundle_dir("postmortem", reason, now,
                       out_dir or cfg.postmortem_dir)
    section, files, errors = _section_writer(path)

    section("metrics", lambda: get_registry().snapshot())
    section("timeline", lambda: timeline.to_chrome_trace())
    section("memory", lambda: ds_memory.oom_report())
    section("recorder", lambda: {
        "stats": ds_recorder.get_recorder().stats(),
        "events": ds_recorder.get_recorder().events(
            last=cfg.postmortem_last_events)})
    section("anomalies", lambda: ds_anomaly.recent())

    def fingerprint():
        return compiler_fingerprint()
    section("fingerprint", fingerprint)

    manifest: Dict[str, Any] = {
        "reason": reason, "written_at": now,
        "written_at_iso": time.strftime("%Y-%m-%dT%H:%M:%S",
                                        time.localtime(now)),
        "pid": os.getpid(), "files": files,
    }
    _finish_bundle(path, reason, manifest, extra, errors)
    logger.warning(f"post-mortem bundle written: {path} (reason={reason})")
    return path


def maybe_write_bundle(reason: str,
                       config: Optional[DiagnosticsConfig] = None,
                       **kw) -> Optional[str]:
    """Rate-limited :func:`write_bundle` (the anomaly-hook entry)."""
    return write_bundle(reason, config=config, force=False, **kw)


def write_fleet_bundle(reason: str, router,
                       config: Optional[DiagnosticsConfig] = None,
                       out_dir: Optional[str] = None,
                       extra: Optional[Dict[str, Any]] = None,
                       force: bool = True) -> Optional[str]:
    """One dated ``fleet-*`` bundle for a routed deployment: the
    router's routing state, the shared process artifacts, and a section
    per replica, under one cross-replica manifest.

    ``router`` is duck-typed (the :class:`~...serve.router.ReplicaRouter`
    surface: ``replicas``, ``health()``, ``router_statusz()``,
    ``replica_statusz()``, optional per-replica ``registry``). Layout::

        fleet-20260803-141523-stall/
          manifest.json        # reason, replica roster + states, index
          router.json          # health + routing + per-replica rollups
          metrics.json         # process-default registry snapshot
          timeline.json        # stitched fleet trace (all lanes)
          recorder.json        # last-N flight-recorder events
          anomalies.json       # recent verdicts
          fingerprint.json     # compiler fingerprint
          <replica>/metrics.json   # the replica's own registry (when
                                   # it has one) — federation unit
          <replica>/timeline.json  # the replica's lane of the trace

    Same per-kind rate limit as single-process bundles (``force=False``
    defers to the last fleet bundle of this reason kind; the ``fleet:``
    key prefix keeps fleet and single-process windows distinct)."""
    cfg = config or DiagnosticsConfig()
    kind = f"fleet:{reason}"
    now, prev = _check_rate_limit(kind, cfg, force)
    if prev is not None:
        return prev
    path = _bundle_dir("fleet", reason, now, out_dir or cfg.postmortem_dir)
    section, files, errors = _section_writer(path)

    section("router", lambda: {"health": router.health(),
                               "routing": router.router_statusz(),
                               "replicas": router.replica_statusz()})
    section("metrics", lambda: get_registry().snapshot())
    section("timeline", lambda: timeline.stitch_fleet())
    section("recorder", lambda: {
        "stats": ds_recorder.get_recorder().stats(),
        "events": ds_recorder.get_recorder().events(
            last=cfg.postmortem_last_events)})
    section("anomalies", lambda: ds_anomaly.recent())

    def fingerprint():
        return compiler_fingerprint()
    section("fingerprint", fingerprint)

    from . import trace as ds_trace
    spans = ds_trace.export()
    roster: Dict[str, Any] = {}
    default_reg = get_registry()
    for replica in getattr(router, "replicas", ()):
        name = replica.name
        roster[name] = {"state": replica.state}
        reg = getattr(replica, "registry", None)
        if reg is not None and reg is not default_reg:
            section("metrics", reg.snapshot, sub=name)
        section("timeline",
                lambda nm=name: timeline.stitch_fleet(
                    {nm: [s for s in spans if s.get("lane") == nm]}),
                sub=name)

    manifest: Dict[str, Any] = {
        "reason": reason, "kind": "fleet", "written_at": now,
        "written_at_iso": time.strftime("%Y-%m-%dT%H:%M:%S",
                                        time.localtime(now)),
        "pid": os.getpid(), "replicas": roster, "files": files,
    }
    _finish_bundle(path, kind, manifest, extra, errors)
    logger.warning(
        f"fleet post-mortem bundle written: {path} (reason={reason}, "
        f"{len(roster)} replica(s))")
    return path


def maybe_write_fleet_bundle(reason: str, router,
                             config: Optional[DiagnosticsConfig] = None,
                             **kw) -> Optional[str]:
    """Rate-limited :func:`write_fleet_bundle` (the router's anomaly
    trigger entry)."""
    return write_fleet_bundle(reason, router, config=config, force=False,
                              **kw)


def install_crash_handler(config: Optional[DiagnosticsConfig] = None,
                          out_dir: Optional[str] = None) -> bool:
    """Install the unhandled-exception and atexit bundle hooks
    (idempotent; returns True the first time). The excepthook chains to
    the previous one — the traceback still prints."""
    global _installed
    with _lock:
        if _installed:
            return False
        _installed = True
    cfg = config or DiagnosticsConfig()
    prev_hook = sys.excepthook

    def _hook(exc_type, exc, tb):
        try:
            write_bundle(f"unhandled_{exc_type.__name__}", config=cfg,
                         out_dir=out_dir,
                         extra={"exception": repr(exc)})
        except Exception:   # the handler must never mask the crash
            pass
        prev_hook(exc_type, exc, tb)

    sys.excepthook = _hook

    def _at_exit():
        # a clean exit writes nothing; an exit after anomalies with no
        # bundle captured yet is the black box's last chance
        try:
            if ds_anomaly.recent() and last_bundle() is None:
                write_bundle("atexit_with_anomalies", config=cfg,
                             out_dir=out_dir)
        except Exception:
            pass

    atexit.register(_at_exit)
    return True


def _reset_for_tests() -> None:
    """Drop the rate-limit/bundle-path state (test isolation only)."""
    global _last_bundle_path
    with _lock:
        _last_bundle_t.clear()
        _last_bundle_path_by_kind.clear()
        _last_bundle_path = None
