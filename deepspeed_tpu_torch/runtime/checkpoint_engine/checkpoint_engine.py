"""Pluggable checkpoint IO engines.

Port of ``deepspeed_tpu/runtime/checkpoint_engine/checkpoint_engine.py``
(reference runtime/checkpoint_engine/checkpoint_engine.py:9, the
``CheckpointEngine`` ABC: create / save / load / commit), in the same
format, so either package loads the other's files:

  * NativeCheckpointEngine — synchronous: a state dict of (nested) arrays
    or tensors -> one ``.npz`` (keys are the ``/``-joined paths) plus a
    ``.meta.json`` sidecar for the non-array leaves.
  * AsyncCheckpointEngine — the same format, but ``save()`` snapshots to
    host numpy and writes on a background thread; ``commit()`` joins and
    re-raises the first failed write (the Nebula engine's role: training
    goes on while the previous checkpoint persists).

A torch tensor (on the card or the host) is copied to host numpy at
``save()``; a bfloat16 tensor is written as float32 (lossless; ``.npz``
has no portable bfloat16), every other dtype as itself. ``load()``
returns numpy arrays, as the JAX engine does.
"""

import json
import os
import threading
from typing import Any, Dict, List

import numpy as np
import torch

from ...utils.logging import logger


class CheckpointEngine:
    """Reference ABC (checkpoint_engine.py:9)."""

    def __init__(self, config_params=None):
        self.config = config_params

    def create(self, tag: str):
        """Signal start of a new checkpoint under `tag`."""

    def makedirs(self, path, exist_ok=False):
        os.makedirs(path, exist_ok=exist_ok)

    def save(self, state_dict: Dict[str, Any], path: str):
        raise NotImplementedError

    def load(self, path: str, map_location=None) -> Dict[str, Any]:
        raise NotImplementedError

    def commit(self, tag: str) -> bool:
        """Durability barrier: all saves for `tag` are complete."""
        return True


def _flatten(d: Dict[str, Any], prefix: str = ""):
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _flatten(v, key + "/")
        else:
            yield key, v


def _unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split("/")
        cur = out
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return out


def _host_array(v) -> np.ndarray:
    """A copy of an array leaf in host memory as numpy (bfloat16 as
    float32)."""
    if isinstance(v, torch.Tensor):
        t = v.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.to("cpu", copy=True).numpy()
    return np.array(v, copy=True)


class NativeCheckpointEngine(CheckpointEngine):
    """Synchronous engine (reference TorchCheckpointEngine): a state dict of
    (nested) arrays -> one .npz + json sidecar for non-array leaves."""

    def save(self, state_dict: Dict[str, Any], path: str):
        arrays, meta = {}, {}
        for key, v in _flatten(state_dict):
            if hasattr(v, "shape"):
                arrays[key] = (v if isinstance(v, np.ndarray)
                               else _host_array(v))
            else:
                meta[key] = v
        np.savez(path, **arrays)
        with open(path + ".meta.json", "w") as fh:
            json.dump(meta, fh, default=str)
        logger.info(f"[NativeCheckpointEngine] saved {path}")

    def load(self, path: str, map_location=None) -> Dict[str, Any]:
        flat: Dict[str, Any] = {}
        with np.load(path if path.endswith(".npz") else path + ".npz",
                     allow_pickle=False) as arc:
            for key in arc.files:
                flat[key] = arc[key]
        meta_path = (path[:-4] if path.endswith(".npz") else path) \
            + ".meta.json"
        if not os.path.exists(meta_path):
            meta_path = path + ".meta.json"
        if os.path.exists(meta_path):
            with open(meta_path) as fh:
                flat.update(json.load(fh))
        return _unflatten(flat)


class AsyncCheckpointEngine(NativeCheckpointEngine):
    """Background-thread writes (reference NebulaCheckpointEngine's role):
    save() returns after snapshotting to host memory; the write persists
    on a background thread. At most ``max_writers`` writes run at once
    (``config_params={"max_writers": n}``): a caller that outruns the
    disk blocks in save() holding one extra snapshot instead of queueing
    snapshots without limit. Write failures are captured per thread and
    re-raised at the commit() barrier — a checkpoint is durable only if
    commit() returns, never merely because join() succeeded."""

    DEFAULT_MAX_WRITERS = 4

    def __init__(self, config_params=None):
        super().__init__(config_params)
        max_writers = self.DEFAULT_MAX_WRITERS
        if isinstance(config_params, dict):
            max_writers = int(config_params.get("max_writers", max_writers))
        if max_writers < 1:
            # a plain assert vanishes under python -O, and
            # BoundedSemaphore(0) would hang the first save() forever
            raise ValueError(
                f"max_writers must be >= 1, got {max_writers}")
        self.max_writers = max_writers
        self._slots = threading.BoundedSemaphore(max_writers)
        self._pending: List[threading.Thread] = []
        self._errors: List[tuple] = []          # (path, exception)
        self._err_lock = threading.Lock()

    def save(self, state_dict: Dict[str, Any], path: str):
        # snapshot BEFORE blocking on a writer slot: the caller's arrays
        # (a card tensor the next step overwrites) are captured at save()
        # time even if all slots are busy
        snapshot = {k: (_host_array(v) if hasattr(v, "shape") else v)
                    for k, v in _flatten(state_dict)}
        self._slots.acquire()

        def write():
            try:
                NativeCheckpointEngine.save(self, _unflatten(snapshot), path)
            except BaseException as e:
                with self._err_lock:
                    self._errors.append((path, e))
            finally:
                self._slots.release()

        t = threading.Thread(target=write, daemon=True)
        t.start()
        self._pending.append(t)

    def commit(self, tag: str) -> bool:
        """Durability barrier: joins every writer and RE-RAISES the first
        background failure (join() succeeding says nothing about the
        write). The engine stays usable after a failed commit."""
        for t in self._pending:
            t.join()
        self._pending.clear()
        with self._err_lock:
            errors, self._errors = self._errors, []
        if errors:
            path, first = errors[0]
            raise RuntimeError(
                f"[AsyncCheckpointEngine] commit({tag!r}): "
                f"{len(errors)} background write(s) failed; first: "
                f"{path}: {first!r}") from first
        logger.info(f"[AsyncCheckpointEngine] committed {tag}")
        return True
