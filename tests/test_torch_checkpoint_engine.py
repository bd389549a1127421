"""PyTorch port: the checkpoint IO engines against the JAX package's.

Mirrors JAX ``tests/unit/runtime/test_misc_runtime.py:94-160``: the
synchronous round trip, the async commit barrier, a failed background
write re-raised at ``commit()`` (the engine usable after it), at most
``max_writers`` writes at once, ``max_writers`` < 1 refused. Beyond
those: torch tensors (bf16 among them) are snapshotted at ``save()``, so
a tensor changed after the call is written as it was; and the files are
the JAX engine's format, each package loading the other's (arrays
bit-equal).
"""

import threading
import time

import numpy as np
import pytest
import torch

from deepspeed_tpu.runtime.checkpoint_engine import \
    NativeCheckpointEngine as JNative

from deepspeed_tpu_torch.runtime.checkpoint_engine import (
    AsyncCheckpointEngine, CheckpointEngine, NativeCheckpointEngine)

torch.set_num_threads(2)


def _state():
    return {"model": {"w": np.arange(6, dtype=np.float32).reshape(2, 3)},
            "step": 7, "tag": "x"}


def test_native_checkpoint_engine_roundtrip(tmp_path):
    eng = NativeCheckpointEngine()
    path = str(tmp_path / "ck.npz")
    eng.save(_state(), path)
    assert eng.commit("tag")
    loaded = eng.load(path)
    np.testing.assert_array_equal(loaded["model"]["w"],
                                  _state()["model"]["w"])
    assert int(loaded["step"]) == 7 and loaded["tag"] == "x"


def test_async_checkpoint_engine_commit_barrier(tmp_path):
    eng = AsyncCheckpointEngine()
    path = str(tmp_path / "ck_async.npz")
    eng.save(_state(), path)
    assert eng.commit("tag")  # joins the writer thread
    loaded = eng.load(path)
    np.testing.assert_array_equal(loaded["model"]["w"],
                                  _state()["model"]["w"])


def test_async_checkpoint_commit_reraises_write_failure(tmp_path):
    eng = AsyncCheckpointEngine()
    bad = str(tmp_path / "no_such_dir" / "ck.npz")   # open() will fail
    eng.save(_state(), bad)
    with pytest.raises(RuntimeError, match="background write"):
        eng.commit("tag")
    good = str(tmp_path / "ck_ok.npz")
    eng.save(_state(), good)
    assert eng.commit("tag2")
    np.testing.assert_array_equal(eng.load(good)["model"]["w"],
                                  _state()["model"]["w"])


def test_async_checkpoint_bounded_writers(tmp_path, monkeypatch):
    eng = AsyncCheckpointEngine({"max_writers": 2})
    live, peak = [0], [0]
    lock = threading.Lock()

    def slow_save(self, state, path):
        with lock:
            live[0] += 1
            peak[0] = max(peak[0], live[0])
        time.sleep(0.05)
        with lock:
            live[0] -= 1

    monkeypatch.setattr(NativeCheckpointEngine, "save", slow_save)
    for i in range(5):
        eng.save(_state(), str(tmp_path / f"ck{i}.npz"))
    assert eng.commit("tag")
    assert peak[0] <= 2, f"{peak[0]} writers ran concurrently"
    with pytest.raises(ValueError, match="max_writers"):
        AsyncCheckpointEngine({"max_writers": 0})


def test_base_engine_is_abstract(tmp_path):
    eng = CheckpointEngine()
    assert eng.commit("t")
    eng.makedirs(str(tmp_path / "a" / "b"), exist_ok=True)
    with pytest.raises(NotImplementedError):
        eng.save({}, str(tmp_path / "x.npz"))


def test_async_snapshots_torch_tensors_at_save(tmp_path):
    """The snapshot is taken at save(): tensors changed right after it
    are written as they were; bf16 lands as f32, other dtypes as
    themselves."""
    w = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    b = torch.linspace(-1, 1, 5).to(torch.bfloat16)
    n = torch.tensor([3, 4], dtype=torch.int64)
    want = (w.clone().numpy(), b.float().numpy(), n.clone().numpy())
    eng = AsyncCheckpointEngine({"max_writers": 1})
    path = str(tmp_path / "t.npz")
    eng.save({"m": {"w": w, "b": b}, "n": n, "step": 3}, path)
    w.add_(100.0)
    b.zero_()
    n.zero_()
    assert eng.commit("t")
    got = eng.load(path)
    np.testing.assert_array_equal(got["m"]["w"], want[0])
    np.testing.assert_array_equal(got["m"]["b"], want[1])
    assert got["m"]["b"].dtype == np.float32
    np.testing.assert_array_equal(got["n"], want[2])
    assert got["n"].dtype == np.int64 and got["step"] == 3


def test_files_load_in_both_packages(tmp_path):
    state = {"model": {"w": np.random.default_rng(0).standard_normal(
        (3, 4)).astype(np.float32), "h": np.arange(5, dtype=np.float16)},
        "step": 11, "tag": "z"}
    mine, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    NativeCheckpointEngine().save(state, mine)
    JNative().save(state, theirs)
    for a, b in ((JNative().load(mine), NativeCheckpointEngine().load(
            theirs)), (NativeCheckpointEngine().load(mine),
                       JNative().load(theirs))):
        for x in (a, b):
            np.testing.assert_array_equal(x["model"]["w"],
                                          state["model"]["w"])
            assert x["model"]["h"].dtype == np.float16
            assert x["step"] == 11 and x["tag"] == "z"
