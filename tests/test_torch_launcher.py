"""PyTorch port: the launcher and the dataloader (after JAX
``tests/unit/launcher/test_multiprocess.py``).

Two workers started by ``launch.main`` read the launcher's environment in
``comm.init_distributed`` and all-reduce over gloo; a worker that exits 1
takes the group down with a non-zero exit. ``DeepSpeedDataLoader`` yields
the JAX loader's batches for the same dataset and seed.
"""

import json
import os
import signal
import socket
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from deepspeed_tpu.runtime import dataloader as jdl

from deepspeed_tpu_torch.launcher import launch
from deepspeed_tpu_torch.runtime import dataloader as tdl

# the suite runs in several worker processes that share the CPUs: a
# small intra-op pool keeps torch from crowding out the other workers
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
HANG_GUARD_S = 180

WORKER = """
import json, os, sys, time
import torch
torch.set_num_threads(1)
from deepspeed_tpu_torch.comm import comm
out, mode = sys.argv[1], sys.argv[2]
comm.init_distributed()
rank = comm.get_rank()
if mode == "fail" and rank == 1:
    sys.exit(1)
if mode == "fail":
    time.sleep(120)                 # the launcher must kill this
    open(os.path.join(out, "survived"), "w").close()
    sys.exit(0)
x = torch.tensor([float(rank + 1)])
comm.all_reduce(x)
env = {k: os.environ[k] for k in ("DS_TPU_COORDINATOR", "DS_TPU_NUM_PROCESSES",
       "DS_TPU_PROCESS_ID", "LOCAL_RANK", "RANK", "WORLD_SIZE", "MASTER_ADDR",
       "MASTER_PORT")}
json.dump({"sum": x.item(), "world": comm.get_world_size(),
           "backend": comm.get_backend(), "env": env},
          open(os.path.join(out, f"rank{rank}.json"), "w"))
comm.barrier()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def worker_env(monkeypatch, tmp_path):
    """The workers import the port from this checkout, with small thread
    pools, and see no rendezvous variables but the launcher's."""
    for k in list(os.environ):
        if k.startswith(("DS_TPU_", "MASTER_", "RANK", "WORLD_SIZE",
                         "LOCAL_RANK")):
            monkeypatch.delenv(k)
    monkeypatch.setenv("PYTHONPATH", str(ROOT))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    return script


def _kill_listed(pid_file):
    try:
        pids = Path(pid_file).read_text().split()
    except OSError:
        return
    for pid in pids:
        try:
            os.kill(int(pid), signal.SIGKILL)
        except ProcessLookupError:
            pass


def test_two_workers_init_and_all_reduce(worker_env, tmp_path):
    port = _free_port()
    pids = tmp_path / "pids"
    # hang guard: past it the workers are killed and the launcher returns
    # their non-zero exit
    guard = threading.Timer(HANG_GUARD_S, _kill_listed, args=(pids,))
    handlers = {s: signal.getsignal(s) for s in (signal.SIGINT,
                                                 signal.SIGTERM)}
    guard.start()
    try:
        rc = launch.main([
            "--nproc_per_node", "2", "--master_addr", "127.0.0.1",
            "--master_port", str(port), "--pid_file", str(pids),
            str(worker_env), str(tmp_path), "ok"])
    finally:
        guard.cancel()
        for s, h in handlers.items():   # main() installs its own
            signal.signal(s, h)
    assert rc == 0
    assert not pids.exists()            # removed after the group
    for r in range(2):
        out = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert out["sum"] == 3.0 and out["world"] == 2
        assert out["backend"] == "gloo"
        env = out["env"]
        assert env["DS_TPU_COORDINATOR"] == f"127.0.0.1:{port}"
        assert env["DS_TPU_NUM_PROCESSES"] == env["WORLD_SIZE"] == "2"
        assert env["DS_TPU_PROCESS_ID"] == env["RANK"] == \
            env["LOCAL_RANK"] == str(r)
        assert (env["MASTER_ADDR"], env["MASTER_PORT"]) == \
            ("127.0.0.1", str(port))


def test_failed_worker_takes_the_group_down(worker_env, tmp_path):
    port = _free_port()
    launcher = launch.NodeLauncher(
        [sys.executable, str(worker_env), str(tmp_path), "fail"], nproc=2,
        num_processes=2, coordinator=f"127.0.0.1:{port}",
        pid_file=str(tmp_path / "pids"))
    launcher.spawn()
    assert len((tmp_path / "pids").read_text().split()) == 2
    guard = threading.Timer(HANG_GUARD_S, launcher.kill_all,
                            args=(signal.SIGKILL,))
    guard.start()
    try:
        rc = launcher.monitor()
    finally:
        guard.cancel()
    assert rc != 0
    assert all(p.poll() is not None for p in launcher.procs)
    assert not (tmp_path / "survived").exists()


# ---------------------------------------------------------------------------
# the dataloader
# ---------------------------------------------------------------------------
def _dataset(kind):
    rng = np.random.default_rng(5)
    if kind == "dict":
        return [{"input_ids": rng.integers(0, 100, (16,)),
                 "loss_mask": rng.integers(0, 2, (16,))} for _ in range(22)]
    return [(rng.normal(size=(4,)).astype(np.float32), np.int64(i))
            for i in range(22)]


@pytest.mark.parametrize("kind", ["dict", "tuple"])
@pytest.mark.parametrize("shuffle,drop_last,world", [
    (False, True, 1), (True, True, 2), (True, False, 2), (False, False, 4)])
def test_dataloader_matches_jax(kind, shuffle, drop_last, world):
    data = _dataset(kind)
    kw = dict(micro_batch_size=3, dp_world_size=world, shuffle=shuffle,
              seed=9, drop_last=drop_last)
    ref, got = jdl.DeepSpeedDataLoader(data, **kw), \
        tdl.DeepSpeedDataLoader(data, **kw)
    assert len(got) == len(ref)
    for _epoch in range(2):         # the shuffle's seed moves per epoch
        rb, gb = list(ref), list(got)
        assert len(rb) == len(gb)
        for r, g in zip(rb, gb):
            r_leaves = r.values() if kind == "dict" else r
            g_leaves = g.values() if kind == "dict" else g
            for x, y in zip(r_leaves, g_leaves):
                np.testing.assert_array_equal(np.asarray(x), y)


def test_repeating_loader_restarts():
    loader = tdl.RepeatingLoader([1, 2])
    assert [next(loader) for _ in range(5)] == [1, 2, 1, 2, 1]
