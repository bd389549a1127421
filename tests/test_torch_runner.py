"""PyTorch port: the multi-node runner (``launcher/runner.py``) against the
JAX package (``tests/unit/launcher/test_runner.py``, case for case).

Held: hostfile parsing and the include / exclude filters give the JAX
package's hosts and errors; a node's command runs the port's node-local
spawner (``launcher/launch.py``) with ``--nnodes`` / ``--node_rank`` /
``--nproc_per_node`` (the hostfile's slots) / ``--master_addr`` /
``--master_port``; the PDSH, OpenMPI and Slurm commands are JAX's with the
node rank substituted where JAX substitutes its process id; ``parse_args``
splits the user script's arguments as JAX does; ``--autotuning tune``
writes the JAX package's report and winning config; ``--autotuning run``
exports ``DS_TPU_AUTOTUNED_CONFIG`` on the node command; one single-node
``main()`` launch of a 2-rank gloo script, whose ranks see the launcher's
``RANK`` / ``WORLD_SIZE`` / ``MASTER_PORT``.
"""

import json
import os
import shlex
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from deepspeed_tpu.launcher import runner as jrunner

from deepspeed_tpu_torch.launcher import runner

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
HANG_GUARD_S = 180


@pytest.fixture
def hostfile(tmp_path):
    p = tmp_path / "hostfile"
    p.write_text("""
# comment
worker-0 slots=4
worker-1 slots=4
worker-2 slots=8   # trailing comment
""")
    return str(p)


def test_parse_hostfile(hostfile, tmp_path):
    hosts = runner.parse_hostfile(hostfile)
    assert hosts == jrunner.parse_hostfile(hostfile)
    assert list(hosts) == ["worker-0", "worker-1", "worker-2"]
    assert hosts["worker-2"] == 8
    for text, match in (("a slots=1\na slots=2\n", "duplicate"),
                        ("# nothing\n\n", "empty")):
        p = tmp_path / "hf"
        p.write_text(text)
        for mod in (runner, jrunner):
            with pytest.raises(ValueError, match=match):
                mod.parse_hostfile(str(p))


@pytest.mark.parametrize("inc,exc", [("worker-2@worker-0", ""),
                                     ("", "worker-1"),
                                     ("worker-1@worker-2", "worker-2"),
                                     ("nope", ""), ("", "nope"),
                                     ("", "worker-0@worker-1@worker-2")])
def test_include_exclude(hostfile, inc, exc):
    hosts = runner.parse_hostfile(hostfile)

    def run(mod):
        try:
            return list(mod.parse_inclusion_exclusion(hosts, inc,
                                                      exc).items())
        except ValueError as e:
            return ("ValueError", str(e))

    assert run(runner) == run(jrunner)


def test_build_node_command():
    cmd = runner.build_node_command(
        "train.py", ["--lr", "0.1"], 2, 4, "w0:29500", nproc_per_node=8,
        extra_env={"DS_TPU_AUTOTUNED_CONFIG": "/a b/best.json"})
    argv = shlex.split(cmd)
    assert argv[0] == "DS_TPU_AUTOTUNED_CONFIG=/a b/best.json"
    assert argv[1:4] == [sys.executable, "-m",
                         "deepspeed_tpu_torch.launcher.launch"]
    flags = dict(zip(argv[4:14:2], argv[5:14:2]))
    assert flags == {"--nnodes": "4", "--node_rank": "2",
                     "--nproc_per_node": "8", "--master_addr": "w0",
                     "--master_port": "29500"}
    assert argv[14:] == ["train.py", "--lr", "0.1"]
    # the spawner accepts exactly these flags
    from deepspeed_tpu_torch.launcher import launch
    args = launch.parse_args(argv[4:])
    assert (args.nnodes, args.node_rank, args.nproc_per_node,
            args.master_addr, args.master_port, args.user_script,
            args.user_args) == (4, 2, 8, "w0", 29500, "train.py",
                                ["--lr", "0.1"])


@pytest.mark.parametrize("name,rank_expr", [("pdsh", "$PID"),
                                            ("openmpi",
                                             "$OMPI_COMM_WORLD_RANK"),
                                            ("slurm", "$SLURM_PROCID")])
def test_runner_cmd_construction(name, rank_expr):
    hosts = {"w0": 4, "w1": 4}
    node_cmds = [runner.build_node_command("t.py", [], r, 2, "w0:29500",
                                           nproc_per_node=4)
                 for r in range(2)]
    jnode = [jrunner.build_node_command("t.py", [], r, 2, "w0:29500")
             for r in range(2)]
    cmd = runner.RUNNERS[name](args=None).get_cmd(hosts, node_cmds)
    jcmd = jrunner.RUNNERS[name](args=None).get_cmd(hosts, jnode)
    # the launch around the node command is JAX's (pdsh's host-matching
    # wrapper included) ...
    assert cmd[:-1] == jcmd[:-1]
    mine = node_cmds[0].replace("--node_rank 0 ",
                                f"--node_rank {rank_expr} ")
    theirs = jnode[0].replace("DS_TPU_PROCESS_ID=0",
                              f"DS_TPU_PROCESS_ID={rank_expr}")
    assert cmd[-1].endswith(mine) and jcmd[-1].endswith(theirs)
    # ... and the node command is node 0's with its rank substituted
    assert cmd[-1][:-len(mine)] == jcmd[-1][:-len(theirs)]
    assert "--node_rank 0 " not in cmd[-1] and "t.py" in cmd[-1]
    with pytest.raises(ValueError, match="node 0"):
        runner.RUNNERS[name](args=None).get_cmd(hosts, node_cmds[1:])


def test_parse_args_remainder():
    argv = ["--launcher", "slurm", "--num_nodes", "2", "train.py",
            "--deepspeed_config", "c.json"]
    args, jargs = runner.parse_args(argv), jrunner.parse_args(argv)
    for k, v in vars(jargs).items():
        assert getattr(args, k) == v, k
    assert args.user_args == ["--deepspeed_config", "c.json"]
    assert args.num_gpus == -1


def test_multi_node_main_builds_per_slot_workers(hostfile, monkeypatch):
    launched = {}
    monkeypatch.setattr(runner.subprocess, "call",
                        lambda cmd: launched.update(cmd=cmd) or 0)
    monkeypatch.setattr(runner.PDSHRunner, "backend_exists", lambda s: True)
    assert runner.main(["-H", hostfile, "--exclude", "worker-2",
                        "--master_port", "29600", "train.py", "x"]) == 0
    cmd = launched["cmd"]
    assert cmd[:6] == ["pdsh", "-S", "-f", "1024", "-w", "worker-0,worker-1"]
    assert "--nnodes 2 --node_rank $PID --nproc_per_node 4 " \
           "--master_addr worker-0 --master_port 29600 train.py x" in cmd[-1]
    # uneven slots need --num_gpus
    with pytest.raises(ValueError, match="different slot counts"):
        runner.main(["-H", hostfile, "train.py"])
    assert runner.main(["-H", hostfile, "--num_gpus", "2", "train.py"]) == 0
    assert "--nnodes 3 --node_rank $PID --nproc_per_node 2 " in \
        launched["cmd"][-1]


def _tune(mod, tmp_path, monkeypatch):
    out = tmp_path / mod.__name__.split(".")[0]
    monkeypatch.setattr(mod.subprocess, "call", lambda cmd: 0)
    assert mod.main(["--autotuning", "tune", "--autotuning_exp_dir",
                     str(out), "train.py"]) == 0
    return (json.loads((out / "autotune_results.json").read_text()),
            json.loads((out / "best_config.json").read_text()))


def test_runner_autotuning_tune_writes_jax_report(tmp_path, monkeypatch):
    """``--autotuning tune`` replays a synthesized workload through the
    port's offline tuner: the report and the winning config are JAX's."""
    got = _tune(runner, tmp_path, monkeypatch)
    assert got == _tune(jrunner, tmp_path, monkeypatch)
    results, best = got
    assert results["improved_signals"] >= 1 and results["trials"] > 0
    assert best["autotuning"]["tuned"]


def test_autotuned_config_rides_node_command(monkeypatch, tmp_path):
    """Mode 'run' exports DS_TPU_AUTOTUNED_CONFIG IN the launched node
    command (remote shells don't inherit the launcher's environment)."""
    launched = {}
    monkeypatch.setattr(runner.subprocess, "call",
                        lambda cmd: launched.update(cmd=cmd) or 0)
    monkeypatch.delenv("DS_TPU_AUTOTUNED_CONFIG", raising=False)
    rc = runner.main(["--autotuning", "run", "--autotuning_exp_dir",
                      str(tmp_path), "--hostfile", str(tmp_path / "none"),
                      "--num_gpus", "1", "train.py"])
    assert rc == 0
    best = str(tmp_path / "best_config.json")
    assert f"DS_TPU_AUTOTUNED_CONFIG={best}" in " ".join(launched["cmd"])
    assert os.environ["DS_TPU_AUTOTUNED_CONFIG"] == best
    assert "deepspeed_tpu_torch.launcher.launch" in launched["cmd"][-1]


WORKER = """
import json, os, sys
import torch
torch.set_num_threads(1)
from deepspeed_tpu_torch.comm import comm
comm.init_distributed()
rank = comm.get_rank()
x = torch.tensor([float(rank + 1)])
comm.all_reduce(x)
env = {k: os.environ[k] for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                                  "MASTER_PORT", "LOCAL_RANK")}
json.dump({"sum": x.item(), "world": comm.get_world_size(),
           "backend": comm.get_backend(), "env": env},
          open(os.path.join(sys.argv[1], f"rank{rank}.json"), "w"))
comm.barrier()
"""


def test_single_node_main_launches_two_gloo_ranks(tmp_path, monkeypatch):
    for k in list(os.environ):
        if k.startswith(("DS_TPU_", "MASTER_", "RANK", "WORLD_SIZE",
                         "LOCAL_RANK")):
            monkeypatch.delenv(k)
    monkeypatch.setenv("PYTHONPATH", str(ROOT))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(WORKER)

    def call(cmd):
        # the hang guard: a group that never meets is killed with its
        # session and fails the test
        proc = subprocess.Popen(cmd, start_new_session=True)
        try:
            return proc.wait(timeout=HANG_GUARD_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)
            proc.wait()
            return -9

    monkeypatch.setattr(runner.subprocess, "call", call)
    rc = runner.main(["--hostfile", str(tmp_path / "none"), "--num_gpus",
                      "2", "--master_port", str(port), str(script),
                      str(tmp_path)])
    assert rc == 0
    for r in range(2):
        out = json.loads((tmp_path / f"rank{r}.json").read_text())
        assert out["sum"] == 3.0 and out["world"] == 2
        assert out["backend"] == "gloo"
        assert out["env"] == {"RANK": str(r), "WORLD_SIZE": "2",
                              "MASTER_ADDR": "localhost",
                              "MASTER_PORT": str(port),
                              "LOCAL_RANK": str(r)}
