"""Cluster launcher: hostfile parsing + multi-node command construction.

Port of ``deepspeed_tpu/launcher/runner.py`` (the reference's
launcher/runner.py:389 main and multinode_runner.py's PDSH / OpenMPI /
Slurm runners). The hostfile, the ``--include`` / ``--exclude`` filters,
the runners and ``--autotuning`` are the JAX package's. One design
change: the JAX package runs ONE process per host (jax owns every local
chip), while PyTorch runs one process per GPU. So the command a node runs
is the port's own node-local spawner,

    python -m deepspeed_tpu_torch.launcher.launch --nnodes N \\
        --node_rank R --nproc_per_node S --master_addr A --master_port P \\
        script.py [script args]

which starts ``S`` workers (the hostfile's ``slots``) with torch's
rendezvous environment (``RANK = R * S + local rank``, ``WORLD_SIZE = N *
S``, ``MASTER_ADDR`` / ``MASTER_PORT``) and the ``DS_TPU_*`` variables
``comm.init_distributed`` reads. Each runner substitutes the node rank
where the JAX package substitutes ``DS_TPU_PROCESS_ID``: the host's
position in the host list (pdsh), ``$OMPI_COMM_WORLD_RANK`` (mpirun),
``$SLURM_PROCID`` (srun).

    python -m deepspeed_tpu_torch.launcher.runner -H hostfile \\
        [--launcher pdsh|openmpi|slurm] script.py [script args]

Without a hostfile (and without ``--force_multi``) the runner starts one
node of ``--num_gpus`` workers on this host (default: every visible GPU,
1 without one).
"""

import argparse
import os
import shlex
import subprocess
import sys
from collections import OrderedDict
from typing import Dict, List, Optional

from ..utils.logging import logger

DEFAULT_COORD_PORT = 29500


def parse_hostfile(path: str) -> "OrderedDict[str, int]":
    """'hostname slots=N' lines -> {host: slots} (reference runner.py:201
    fetch_hostfile)."""
    hosts: "OrderedDict[str, int]" = OrderedDict()
    with open(path) as fh:
        for line in fh:
            line = line.split("#")[0].strip()
            if not line:
                continue
            parts = line.split()
            host = parts[0]
            slots = 1
            for p in parts[1:]:
                if p.startswith("slots="):
                    slots = int(p.split("=")[1])
            if host in hosts:
                raise ValueError(f"duplicate host {host} in hostfile")
            hosts[host] = slots
    if not hosts:
        raise ValueError(f"hostfile {path} is empty")
    return hosts


def parse_inclusion_exclusion(hosts: Dict[str, int], include: str = "",
                              exclude: str = "") -> "OrderedDict[str, int]":
    """'--include host1@host2' / '--exclude host3' filters (reference
    runner.py:256 parse_resource_filter; hosts are atomic, as in the JAX
    package: an included host runs one worker per slot)."""
    sel = OrderedDict(hosts)
    if include:
        wanted = include.split("@")
        unknown = [h for h in wanted if h not in sel]
        if unknown:
            raise ValueError(f"--include names unknown hosts {unknown}")
        sel = OrderedDict((h, sel[h]) for h in wanted)
    if exclude:
        for h in exclude.split("@"):
            if h not in sel:
                raise ValueError(f"--exclude names unknown host {h}")
            del sel[h]
    if not sel:
        raise ValueError("resource filters removed every host")
    return sel


def build_node_command(script: str, script_args: List[str], node_rank: int,
                       num_nodes: int, coordinator: str,
                       nproc_per_node: int = 1,
                       extra_env: Optional[Dict[str, str]] = None) -> str:
    """The shell command node ``node_rank`` of ``num_nodes`` runs: the
    node-local spawner (``launcher/launch.py``) for its ``nproc_per_node``
    workers, rendezvous at ``coordinator`` (host:port), with
    ``extra_env`` exported in front (a remote shell does not inherit this
    launcher's environment)."""
    host, port = coordinator.rsplit(":", 1)
    exports = " ".join(f"{k}={shlex.quote(v)}"
                       for k, v in (extra_env or {}).items())
    launch = [sys.executable, "-m", "deepspeed_tpu_torch.launcher.launch",
              "--nnodes", str(num_nodes), "--node_rank", str(node_rank),
              "--nproc_per_node", str(nproc_per_node),
              "--master_addr", host, "--master_port", port, script,
              *script_args]
    return f"{exports} {' '.join(shlex.quote(a) for a in launch)}".strip()


def _with_node_rank(node_cmd: str, rank_expr: str) -> str:
    """Node 0's command with its node rank replaced by a shell expression
    each node evaluates for itself."""
    fixed = "--node_rank 0 "
    if fixed not in node_cmd:
        raise ValueError(f"not node 0's command: {node_cmd!r}")
    return node_cmd.replace(fixed, f"--node_rank {rank_expr} ", 1)


class MultiNodeRunner:
    """Base: turns (hosts, node commands) into a cluster launch command
    (reference multinode_runner.py:25)."""

    name = "base"

    def __init__(self, args):
        self.args = args

    def backend_exists(self) -> bool:
        from shutil import which

        return which(self._binary()) is not None

    def _binary(self) -> str:
        raise NotImplementedError

    def get_cmd(self, hosts: Dict[str, int], node_cmds: List[str]) -> List[str]:
        raise NotImplementedError


class PDSHRunner(MultiNodeRunner):
    """reference multinode_runner.py:51 — the same command on every host;
    each host finds its node rank as its position in the host list,
    matched against its short and fully qualified names."""

    name = "pdsh"

    def _binary(self):
        return "pdsh"

    def get_cmd(self, hosts, node_cmds):
        hostlist = ",".join(hosts)
        # no match at all fails loudly instead of handing out an
        # out-of-range rank
        wrapper = (
            "HOSTS=\"" + " ".join(hosts) + "\"; PID=0; FOUND=0; "
            "for h in $HOSTS; do "
            "if [ \"$h\" = \"$(hostname)\" ] || [ \"$h\" = \"$(hostname -s)\" ]"
            " || [ \"$h\" = \"$(hostname -f 2>/dev/null)\" ]; then FOUND=1; break; fi; "
            "PID=$((PID+1)); done; "
            "if [ \"$FOUND\" != 1 ]; then "
            "echo \"deepspeed-tpu: $(hostname) not in hostfile ($HOSTS)\" >&2; exit 1; fi; "
            + _with_node_rank(node_cmds[0], "$PID"))
        return ["pdsh", "-S", "-f", "1024", "-w", hostlist, wrapper]


class OpenMPIRunner(MultiNodeRunner):
    """reference multinode_runner.py:109 — mpirun starts one spawner a
    node and provides its rank."""

    name = "openmpi"

    def _binary(self):
        return "mpirun"

    def get_cmd(self, hosts, node_cmds):
        hostlist = ",".join(f"{h}:1" for h in hosts)
        base = _with_node_rank(node_cmds[0], "$OMPI_COMM_WORLD_RANK")
        return ["mpirun", "-np", str(len(hosts)), "--host", hostlist,
                "--map-by", "ppr:1:node", "bash", "-c", base]


class SlurmRunner(MultiNodeRunner):
    """reference multinode_runner.py:318 — srun starts one spawner a node
    and provides its rank."""

    name = "slurm"

    def _binary(self):
        return "srun"

    def get_cmd(self, hosts, node_cmds):
        base = _with_node_rank(node_cmds[0], "$SLURM_PROCID")
        return ["srun", "--nodes", str(len(hosts)), "--ntasks-per-node", "1",
                "bash", "-c", base]


RUNNERS = {r.name: r for r in (PDSHRunner, OpenMPIRunner, SlurmRunner)}


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="deepspeed_tpu_torch.launcher.runner",
        description="deepspeed_tpu_torch cluster launcher (reference "
                    "bin/deepspeed)")
    p.add_argument("-H", "--hostfile", default="/job/hostfile")
    p.add_argument("-i", "--include", default="")
    p.add_argument("-e", "--exclude", default="")
    p.add_argument("--num_nodes", type=int, default=-1)
    p.add_argument("--num_gpus", type=int, default=-1,
                   help="workers a node (default: the hostfile's slots; "
                        "without a hostfile every visible GPU, 1 without "
                        "one)")
    p.add_argument("--master_addr", default=None,
                   help="rendezvous host (default: first host)")
    p.add_argument("--master_port", type=int, default=DEFAULT_COORD_PORT)
    p.add_argument("--launcher", default="pdsh", choices=sorted(RUNNERS))
    p.add_argument("--force_multi", action="store_true")
    # reference bin/deepspeed --autotuning {tune,run}: tune knobs
    # before/instead of the real run. Here tuning is the device-free
    # offline replay (autotuning/offline.py) — no launched experiments
    p.add_argument("--autotuning", choices=("tune", "run"), default=None)
    p.add_argument("--autotuning_config", default=None,
                   help="JSON file with the base engine config for autotuning")
    p.add_argument("--autotuning_exp_dir", default="autotuning_exps")
    p.add_argument("--autotuning_workload", default=None,
                   help="workload artifact (autotuning.capture) to "
                        "replay; default = a synthesized load_bench mix")
    p.add_argument("user_script")
    p.add_argument("user_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def run_autotuning(args):
    """reference launcher/runner.py:360 semantics, offline machinery:
    replay a workload artifact through the device-free tuner
    (autotuning/offline.py) and write the ranked report + the winning
    config. Returns 0/1 in mode 'tune'; in mode 'run' returns the
    winning-config path so main() proceeds to launch the real run with
    it."""
    import json

    from .. import autotuning

    base = {"optimizer": {"type": "adamw", "params": {"lr": 1e-4}},
            "steps_per_print": 10 ** 9}
    if args.autotuning_config:
        with open(args.autotuning_config) as fh:
            base = json.load(fh)
    if args.autotuning_workload:
        artifact = autotuning.load(args.autotuning_workload)
    else:
        artifact = autotuning.synthesize()
    tuner = autotuning.OfflineTuner(artifact, base_config=base)
    result = tuner.tune()
    if result["improved_signals"] < 1:
        logger.error("autotuning: no registered cost signal improved over "
                     "defaults on this workload")
        return 1
    os.makedirs(args.autotuning_exp_dir, exist_ok=True)
    with open(os.path.join(args.autotuning_exp_dir,
                           "autotune_results.json"), "w") as fh:
        json.dump({"report": result["report"],
                   "improved_signals": result["improved_signals"],
                   "trials": result["trials"]}, fh, indent=2)
    # absolute: the path is exported into remote node commands, whose shells
    # start in $HOME, not this launcher's cwd
    best_path = os.path.abspath(
        os.path.join(args.autotuning_exp_dir, "best_config.json"))
    with open(best_path, "w") as fh:
        json.dump(result["config"], fh, indent=2)
    top = result["report"][0] if result["report"] else {}
    logger.info(f"autotuning: {result['improved_signals']} cost signal(s) "
                f"improved over {result['trials']} trials (best: "
                f"{top.get('knob')} -> {top.get('tuned')}) — report in "
                f"{args.autotuning_exp_dir}/autotune_results.json, winning "
                f"config in {best_path}")
    if args.autotuning == "run":
        return best_path   # caller launches the real run with this config
    return 0


def _local_gpus() -> int:
    import torch

    return max(torch.cuda.device_count(), 1)


def main(argv=None):
    args = parse_args(argv)
    extra_env: Dict[str, str] = {}
    if args.autotuning:
        out = run_autotuning(args)
        if not isinstance(out, str):
            return out
        # mode 'run' (reference bin/deepspeed semantics): tune, then launch
        # the real training with the winning config exported for the user
        # script / engine to pick up. The var rides the per-node command
        # (pdsh/mpirun/srun shells do NOT inherit this launcher's environ);
        # best_config.json lives on this host, so multi-node runs need it
        # on a shared filesystem, like the reference's rewritten configs
        os.environ["DS_TPU_AUTOTUNED_CONFIG"] = out
        extra_env["DS_TPU_AUTOTUNED_CONFIG"] = out
        logger.info("autotuning done; launching user script with "
                    f"DS_TPU_AUTOTUNED_CONFIG={out}")
    multi_node = args.force_multi or os.path.exists(args.hostfile)
    if not multi_node:
        # one node: this host, one worker a GPU
        nproc = args.num_gpus if args.num_gpus > 0 else _local_gpus()
        cmd = build_node_command(args.user_script, args.user_args, 0, 1,
                                 f"localhost:{args.master_port}",
                                 nproc_per_node=nproc, extra_env=extra_env)
        logger.info(f"single-node launch: {cmd}")
        return subprocess.call(["bash", "-c", cmd])

    hosts = parse_hostfile(args.hostfile)
    hosts = parse_inclusion_exclusion(hosts, args.include, args.exclude)
    if args.num_nodes > 0:
        hosts = OrderedDict(list(hosts.items())[:args.num_nodes])
    if args.num_gpus > 0:
        hosts = OrderedDict((h, args.num_gpus) for h in hosts)
    slots = set(hosts.values())
    if len(slots) != 1:
        # a worker's rank is node_rank * nproc_per_node + its local rank
        raise ValueError(
            f"hosts have different slot counts {dict(hosts)}: every node "
            f"runs the same number of workers (set --num_gpus)")
    nproc = slots.pop()
    coordinator = (args.master_addr or next(iter(hosts))) + \
        f":{args.master_port}"
    node_cmds = [build_node_command(args.user_script, args.user_args, rank,
                                    len(hosts), coordinator,
                                    nproc_per_node=nproc,
                                    extra_env=extra_env)
                 for rank in range(len(hosts))]
    runner = RUNNERS[args.launcher](args)
    if not runner.backend_exists():
        raise RuntimeError(f"launcher backend '{args.launcher}' not installed")
    cmd = runner.get_cmd(hosts, node_cmds)
    logger.info(f"multi-node launch over {len(hosts)} hosts: {cmd}")
    return subprocess.call(cmd)


if __name__ == "__main__":
    sys.exit(main())
