"""Node-local process spawner.

Port of ``deepspeed_tpu/launcher/launch.py`` (``NodeLauncher`` :34,
``parse_args``, ``main``), the reference's ``launcher/launch.py`` (main
:132): spawn one worker process per local rank with the rendezvous
environment set, write a PID file, monitor the children, and on any
child failure kill the whole local group (the reference's
``sigkill_handler``, runner.py:573) so a hung ensemble never outlives its
first casualty.

    python -m deepspeed_tpu_torch.launcher.launch --nproc_per_node N \\
        script.py [script args]

Environment written for each worker (read by ``comm.init_distributed``):
  DS_TPU_COORDINATOR     host:port of global process 0
  DS_TPU_NUM_PROCESSES   global process count
  DS_TPU_PROCESS_ID      this worker's global process id
  LOCAL_RANK             this worker's local index on the node (its card)
and torch's own protocol, MASTER_ADDR / MASTER_PORT / RANK / WORLD_SIZE.
Across nodes, ``launcher/runner.py`` (PDSH, MPI, Slurm) runs this spawner
on every node with its ``--node_rank``.
"""

import argparse
import os
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional

from ..utils.logging import logger


class NodeLauncher:
    """Spawn + babysit the local worker group (reference launch.py:132)."""

    def __init__(self,
                 cmd: List[str],
                 nproc: int = 1,
                 base_process_id: int = 0,
                 num_processes: int = 1,
                 coordinator: str = "localhost:29500",
                 extra_env: Optional[Dict[str, Optional[str]]] = None,
                 pid_file: Optional[str] = None,
                 poll_interval: float = 0.2):
        self.cmd = cmd
        self.nproc = nproc
        self.base_process_id = base_process_id
        self.num_processes = num_processes
        if ":" not in coordinator:
            raise ValueError(
                f"coordinator must be 'host:port', got {coordinator!r}")
        self.coordinator = coordinator
        self.extra_env = extra_env or {}
        self.pid_file = pid_file
        self.poll_interval = poll_interval
        self.procs: List[subprocess.Popen] = []

    def _worker_env(self, local_rank: int) -> Dict[str, str]:
        env = dict(os.environ)
        # an extra_env value of None DELETES the inherited var (there is no
        # other way to un-inherit, since update() can only add/overwrite)
        for k, v in self.extra_env.items():
            if v is None:
                env.pop(k, None)
            else:
                env[k] = v
        rank = str(self.base_process_id + local_rank)
        host, port = self.coordinator.rsplit(":", 1)
        env.update({
            "DS_TPU_COORDINATOR": self.coordinator,
            "DS_TPU_NUM_PROCESSES": str(self.num_processes),
            "DS_TPU_PROCESS_ID": rank,
            "LOCAL_RANK": str(local_rank),
            "RANK": rank,
            "WORLD_SIZE": str(self.num_processes),
            "MASTER_ADDR": host,
            "MASTER_PORT": port,
        })
        return env

    def spawn(self):
        try:
            for lr in range(self.nproc):
                p = subprocess.Popen(self.cmd, env=self._worker_env(lr))
                self.procs.append(p)
        except Exception:
            # partial spawn must not leak the workers that did start
            self.kill_all()
            raise
        if self.pid_file:
            os.makedirs(os.path.dirname(self.pid_file) or ".", exist_ok=True)
            with open(self.pid_file, "w") as fh:
                fh.write("\n".join(str(p.pid) for p in self.procs) + "\n")
        logger.info(f"spawned {self.nproc} worker(s): "
                    f"pids={[p.pid for p in self.procs]}")
        return self

    def _install_signal_handlers(self):
        def handler(signum, _frame):
            logger.warning(f"received signal {signum}; killing worker group")
            self.kill_all(signum)
            sys.exit(128 + signum)

        for s in (signal.SIGINT, signal.SIGTERM):
            signal.signal(s, handler)

    def kill_all(self, signum=signal.SIGTERM):
        """The reference's sigkill_handler (runner.py:573): take the whole
        local group down together."""
        for p in self.procs:
            if p.poll() is None:
                try:
                    p.send_signal(signum)
                except ProcessLookupError:
                    pass
        deadline = time.time() + 5.0
        for p in self.procs:
            while p.poll() is None and time.time() < deadline:
                time.sleep(0.05)
            if p.poll() is None:
                # a worker that traps SIGTERM: escalate and reap so nothing
                # survives us
                try:
                    p.kill()
                except ProcessLookupError:
                    pass
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    logger.error(f"worker pid={p.pid} survived SIGKILL")

    def monitor(self) -> int:
        """Wait for the group; first nonzero exit kills the rest and becomes
        the group's exit code. Returns 0 only if every worker succeeded."""
        try:
            while True:
                alive = False
                for p in self.procs:
                    rc = p.poll()
                    if rc is None:
                        alive = True
                    elif rc != 0:
                        logger.error(
                            f"worker pid={p.pid} failed rc={rc}; "
                            f"killing local group")
                        self.kill_all()
                        return rc
                if not alive:
                    return 0
                time.sleep(self.poll_interval)
        finally:
            if self.pid_file and os.path.exists(self.pid_file):
                try:
                    os.remove(self.pid_file)
                except OSError:
                    pass

    def run(self) -> int:
        self._install_signal_handlers()
        self.spawn()
        return self.monitor()


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="deepspeed_tpu_torch.launcher.launch",
        description="deepspeed_tpu_torch node-local worker spawner "
                    "(reference launcher/launch.py)")
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="workers on this node, one a card")
    p.add_argument("--node_rank", type=int, default=0,
                   help="index of this node in the cluster")
    p.add_argument("--nnodes", type=int, default=1)
    p.add_argument("--master_addr", default="localhost")
    p.add_argument("--master_port", type=int, default=29500)
    p.add_argument("--pid_file", default=None,
                   help="file to record worker pids (reference launch.py "
                        "--save_pid)")
    p.add_argument("--module", action="store_true",
                   help="run user_script with python -m")
    p.add_argument("--no_python", action="store_true",
                   help="user_script is an executable, not a python file")
    p.add_argument("user_script")
    p.add_argument("user_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.module and args.no_python:
        raise ValueError("--module and --no_python are mutually exclusive")
    if args.no_python:
        cmd = [args.user_script]
    elif args.module:
        cmd = [sys.executable, "-m", args.user_script]
    else:
        cmd = [sys.executable, args.user_script]
    cmd += args.user_args
    launcher = NodeLauncher(
        cmd,
        nproc=args.nproc_per_node,
        base_process_id=args.node_rank * args.nproc_per_node,
        num_processes=args.nnodes * args.nproc_per_node,
        coordinator=f"{args.master_addr}:{args.master_port}",
        pid_file=args.pid_file)
    return launcher.run()


if __name__ == "__main__":
    sys.exit(main())
