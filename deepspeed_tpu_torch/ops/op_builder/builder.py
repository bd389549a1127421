"""Build and load the port's host (CPU) C++ ops.

Port of ``deepspeed_tpu/ops/op_builder/builder.py`` (``NativeOpBuilder``
:65): host-side C++ (the CPU optimizers of ZeRO-Offload and the async
file IO of the NVMe tier) compiled by ``g++`` into a shared library with
a plain C interface and loaded with ``ctypes``::

    g++ -O3 -std=c++17 -fPIC -shared -fopenmp -march=native -funroll-loops \
        -I csrc/host csrc/host/<src>.cpp -o build/host_ops/<key>/<name>.so

The sources are the port's own copies in ``csrc/host/``. ``<key>`` hashes
the sources, the header, the flags and the host CPU's feature flags
(``-march=native`` compiles for this CPU), so an edit or another machine
rebuilds and an unchanged tree on the same machine reuses the library.
The first ``load()`` builds: one builder at a time per library (a thread
lock and an ``flock`` on a file in the build directory, which the OS
drops if the holder dies), the output published by an atomic rename, so
a concurrent loader never sees a partial file. A failed build raises
with g++'s output. As in the JAX package, ``-march=native`` is dropped
when g++ refuses it; that is logged.
"""

import ctypes
import fcntl
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List

logger = logging.getLogger(__name__)

_PKG = Path(__file__).resolve().parents[2]
HOST_SRC = _PKG / "csrc" / "host"
BUILD_ROOT = _PKG.parent / "build" / "host_ops"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-fopenmp",
             "-march=native", "-funroll-loops"]

_build_lock = threading.Lock()


def _cpu_flags() -> str:
    """The first ``flags`` line of ``/proc/cpuinfo`` (empty where there
    is none)."""
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith("flags"):
                    return line
    except OSError:
        pass
    return ""


# wall seconds of each library's build in this process (absent: reused)
build_seconds: Dict[str, float] = {}


class NativeOpBuilder:
    """Compiles ``sources()`` from ``csrc/host`` into ``<NAME>.so`` and
    returns it as a ``ctypes.CDLL``."""

    NAME = "op"

    def sources(self) -> List[str]:
        raise NotImplementedError

    def extra_ldflags(self) -> List[str]:
        return []

    def _key(self) -> str:
        h = hashlib.sha256(" ".join(CXX_FLAGS + self.extra_ldflags())
                           .encode())
        h.update(_cpu_flags().encode())
        for name in sorted(self.sources()) + ["ds_host.h"]:
            h.update(name.encode())
            h.update((HOST_SRC / name).read_bytes())
        return h.hexdigest()[:16]

    def so_path(self) -> Path:
        return BUILD_ROOT / self._key() / f"{self.NAME}.so"

    def _compile(self, out: Path) -> None:
        srcs = [str(HOST_SRC / s) for s in self.sources()]
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        try:
            for flags in (CXX_FLAGS,
                          [f for f in CXX_FLAGS if f != "-march=native"]):
                cmd = (["g++", *flags, "-I", str(HOST_SRC), *srcs, "-o", tmp]
                       + self.extra_ldflags())
                proc = subprocess.run(cmd, capture_output=True, text=True)
                if proc.returncode == 0:
                    break
                if "-march=native" in flags:
                    logger.warning(
                        f"g++ refused -march=native for {self.NAME}; "
                        f"building without it:\n{proc.stderr}")
            else:
                raise RuntimeError(
                    f"g++ failed to build the host op {self.NAME} "
                    f"(exit {proc.returncode}): {' '.join(cmd)}\n"
                    f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def build(self) -> Path:
        out = self.so_path()
        if out.exists():
            return out
        with _build_lock:
            out.parent.mkdir(parents=True, exist_ok=True)
            with open(out.parent / f".{self.NAME}.lock", "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                if not out.exists():
                    t0 = time.perf_counter()
                    self._compile(out)
                    build_seconds[self.NAME] = time.perf_counter() - t0
        return out

    def load(self) -> ctypes.CDLL:
        return ctypes.CDLL(str(self.build()))
