"""The PyTorch port stands alone: it imports neither ``jax`` nor anything of
the JAX package ``deepspeed_tpu`` (only the parity tests import both).

``deepspeed_tpu_torch`` shares the ``deepspeed_tpu`` prefix, so module names
are matched exactly: ``deepspeed_tpu`` itself or ``deepspeed_tpu.<sub>``.
"""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

# the suite runs in several worker processes that share the CPUs: a
# small intra-op pool keeps torch from crowding out the other workers
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PORT_SOURCES = sorted(
    str(p.relative_to(ROOT))
    for p in (ROOT / "deepspeed_tpu_torch").rglob("*.py")) + [
    "chip_smoke.py"]

_JAX_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|jaxlib)(\.|\s|$)", re.M)
_JAX_PKG_IMPORT = re.compile(r"^\s*(import|from)\s+deepspeed_tpu(\.|\s|$)",
                             re.M)

_PROBE = """
import importlib, pkgutil, sys
import deepspeed_tpu_torch
for m in pkgutil.walk_packages(deepspeed_tpu_torch.__path__,
                               "deepspeed_tpu_torch."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n in ("jax", "jaxlib", "deepspeed_tpu")
             or n.startswith(("jax.", "jaxlib.", "deepspeed_tpu.")))
print(len([n for n in sys.modules if n.startswith("deepspeed_tpu_torch")]))
print(",".join(bad))
"""


def test_importing_every_port_module_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    n_modules, bad = int(lines[0]), lines[1] if len(lines) > 1 else ""
    assert n_modules >= 50           # every port module was imported
    assert bad == "", f"the port loaded {bad}"


@pytest.mark.parametrize("path", PORT_SOURCES)
def test_port_source_has_no_jax_import(path):
    text = (ROOT / path).read_text()
    assert not _JAX_IMPORT.search(text), f"{path} imports jax"
    assert not _JAX_PKG_IMPORT.search(text), \
        f"{path} imports the JAX package deepspeed_tpu"


def test_import_patterns_match_exact_names():
    assert _JAX_PKG_IMPORT.search("from deepspeed_tpu.models import x")
    assert _JAX_PKG_IMPORT.search("import deepspeed_tpu\n")
    assert not _JAX_PKG_IMPORT.search("import deepspeed_tpu_torch")
    assert not _JAX_PKG_IMPORT.search("from deepspeed_tpu_torch.x import y")
    assert _JAX_IMPORT.search("  import jax.numpy as jnp")
    assert not _JAX_IMPORT.search("import jaxtyping")


@pytest.mark.parametrize("path", PORT_SOURCES)
def test_port_source_reads_no_jax_package_file(path):
    """The port builds its host C++ from its own copies (csrc/host) and
    names no file under the JAX package's csrc."""
    assert "deepspeed_tpu/csrc" not in (ROOT / path).read_text(), path


def test_host_ops_build_from_the_port_sources():
    from deepspeed_tpu_torch.ops.op_builder import builder, cpu

    assert builder.HOST_SRC == ROOT / "deepspeed_tpu_torch" / "csrc" / "host"
    assert builder.BUILD_ROOT == ROOT / "build" / "host_ops"
    for op in cpu.ALL_OPS.values():
        for src in op().sources() + ["ds_host.h"]:
            assert (builder.HOST_SRC / src).is_file(), src


# the data-parallel slice's modules: each is among the sources checked
# above and among the modules the probe imports
DATA_PARALLEL_MODULES = [
    "accelerator/__init__.py", "accelerator/abstract_accelerator.py",
    "accelerator/real_accelerator.py", "accelerator/cuda_accelerator.py",
    "utils/timer.py", "utils/comms_logging.py", "comm/__init__.py",
    "comm/comm.py", "comm/quantized.py", "parallel/__init__.py",
    "parallel/topology.py", "runtime/zero/partition.py",
    "runtime/grad_overlap.py", "runtime/dataloader.py",
    "launcher/__init__.py", "launcher/launch.py"]


@pytest.mark.parametrize("path", DATA_PARALLEL_MODULES)
def test_data_parallel_module_is_checked(path):
    assert f"deepspeed_tpu_torch/{path}" in PORT_SOURCES
    # the JAX package has the module at the same path
    assert (ROOT / "deepspeed_tpu" / path).is_file() or \
        path == "accelerator/cuda_accelerator.py"
