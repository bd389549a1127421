"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source of the package is compiled by ``nvcc`` into a
shared library with a plain C interface, one library per source, and
loaded with ``ctypes``::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/torch_kernels/<key>/lib<name>.so <name>.cu

The first call builds all sources at once, one ``nvcc`` process per
source started together, into ``build/torch_kernels/<key>/`` beside the
package, where ``<key>`` hashes the sources and flags: an edit rebuilds,
an unchanged tree reuses the libraries. A failed build raises with
nvcc's stderr. Each C entry point returns its ``cudaGetLastError()``;
:func:`check` turns a non-zero code into an exception.

Wrappers pass every pointer and the stream as ``ctypes.c_void_p`` (the
argtypes below), so 64-bit addresses are never cut to 32 bits.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "torch_kernels"
DEFAULT_CUDA_HOME = "/usr/local/cuda"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_int64
# C signature of every entry point, by library name
SIGNATURES = {
    "paged_attention": {
        # q, k, v, tables, lengths, out, ws_ml, ws_acc, tickets, n, nh,
        # kvh, hd, bs, mb, chunk_pages, n_split, dtype, scale, stream
        "ds_paged_decode_attention":
            [_P] * 9 + [_I] * 9 + [_F, _P],
        # q, k, v, k_scale, v_scale, tables, lengths, out, ws_ml, ws_acc,
        # tickets, n, nh, kvh, hd, bs, mb, chunk_pages, n_split, dtype,
        # scale, stream
        "ds_paged_decode_attention_q8":
            [_P] * 11 + [_I] * 9 + [_F, _P],
        # q, k, v, k_scale, v_scale, tables, lengths, row_ids, out, ws_ml,
        # ws_acc, tickets, rank, scan, ws_ml_f, ws_acc_f, tickets_f, n, nh,
        # kvh, hd, bs, mb, chunk_pages, n_split, fine_rows,
        # fine_chunk_pages, fine_n_split, blocks, dtype, scale, stream
        "ds_paged_decode_rows": [_P] * 17 + [_I] * 13 + [_F, _P],
        # nh, kvh, hd, bs, dtype, q8, rows, out (int[6])
        "ds_paged_decode_info": [_I] * 7 + [_P],
    },
    "ragged_attention": {
        # q, k, v, row_ids, lengths, tables, out, n, nh, kvh, hd, bs, mb,
        # dtype, scale, stream
        "ds_ragged_paged_attention":
            [_P] * 7 + [_I] * 7 + [_F, _P],
        # q, k, v, k_scale, v_scale, row_ids, lengths, tables, out, n, nh,
        # kvh, hd, bs, mb, dtype, scale, stream
        "ds_ragged_paged_attention_q8":
            [_P] * 9 + [_I] * 7 + [_F, _P],
        # q, k, v, k_scale, v_scale, row_ids, lengths, tables, out, rank,
        # scan, n, nh, kvh, hd, bs, mb, nb, dtype, scale, stream
        "ds_ragged_tiles": [_P] * 11 + [_I] * 8 + [_F, _P],
        # dtype, hd, q8, out (int[4])
        "ds_ragged_tiles_info": [_I] * 3 + [_P],
    },
    "dense_decode_attention": {
        # q, k, v, lengths, out, ws_ml, ws_acc, tickets, b, nh, kvh, hd, m,
        # chunk, n_split, dtype, scale, stream
        "ds_dense_decode_attention": [_P] * 8 + [_I] * 8 + [_F, _P],
    },
    "flash_attention": {
        # q, k, v, o, lse, bh, bhk, sq, skv, d, dtype, scale, causal, stream
        "ds_flash_fwd": [_P] * 5 + [_I] * 6 + [_F, _I, _P],
        # q, k, v, do, lse, delta, dq, bh, bhk, sq, skv, d, dtype, scale,
        # causal, stream
        "ds_flash_bwd_dq": [_P] * 7 + [_I] * 6 + [_F, _I, _P],
        # q, k, v, do, lse, delta, dk, dv, bh, bhk, sq, skv, d, dtype,
        # scale, causal, stream
        "ds_flash_bwd_dkv": [_P] * 8 + [_I] * 6 + [_F, _I, _P],
        # d, dtype, out (int[9])
        "ds_flash_hopper_info": [_I, _I, _P],
    },
    "sparse_attention": {
        # q, k, v, kv_idx, kv_valid, o, lse, bh, nheads, s, d, block, jmax,
        # dtype, scale, causal, stream
        "ds_sparse_fwd": [_P] * 7 + [_I] * 7 + [_F, _I, _P],
        # q, k, v, do, lse, delta, kv_idx, kv_valid, dq, bh, nheads, s, d,
        # block, jmax, dtype, scale, causal, stream
        "ds_sparse_bwd_dq": [_P] * 9 + [_I] * 7 + [_F, _I, _P],
        # q, k, v, do, lse, delta, q_idx, q_valid, dk, dv, bh, nheads, s, d,
        # block, imax, dtype, scale, causal, stream
        "ds_sparse_bwd_dkv": [_P] * 10 + [_I] * 7 + [_F, _I, _P],
        # q, k, v, items, steps, o, lse, bh, nheads, s, d, n_items,
        # max_steps, dtype, scale, causal, stream
        "ds_sparse_fwd_hopper": [_P] * 7 + [_I] * 7 + [_F, _I, _P],
        # q, k, v, do, lse, delta, items, steps, dq, bh, nheads, s, d,
        # n_items, max_steps, dtype, scale, causal, stream
        "ds_sparse_bwd_dq_hopper": [_P] * 9 + [_I] * 7 + [_F, _I, _P],
        # q, k, v, do, lse, delta, items, steps, dk, dv, bh, nheads, s, d,
        # n_items, max_steps, dtype, scale, causal, stream
        "ds_sparse_bwd_dkv_hopper": [_P] * 10 + [_I] * 7 + [_F, _I, _P],
        # d, dtype, max_steps, out (int[9])
        "ds_sparse_hopper_info": [_I, _I, _I, _P],
    },
    "quantizer": {
        # x, q, s, n, nb, block, dtype, bits, stream
        "ds_quantize_blocks": [_P] * 3 + [_L] + [_I] * 4 + [_P],
        # q, s, out, n, nb, block, dtype, stream
        "ds_dequantize_blocks": [_P] * 3 + [_L] + [_I] * 3 + [_P],
    },
    "rms_norm": {
        # x, w, out, rows, h, x_dtype, w_dtype, eps, stream
        "ds_rms_norm": [_P] * 3 + [_I] * 4 + [_F, _P],
    },
}

_libs: Dict[str, ctypes.CDLL] = {}
# wall seconds of the last build (0.0 when the libraries were reused)
build_seconds = 0.0
# ptxas resource report (registers, shared memory, spills) per source
build_logs: Dict[str, str] = {}


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), DEFAULT_CUDA_HOME):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the port's CUDA kernels are built from "
            "deepspeed_tpu_torch/csrc at first use")
    return found


def build() -> Path:
    """Compile every ``csrc/*.cu`` (in parallel) unless this source key is
    already built; returns the build directory."""
    global build_seconds
    out_dir = BUILD_ROOT / _key()
    srcs = sources()
    if all((out_dir / f"lib{s.stem}.so").exists() for s in srcs):
        return out_dir
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in srcs:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for src, tmp, proc in procs:
        out, err = proc.communicate()
        build_logs[src.stem] = out + err
        if proc.returncode != 0:
            failed.append(f"{src.name} (exit {proc.returncode}):\n{err}")
            os.unlink(tmp)
        else:
            # atomic publish: concurrent builders never see a partial file
            os.replace(tmp, out_dir / f"lib{src.stem}.so")
    build_seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed to build the port's kernels:\n"
                           + "\n".join(failed))
    return out_dir


def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, with argtypes set."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build() / f"lib{name}.so"))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
    return lib


def check(code: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")
