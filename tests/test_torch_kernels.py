"""PyTorch port: attention kernels against the JAX package's kernels.

The port's paged and ragged attention keep a plain PyTorch version beside
each hand-written CUDA kernel. Here, on the CPU, the plain versions are
held against the JAX Pallas kernels (run in interpret mode, as the JAX
package's own tests run them) on the same numpy inputs, in fp32, with the
JAX tests' tolerance (rtol = atol = 2e-5, test_ragged_attention.py). The
CUDA kernels themselves are held against the plain versions on the card
by chip_smoke.py.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deepspeed_tpu.inference.v2.kernels.paged_attention import \
    paged_attention as jax_paged_attention
from deepspeed_tpu.inference.v2.kernels.ragged_attention import \
    ragged_attention as jax_ragged_attention
from deepspeed_tpu_torch.inference.v2.kernels import \
    paged_attention as paged_mod
from deepspeed_tpu_torch.inference.v2.kernels.paged_attention import (
    check_kernel_args, paged_attention, paged_attention_plain)
from deepspeed_tpu_torch.inference.v2.kernels.ragged_attention import (
    ragged_attention, ragged_attention_plain)
from deepspeed_tpu_torch.ops.op_builder import cuda as cuda_build

# the suite runs in several worker processes that share the CPUs: a
# small intra-op pool keeps torch from crowding out the other workers
torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)


def _pool(rng, nb=12, bs=16, kvh=2, hd=16):
    k = rng.normal(size=(nb, bs, kvh, hd)).astype(np.float32)
    v = rng.normal(size=(nb, bs, kvh, hd)).astype(np.float32)
    return k, v


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _mixed_ragged(rng, nh=4, hd=16, T=32):
    """3 rows: a 10-token prefill chunk (positions 0..9), a 5-token
    continuation (positions 20..24) and a decode row at position 40;
    padding to T tokens points at row 0 with length 0."""
    tables = np.array([[1, 2, 0], [3, 4, 0], [5, 6, 7]], np.int32)
    row_ids, lengths = [], []
    for r, positions in enumerate([range(10), range(20, 25), [40]]):
        for p in positions:
            row_ids.append(r)
            lengths.append(p + 1)
    n = len(row_ids)
    row_ids = np.array(row_ids + [0] * (T - n), np.int32)
    lengths = np.array(lengths + [0] * (T - n), np.int32)
    q = rng.normal(size=(T, nh, hd)).astype(np.float32)
    return q, row_ids, lengths, tables, n


@pytest.mark.parametrize("nh", [2, 4])       # MHA and GQA (group 2)
def test_paged_plain_matches_jax_kernel(nh):
    rng = np.random.default_rng(0)
    k, v = _pool(rng)
    tables = np.array([[1, 2, 3], [4, 5, 0], [6, 0, 0], [7, 8, 9],
                       [0, 0, 0]], np.int32)
    lengths = np.array([40, 17, 1, 48, 0], np.int32)   # last row: padding
    q = rng.normal(size=(5, nh, 16)).astype(np.float32)
    ref = np.asarray(jax_paged_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
        jnp.asarray(lengths)))
    out = paged_attention_plain(*_t(q, k, v, tables, lengths)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    assert (out[-1] == 0.0).all()


def test_ragged_plain_matches_jax_kernel_mixed_rows():
    rng = np.random.default_rng(1)
    k, v = _pool(rng)
    q, row_ids, lengths, tables, n = _mixed_ragged(rng)
    ref = np.asarray(jax_ragged_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(row_ids), jnp.asarray(lengths), jnp.asarray(tables)))
    out = ragged_attention_plain(
        *_t(q, k, v, row_ids, lengths, tables)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    # padding tokens attend over nothing and output exact zeros
    assert (out[n:] == 0.0).all()


def test_ragged_plain_pure_decode_equals_paged_plain():
    rng = np.random.default_rng(2)
    k, v = _pool(rng)
    tables = np.array([[1, 2, 0], [3, 4, 5], [6, 0, 0], [7, 8, 9]],
                      np.int32)
    lengths = np.array([17, 33, 5, 48], np.int32)
    q = rng.normal(size=(4, 4, 16)).astype(np.float32)
    qt, kt, vt, tt, lt = _t(q, k, v, tables, lengths)
    ragged = ragged_attention_plain(qt, kt, vt,
                                    torch.arange(4, dtype=torch.int32), lt,
                                    tt)
    decode = paged_attention_plain(qt, kt, vt, tt, lt)
    assert torch.equal(ragged, decode)


def test_wrappers_take_the_plain_version_on_cpu_without_counting():
    rng = np.random.default_rng(3)
    k, v = _pool(rng)
    q, row_ids, lengths, tables, _ = _mixed_ragged(rng)
    args = _t(q, k, v, row_ids, lengths, tables)
    before = (paged_attention.launches, ragged_attention.launches)
    assert torch.equal(ragged_attention(*args), ragged_attention_plain(*args))
    dq = args[0][:3]
    dargs = (dq, args[1], args[2], args[5], torch.tensor([11, 25, 41],
                                                         dtype=torch.int32))
    assert torch.equal(paged_attention(*dargs), paged_attention_plain(*dargs))
    # the counters count kernel launches only
    assert (paged_attention.launches, ragged_attention.launches) == before


def test_plain_versions_keep_bf16_io():
    rng = np.random.default_rng(4)
    k, v = _pool(rng)
    q, row_ids, lengths, tables, n = _mixed_ragged(rng)
    qt, kt, vt, rt, lt, tt = _t(q, k, v, row_ids, lengths, tables)
    bf = [x.to(torch.bfloat16) for x in (qt, kt, vt)]
    out = ragged_attention_plain(*bf, rt, lt, tt)
    assert out.dtype == torch.bfloat16
    ref = ragged_attention_plain(*[x.float() for x in bf], rt, lt, tt)
    # one bf16 rounding of outputs of magnitude <= ~3
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(),
                               rtol=0, atol=2e-2)


@pytest.mark.parametrize("fn", [paged_attention, ragged_attention])
def test_wrappers_reject_other_devices(fn):
    q = torch.empty((2, 4, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fn(q, q, q, q, q, q) if fn is ragged_attention else fn(q, q, q, q, q)


@pytest.mark.parametrize("case", ["dtype", "int64", "strided", "shape",
                                  "row_bytes"])
def test_kernel_argument_checks(case):
    """What the CUDA kernels take is checked before launch (these rules are
    device-independent, so they are exercised on CPU tensors)."""
    q = torch.zeros((3, 4, 16), dtype=torch.bfloat16)
    k = torch.zeros((5, 16, 2, 16), dtype=torch.bfloat16)
    tables = torch.zeros((3, 2), dtype=torch.int32)
    lens = torch.ones(3, dtype=torch.int32)
    check_kernel_args("t", q, k, k.clone(), [lens], tables)   # accepted
    if case == "dtype":
        args, exc = (q, k.float(), k.float(), [lens], tables), TypeError
    elif case == "int64":
        args, exc = (q, k, k, [lens.long()], tables), TypeError
    elif case == "strided":
        args, exc = (q.transpose(0, 1), k, k, [lens], tables), ValueError
    elif case == "shape":
        args, exc = (q, k[..., :8], k[..., :8], [lens], tables), ValueError
    else:  # 3 bf16 = 6-byte rows cannot take 16-byte loads
        q3 = torch.zeros((3, 4, 3), dtype=torch.bfloat16)
        k3 = torch.zeros((5, 16, 2, 3), dtype=torch.bfloat16)
        args, exc = (q3, k3, k3, [lens], tables), ValueError
    with pytest.raises(exc):
        check_kernel_args("t", *args)


def test_plain_chunking_matches_one_pass(monkeypatch):
    """The plain versions bound their gather by chunking rows; the result
    does not depend on the chunk size."""
    rng = np.random.default_rng(5)
    k, v = _pool(rng)
    q, row_ids, lengths, tables, _ = _mixed_ragged(rng)
    args = _t(q, k, v, row_ids, lengths, tables)
    whole = ragged_attention_plain(*args)
    monkeypatch.setattr(paged_mod, "_PLAIN_CHUNK_BYTES", 1)
    np.testing.assert_allclose(ragged_attention_plain(*args).numpy(),
                               whole.numpy(), rtol=1e-6, atol=1e-6)


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """No nvcc: the build raises with what it looked for; nothing falls
    back."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(cuda_build, "DEFAULT_CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(cuda_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build()


def test_kernel_sources_and_build_key():
    names = [p.stem for p in cuda_build.sources()]
    assert names == sorted(cuda_build.SIGNATURES)
    key = cuda_build._key()
    assert len(key) == 16 and key == cuda_build._key()
    assert "arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS
