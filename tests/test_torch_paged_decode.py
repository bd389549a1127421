"""PyTorch port: the split-K plan and arithmetic of the paged decode kernel.

``csrc/paged_attention.cu`` cuts each (sequence, kv head)'s block table
into chunks of whole pages (``page_split_plan``), one block per chunk, and
combines the chunks' partial softmax states in chunk order. Held here on
the CPU, on a pool of 16 pages of 16 slots (hd 16, nh 4, kvh 2):

* ``page_split_plan``: the chunks cover ``[0, MB)`` in whole pages, give
  more than 132 blocks at N 8, kvh 8, MB 32, bs 64 (the chip shape), and a
  table of one page is one chunk;
* ``paged_decode_split_plain`` (the split-and-combine arithmetic in torch
  ops) against the JAX ``paged_attention`` kernel, which on the CPU runs
  its BlockSpec variant in interpret mode, at lengths 0, 1, bs - 1, bs,
  bs + 1, a chunk boundary +- 1, the table width and one past it, on
  null-padded tables whose width the chunk does not divide: an f32 pool
  at 2e-5 (the JAX tests' tolerance) and an int8 pool with scales, q in
  f32 (2e-5) and in bf16 (2e-2: one bf16 rounding of the dequantized
  pages and of the outputs, as in test_torch_kv_quant.py);
* the split plain version against ``paged_attention_plain`` in bf16;
* the kernel's workspace: made once per device, its tickets zero, reused
  while it is large enough.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deepspeed_tpu.inference.v2.kernels.paged_attention import \
    paged_attention as jax_paged_attention

from deepspeed_tpu_torch.inference.v2.kernels import paged_attention as pa

# the suite runs in several worker processes that share the CPUs: a
# small intra-op pool keeps torch from crowding out the other workers
torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)
NB, BS, NH, KVH, HD = 16, 16, 4, 2, 16


@pytest.mark.parametrize("N,kvh,MB,bs", [
    (8, 8, 32, 64), (8, 8, 9, 64), (1, 1, 1, 16), (2, 2, 5, 16),
    (64, 8, 32, 64), (1, 8, 2000, 16), (4, 2, 7, 16), (3, 8, 100, 128)])
def test_page_split_plan_covers_table_in_pages(N, kvh, MB, bs):
    chunk_pages, n_split = pa.page_split_plan(N, kvh, MB, bs)
    assert isinstance(chunk_pages, int) and chunk_pages >= 1
    # whole 64-slot tiles a chunk when pages are smaller than a tile
    assert (chunk_pages * bs) % min(bs, pa.TILE) == 0
    # the chunks [s * chunk, (s + 1) * chunk) cover [0, MB), none is empty
    assert n_split * chunk_pages >= MB
    assert (n_split - 1) * chunk_pages < MB


def test_page_split_plan_fills_the_card_at_the_chip_shape():
    chunk_pages, n_split = pa.page_split_plan(8, 8, 32, 64)
    assert 8 * 8 * n_split > 132
    assert (chunk_pages, n_split) == (3, 11)
    # a table of one page is one chunk, whatever the page size
    for bs in (16, 64, 256):
        assert pa.page_split_plan(8, 8, 1, bs)[1] == 1
    # a large batch needs no split
    assert pa.page_split_plan(128, 8, 32, 64) == (32, 1)


def _pool(rng, quant):
    if quant:
        kv = [rng.integers(-127, 128, size=(NB, BS, KVH, HD)).astype(np.int8)
              for _ in range(2)]
        scales = [rng.uniform(0.01, 0.2, size=(NB, KVH)).astype(np.float32)
                  for _ in range(2)]
        return kv + scales
    return [rng.normal(size=(NB, BS, KVH, HD)).astype(np.float32)
            for _ in range(2)]


def _rows(rng, MB, chunk_pages):
    """Lengths at every edge of a page and of a chunk, the table width and
    one past it; each row's used pages drawn from 1..NB-1, the rest of its
    table the null page 0."""
    chunk = chunk_pages * BS
    lengths = np.array([0, 1, BS - 1, BS, BS + 1, chunk - 1, chunk + 1,
                        MB * BS, MB * BS + 1], np.int32)
    tables = np.zeros((len(lengths), MB), np.int32)
    for r, n in enumerate(lengths):
        used = min(-(-int(n) // BS), MB)
        tables[r, :used] = rng.integers(1, NB, size=used)
    q = rng.normal(size=(len(lengths), NH, HD)).astype(np.float32)
    return q, tables, lengths


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("MB,chunk_pages", [(5, 2), (5, 3), (7, 2)])
def test_split_plain_matches_jax_kernel_f32_pool(MB, chunk_pages):
    rng = np.random.default_rng(MB * 10 + chunk_pages)
    k, v = _pool(rng, quant=False)
    q, tables, lengths = _rows(rng, MB, chunk_pages)
    ref = np.asarray(jax_paged_attention(
        *map(jnp.asarray, (q, k, v, tables, lengths))))
    out = pa.paged_decode_split_plain(*_t(q, k, v, tables, lengths),
                                      chunk_pages).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    assert (out[0] == 0).all()          # a row of length 0 is exact zeros


@pytest.mark.parametrize("dtype,tol", [(torch.float32, TOL),
                                       (torch.bfloat16,
                                        dict(rtol=2e-2, atol=2e-2))])
def test_split_plain_matches_jax_kernel_int8_pool(dtype, tol):
    rng = np.random.default_rng(7)
    kq, vq, ks, vs = _pool(rng, quant=True)
    MB, chunk_pages = 5, 2
    q, tables, lengths = _rows(rng, MB, chunk_pages)
    jq = jnp.asarray(q, jnp.float32 if dtype == torch.float32
                     else jnp.bfloat16)
    ref = np.asarray(jax_paged_attention(
        jq, *map(jnp.asarray, (kq, vq, tables, lengths)),
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)), np.float32)
    qt, kt, vt, tt, lt, kst, vst = _t(q, kq, vq, tables, lengths, ks, vs)
    out = pa.paged_decode_split_plain(qt.to(dtype), kt, vt, tt, lt,
                                      chunk_pages, kst, vst)
    assert out.dtype == dtype
    np.testing.assert_allclose(out.float().numpy(), ref, **tol)
    assert (out[0] == 0).all()


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("chunk_pages", [1, 2, 3])
def test_split_plain_matches_plain_bf16(quant, chunk_pages):
    rng = np.random.default_rng(20 + chunk_pages)
    pool = _t(*_pool(rng, quant))
    if not quant:
        pool = [x.bfloat16() for x in pool]
    q, tables, lengths = _rows(rng, 7, chunk_pages)
    qt, tt, lt = _t(q, tables, lengths)
    k, v, *scales = pool
    args = (qt.bfloat16(), k, v, tt, lt)
    out = pa.paged_decode_split_plain(*args, chunk_pages, *scales)
    ref = pa.paged_attention_plain(*args, *scales)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref.float().numpy(),
                               rtol=1e-2, atol=1e-2)


def test_workspace_made_once_and_grown():
    dev = torch.device("cpu")
    pa._workspaces.pop(dev, None)
    try:
        ml, acc, tickets = pa._workspace(dev, 64, 6, 4, 128)
        assert ml.numel() == 64 * 6 * 2 * 4 and acc.numel() == 64 * 6 * 512
        assert tickets.dtype == torch.int32 and not tickets.any()
        # a smaller call reuses it; a larger one makes a new, larger one
        assert pa._workspace(dev, 8, 6, 4, 128)[2] is tickets
        grown = pa._workspace(dev, 128, 2, 4, 128)
        assert grown[2] is not tickets and grown[2].numel() == 128
        assert grown[1].numel() == 64 * 6 * 512 and not grown[2].any()
    finally:
        pa._workspaces.pop(dev, None)
