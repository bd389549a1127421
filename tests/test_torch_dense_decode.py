"""PyTorch port: the split-K plan and arithmetic of the dense decode kernel.

``csrc/dense_decode_attention.cu`` cuts each (row, kv head)'s cache into
chunks of whole 64-slot tiles (``split_plan``), one block per chunk, and
combines the chunks' partial softmax states in chunk order. Held here on
the CPU:

* ``split_plan``: the chunks cover ``[0, M)``, are tile multiples, and
  give more than 132 blocks at B 8, kvh 8, M 2048 (the chip shape);
* ``dense_decode_split_plain`` (the split-and-combine arithmetic in torch
  ops) against the JAX ``dense_decode_attention`` kernel in interpret
  mode, at lengths 0, 1, a chunk boundary +- 1 and M, with an M that is no
  multiple of the chunk (2e-5, the JAX tests' tolerance), and against the
  port's plain version in bf16;
* the kernel's workspace: made once per device, its tickets zero, reused
  while it is large enough.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deepspeed_tpu.ops.decode_attention import \
    dense_decode_attention as jax_dense_decode

from deepspeed_tpu_torch.ops import decode_attention as dd

# the suite runs in several worker processes that share the CPUs: a
# small intra-op pool keeps torch from crowding out the other workers
torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("B,kvh,M", [(8, 8, 2048), (8, 8, 576),
                                     (8, 8, 1000), (1, 1, 10), (2, 4, 64),
                                     (32, 8, 4096), (1, 8, 100000)])
def test_split_plan_covers_cache_in_tiles(B, kvh, M):
    chunk, n_split = dd.split_plan(B, kvh, M)
    assert chunk % dd.TILE == 0 and chunk > 0
    # the chunks [s * chunk, (s + 1) * chunk) cover [0, M), none is empty
    assert n_split * chunk >= M
    assert (n_split - 1) * chunk < max(M, 1)


def test_split_plan_fills_the_card_at_the_chip_shape():
    chunk, n_split = dd.split_plan(8, 8, 2048)
    assert 8 * 8 * n_split > 132
    assert (chunk, n_split) == (384, 6)
    # the v1 serve cache (512 prompt + 64 new): two tiles per chunk
    assert dd.split_plan(8, 8, 576) == (128, 5)
    # a large batch needs no split
    assert dd.split_plan(64, 8, 2048) == (2048, 1)


def _inputs(rng, B, nh, kvh, M, hd):
    q = rng.normal(size=(B, nh, hd)).astype(np.float32)
    kc = rng.normal(size=(B, kvh, M, hd)).astype(np.float32)
    vc = rng.normal(size=(B, kvh, M, hd)).astype(np.float32)
    return q, kc, vc


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("M,nh,kvh", [(200, 4, 2), (256, 8, 2), (130, 4, 4)])
def test_split_plain_matches_jax_kernel_at_chunk_edges(M, nh, kvh):
    chunk = dd.TILE
    lengths = np.array([0, 1, chunk - 1, chunk, chunk + 1, M - 1, M],
                       np.int32)
    q, kc, vc = _inputs(np.random.default_rng(M), len(lengths), nh, kvh, M,
                        16)
    ref = np.asarray(jax_dense_decode(*map(jnp.asarray, (q, kc, vc, lengths)),
                                      block_kv=64))
    out = dd.dense_decode_split_plain(*_t(q, kc, vc, lengths), chunk).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    assert (out[0] == 0).all()          # a row of length 0 is exact zeros


@pytest.mark.parametrize("chunk", [64, 128, 192])
def test_split_plain_any_chunk_matches_plain_bf16(chunk):
    rng = np.random.default_rng(chunk)
    M = 300
    lengths = np.array([0, 1, chunk - 1, chunk + 1, 299, 300], np.int32)
    q, kc, vc = _inputs(rng, len(lengths), 8, 2, M, 16)
    args = [t.bfloat16() for t in _t(q, kc, vc)] + _t(lengths)
    out = dd.dense_decode_split_plain(*args, chunk)
    ref = dd.dense_decode_attention_plain(*args)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref.float().numpy(),
                               rtol=1e-2, atol=1e-2)


def test_workspace_made_once_and_grown():
    dev = torch.device("cpu")
    dd._workspaces.pop(dev, None)
    try:
        ml, acc, tickets = dd._workspace(dev, 64, 8, 4, 128)
        assert ml.numel() == 64 * 8 * 2 * 4 and acc.numel() == 64 * 8 * 512
        assert tickets.dtype == torch.int32 and not tickets.any()
        # a smaller call reuses it; a larger one makes a new, larger one
        assert dd._workspace(dev, 8, 8, 4, 128)[2] is tickets
        grown = dd._workspace(dev, 128, 2, 4, 128)
        assert grown[2] is not tickets and grown[2].numel() == 128
        assert grown[1].numel() == 64 * 8 * 512 and not grown[2].any()
    finally:
        dd._workspaces.pop(dev, None)
