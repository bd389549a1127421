"""PyTorch port: block-sparse attention against the JAX package.

``deepspeed_tpu_torch/ops/sparse_attention.py`` and ``sparse_kernels.py``
against ``deepspeed_tpu/ops/sparse_attention.py`` and ``sparse_kernels.py``
on the same numpy inputs:

* the five layout builders give equal layouts (the random ones with the
  same ``default_rng(seed)`` draws), and ``build_tables`` equal tables;
* the plain versions of the three CUDA kernels against the JAX Pallas
  kernels run in interpret mode, as the JAX package's own tests run them
  (o and lse against ``_sparse_fwd``, dq/dk/dv against ``_sparse_bwd``),
  fp32, tolerance 2e-5 (f32 reordering over a few hundred keys);
* torch autograd through ``sparse_attention(impl="kernel")`` on CPU tensors
  (the plain versions) against ``jax.grad`` through the JAX
  ``sparse_attention(impl="kernel")``, fp32, 5e-5;
* the masked-dense path against JAX's, fp32 (2e-5) and bf16 (2e-2: both
  round the scores, the probabilities and the output to bf16, so an
  f32 reordering can flip one bf16 rounding, 2**-7 relative, of outputs of
  magnitude ~1);
* ``impl="auto"`` on CPU tensors takes the dense path and launches nothing;
* the 64-row tile tables, expanded to tokens, equal the layout; the
  tensor-core forward's walk over them (a torch emulation of its
  arithmetic: dq's items and steps in order, sub-block masks, the causal
  diagonal, the online softmax in f32) against the JAX ``_fwd_kernel`` in
  interpret mode, 2e-5, with exact o = 0 and lse = -1e30 for rows that
  see no key;
* the forward's routing (tensor-core entry with the tile tables, their
  check, the tile kernels for f32 and S % 64 != 0) through a stand-in
  library, and ``_SparseCore`` handing its tiles to all three wrappers;
* the tables' layout key: serialized once for ``SparseSelfAttention``'s
  cached read-only layout, once a call for a writeable one, which gets
  new tables after an in-place change.

The CUDA kernels are held against the plain versions on the card by
chip_smoke.py.
"""

import functools
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu.ops import sparse_kernels as jsk
from deepspeed_tpu_torch.ops import sparse_attention as tsa
from deepspeed_tpu_torch.ops import sparse_kernels as tsk

# the suite runs in several worker processes that share the CPUs: a
# small intra-op pool keeps torch from crowding out the other workers
torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=5e-5, atol=5e-5)
D = 64

# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------
# name -> (config class name, kwargs, seq_len)
LAYOUTS = {
    "dense": ("DenseSparsityConfig", dict(num_heads=3, block=16), 128),
    "fixed": ("FixedSparsityConfig", dict(num_heads=2, block=16), 256),
    "fixed_unidirectional_horizontal": (
        "FixedSparsityConfig",
        dict(num_heads=2, block=16, num_local_blocks=4, num_global_blocks=2,
             attention="unidirectional", horizontal_global_attention=True),
        256),
    "fixed_per_head": (
        "FixedSparsityConfig",
        dict(num_heads=4, block=16, num_local_blocks=4,
             different_layout_per_head=True,
             num_different_global_patterns=3), 256),
    **{f"variable_seed{s}": (
        "VariableSparsityConfig",
        dict(num_heads=2, block=16, num_random_blocks=2,
             local_window_blocks=[2, 1, 3], global_block_indices=[0, 5],
             seed=s), 256) for s in (0, 1, 7)},
    "variable_horizontal_spans": (
        "VariableSparsityConfig",
        dict(num_heads=2, block=16, num_random_blocks=1,
             global_block_indices=[1, 8], global_block_end_indices=[3, 10],
             horizontal_global_attention=True, attention="unidirectional",
             seed=4), 256),
    **{f"bigbird_seed{s}": (
        "BigBirdSparsityConfig",
        dict(num_heads=3, block=16, num_random_blocks=2, seed=s), 256)
        for s in (0, 3, 11)},
    "bigbird_unidirectional": (
        "BigBirdSparsityConfig",
        dict(num_heads=2, block=8, num_sliding_window_blocks=5,
             num_global_blocks=2, attention="unidirectional"), 128),
    "longformer": ("BSLongformerSparsityConfig",
                   dict(num_heads=2, block=16), 256),
    "longformer_spans": (
        "BSLongformerSparsityConfig",
        dict(num_heads=2, block=16, num_sliding_window_blocks=5,
             global_block_indices=[0, 6], global_block_end_indices=[2, 9],
             attention="unidirectional"), 256),
}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_layout_matches_jax(name):
    cls, kwargs, seq = LAYOUTS[name]
    ref = getattr(jsa, cls)(**kwargs).make_layout(seq)
    got = getattr(tsa, cls)(**kwargs).make_layout(seq)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    if "per_head" in name:
        assert not np.array_equal(got[0], got[1])


@pytest.mark.parametrize("cls", ["DenseSparsityConfig", "FixedSparsityConfig",
                                 "VariableSparsityConfig",
                                 "BigBirdSparsityConfig",
                                 "BSLongformerSparsityConfig"])
def test_indivisible_seq_raises(cls):
    with pytest.raises(ValueError, match="divisible"):
        getattr(tsa, cls)(num_heads=2, block=16).make_layout(16 * 4 + 3)


# ---------------------------------------------------------------------------
# kernels: name -> (layout builder, block, B, S, causal)
# ---------------------------------------------------------------------------
def _fully_masked_rows():
    layout = np.zeros((1, 4, 4), bool)
    layout[0, 2:, :2] = True      # the first two q blocks see no block
    return layout


CASES = {
    "fixed_causal": (lambda: tsa.FixedSparsityConfig(
        num_heads=2, block=16, num_local_blocks=2, num_global_blocks=1,
        attention="unidirectional").make_layout(128), 16, 1, 128, True),
    "fixed_bidirectional": (lambda: tsa.FixedSparsityConfig(
        num_heads=2, block=16, num_local_blocks=2,
        num_global_blocks=1).make_layout(128), 16, 1, 128, False),
    "bigbird_block8": (lambda: tsa.BigBirdSparsityConfig(
        num_heads=2, block=8, num_random_blocks=1,
        num_sliding_window_blocks=3, num_global_blocks=1).make_layout(64),
        8, 1, 64, False),
    "fully_masked_rows": (_fully_masked_rows, 8, 2, 32, False),
    # 64-row blocks: one tile of the tensor-core walk per block
    "fixed_block64_causal": (lambda: tsa.FixedSparsityConfig(
        num_heads=2, block=64, num_local_blocks=2, num_global_blocks=1,
        attention="unidirectional").make_layout(256), 64, 1, 256, True),
    # different layouts per head at B 2: row b must read head b % H
    "per_head": (lambda: tsa.FixedSparsityConfig(
        num_heads=2, block=16, num_local_blocks=4, num_global_blocks=1,
        different_layout_per_head=True, num_different_global_patterns=2,
        attention="unidirectional").make_layout(128), 16, 2, 128, True),
}


@functools.lru_cache(maxsize=None)
def _case(name, seed=0):
    """(layout, block, causal, q, k, v, w) with q/k/v/w [B, H, S, D] f32."""
    make, block, b, s, causal = CASES[name]
    layout = make()
    rng = np.random.default_rng(seed)
    q, k, v, w = (rng.normal(size=(b, layout.shape[0], s, D))
                  .astype(np.float32) for _ in range(4))
    return layout, block, causal, q, k, v, w


def _fold(x):
    return x.reshape(-1, *x.shape[2:])


@functools.lru_cache(maxsize=None)
def _jax_kernels(name):
    """o, lse (``_sparse_fwd``) and dq, dk, dv (``_sparse_bwd``) for the
    cotangent w, in interpret mode."""
    layout, block, causal, q, k, v, w = _case(name)
    H = layout.shape[0]
    tables = [jnp.asarray(t) for t in jsk.build_tables(layout, causal)]
    qf, kf, vf = (jnp.asarray(_fold(a)) for a in (q, k, v))
    scale = 1.0 / math.sqrt(D)
    o, lse = jsk._sparse_fwd(qf, kf, vf, *tables[:2], scale, causal, block, H)
    grads = jsk._sparse_bwd((qf, kf, vf, o, lse, *tables),
                            jnp.asarray(_fold(w)), scale, causal, block, H)
    return tuple(np.asarray(a) for a in (o, lse, *grads))


def _torch_tables(layout, causal):
    return [torch.from_numpy(t) for t in tsk.build_tables(layout, causal)]


@pytest.mark.parametrize("name", list(CASES))
def test_build_tables_match_jax(name):
    layout, _, causal, *_ = _case(name)
    for c in (causal, not causal):
        ref = jsk.build_tables(layout, c)
        got = tsk.build_tables(layout, c)
        for a, r in zip(got, ref):
            assert a.dtype == np.int32 and np.array_equal(a, r)
    assert tsk.build_tables(layout, causal) is tsk.build_tables(layout,
                                                                causal)


@pytest.mark.parametrize("name", list(CASES))
def test_fwd_plain_matches_jax_kernel(name):
    layout, block, causal, q, k, v, _ = _case(name)
    o_ref, lse_ref, *_ = _jax_kernels(name)
    kv_idx, kv_valid, _, _ = _torch_tables(layout, causal)
    o, lse = tsk.sparse_fwd_plain(
        *(torch.from_numpy(_fold(a)) for a in (q, k, v)), kv_idx, kv_valid,
        1.0 / math.sqrt(D), causal, block, layout.shape[0])
    np.testing.assert_allclose(o.numpy(), o_ref, **TOL)
    np.testing.assert_allclose(lse.numpy(), lse_ref, **TOL)
    assert lse.dtype == torch.float32 and lse.shape == (*o.shape[:2], 1)


@pytest.mark.parametrize("name", list(CASES))
def test_bwd_plain_matches_jax_kernels(name):
    layout, block, causal, q, k, v, w = _case(name)
    o, lse, *ref = _jax_kernels(name)
    tables = _torch_tables(layout, causal)
    qf, kf, vf, do = (torch.from_numpy(_fold(a)) for a in (q, k, v, w))
    o, lse = torch.from_numpy(o.copy()), torch.from_numpy(lse.copy())
    delta = (do * o).sum(-1, keepdim=True)
    args = (1.0 / math.sqrt(D), causal, block, layout.shape[0])
    dq = tsk.sparse_bwd_dq_plain(qf, kf, vf, do, lse, delta, *tables[:2],
                                 *args)
    dk, dv = tsk.sparse_bwd_dkv_plain(qf, kf, vf, do, lse, delta,
                                      *tables[2:], *args)
    for a, r, g in zip((dq, dk, dv), ref, ("dq", "dk", "dv")):
        np.testing.assert_allclose(a.numpy(), r, **TOL, err_msg=g)


@pytest.mark.parametrize("name", ["fixed_causal", "bigbird_block8",
                                  "per_head"])
def test_autograd_matches_jax_grad(name):
    layout, block, causal, q, k, v, w = _case(name)

    def jloss(q, k, v):
        o = jsa.sparse_attention(q, k, v, layout, block, causal=causal,
                                 impl="kernel")
        return jnp.sum(o * w), o

    jg, jo = jax.grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    to = tsa.sparse_attention(tq, tk, tv, layout, block, causal=causal,
                              impl="kernel")
    (to * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), **TOL)
    for t, r, g in zip((tq, tk, tv), jg, "qkv"):
        assert t.grad.shape == t.shape
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r),
                                   **GRAD_TOL, err_msg=f"d{g}")


def test_fully_masked_rows_zero():
    """q blocks 0 and 1 see no block: o = 0, lse = -1e30 and dq = 0 there;
    kv blocks 2 and 3 feed no q block: dk = dv = 0 there."""
    layout, block, causal, q, k, v, w = _case("fully_masked_rows")
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    o = tsa.sparse_attention(tq, tk, tv, layout, block, impl="kernel")
    (o * torch.from_numpy(w)).sum().backward()
    rows = 2 * block
    assert (o[:, :, :rows] == 0).all() and (o[:, :, rows:] != 0).any()
    assert (tq.grad[:, :, :rows] == 0).all()
    assert (tk.grad[:, :, rows:] == 0).all() and \
        (tv.grad[:, :, rows:] == 0).all()
    tables = _torch_tables(layout, False)
    _, lse = tsk.sparse_fwd_plain(
        *(torch.from_numpy(_fold(a)) for a in (q, k, v)), *tables[:2],
        1.0 / math.sqrt(D), False, block, 1)
    assert (lse[:, :rows] == tsk.NEG_INF).all()


# ---------------------------------------------------------------------------
# the dense path, auto routing, the op wrapper
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["fixed_causal", "bigbird_block8",
                                  "fully_masked_rows"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_matches_jax_dense(name, dtype):
    layout, block, causal, q, k, v, _ = _case(name)
    ref = jsa.sparse_attention(
        *(jnp.asarray(a, dtype=dtype) for a in (q, k, v)), layout, block,
        causal=causal, impl="dense")
    got = tsa.sparse_attention(
        *(torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)),
        layout, block, causal=causal, impl="dense")
    assert got.dtype == getattr(torch, dtype)
    tol = TOL if dtype == "float32" else dict(rtol=0, atol=2e-2)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), **tol)


def test_auto_on_cpu_takes_dense_and_launches_nothing():
    layout, block, causal, q, k, v, w = _case("fixed_causal")
    kernels = (tsk.sparse_fwd, tsk.sparse_bwd_dq, tsk.sparse_bwd_dkv)
    before = [f.launches for f in kernels]
    tq = torch.from_numpy(q).requires_grad_(True)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    auto = tsa.sparse_attention(tq, tk, tv, layout, block, causal=causal)
    dense = tsa.sparse_attention(tq, tk, tv, layout, block, causal=causal,
                                 impl="dense")
    assert torch.equal(auto, dense)
    tsa.sparse_attention(tq, tk, tv, layout, block, causal=causal,
                         impl="kernel").sum().backward()
    assert [f.launches for f in kernels] == before


def test_wrappers_run_plain_versions_on_cpu():
    layout, block, causal, q, k, v, w = _case("per_head")
    H = layout.shape[0]
    tables = _torch_tables(layout, causal)
    qf, kf, vf, do = (torch.from_numpy(_fold(a)) for a in (q, k, v, w))
    args = (0.125, causal, block, H)
    o, lse = tsk.sparse_fwd(qf, kf, vf, *tables[:2], *args)
    o_p, lse_p = tsk.sparse_fwd_plain(qf, kf, vf, *tables[:2], *args)
    assert torch.equal(o, o_p) and torch.equal(lse, lse_p)
    delta = (do * o).sum(-1, keepdim=True)
    assert torch.equal(
        tsk.sparse_bwd_dq(qf, kf, vf, do, lse, delta, *tables[:2], *args),
        tsk.sparse_bwd_dq_plain(qf, kf, vf, do, lse, delta, *tables[:2],
                                *args))
    for a, b in zip(
            tsk.sparse_bwd_dkv(qf, kf, vf, do, lse, delta, *tables[2:],
                               *args),
            tsk.sparse_bwd_dkv_plain(qf, kf, vf, do, lse, delta,
                                     *tables[2:], *args)):
        assert torch.equal(a, b)


def test_plain_versions_walk_blocks_in_chunks(monkeypatch):
    """A chunk of one block at a time (the card's memory bound at S 8192)
    gives the same result as one chunk."""
    layout, block, causal, q, k, v, w = _case("per_head")
    tables = _torch_tables(layout, causal)
    qf, kf, vf, do = (torch.from_numpy(_fold(a)) for a in (q, k, v, w))
    args = (0.125, causal, block, layout.shape[0])

    def run():
        o, lse = tsk.sparse_fwd_plain(qf, kf, vf, *tables[:2], *args)
        delta = (do * o).sum(-1, keepdim=True)
        return (o, lse, tsk.sparse_bwd_dq_plain(qf, kf, vf, do, lse, delta,
                                                *tables[:2], *args),
                *tsk.sparse_bwd_dkv_plain(qf, kf, vf, do, lse, delta,
                                          *tables[2:], *args))

    whole = run()
    monkeypatch.setattr(tsk, "_CHUNK_ELEMS", 1)
    for a, b in zip(run(), whole):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_sparse_self_attention_caches_layout_and_matches_jax():
    cfg = dict(num_heads=2, block=16, num_local_blocks=2,
               attention="unidirectional")
    attn = tsa.SparseSelfAttention(tsa.FixedSparsityConfig(**cfg))
    assert attn.get_layout(128) is attn.get_layout(128)
    _, _, _, q, k, v, _ = _case("fixed_causal")
    ref = jsa.SparseSelfAttention(jsa.FixedSparsityConfig(**cfg))(
        *(jnp.asarray(a) for a in (q, k, v)))
    got = attn(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_device_tables_are_cached():
    layout, _, causal, *_ = _case("fixed_causal")
    a = tsk.device_tables(layout, causal, "cpu")
    assert a is tsk.device_tables(layout.copy(), causal,
                                  torch.device("cpu"))
    for t, r in zip(a, tsk.build_tables(layout, causal)):
        assert t.dtype == torch.int32 and np.array_equal(t.numpy(), r)


@pytest.mark.parametrize("bad", ["dtype", "head_dim", "block", "seq",
                                 "heads", "table"])
def test_kernel_argument_checks(bad):
    H, S, block = 2, 128, 16
    q = k = v = torch.zeros(4, S, 64)
    layout = np.ones((H, S // block, S // block), bool)
    tables = [torch.from_numpy(t) for t in tsk.build_tables(layout, True)]
    exc, match = ValueError, r"\(4, 128, \d+\)"
    if bad == "dtype":
        k = k.double()
        exc, match = TypeError, "float64"
    elif bad == "head_dim":
        q = k = v = torch.zeros(4, S, 32)
    elif bad == "block":
        block = 8
    elif bad == "seq":
        block = 48
    elif bad == "heads":
        H = 3
    else:
        tables = [t.long() for t in tables]
        match = "int32"
    with pytest.raises(exc, match=match):
        tsk._check("sparse_fwd", block, H, q, k, v, tables=tables[:2])


# ---------------------------------------------------------------------------
# the tensor-core backward's 64-row tile tables
# ---------------------------------------------------------------------------
TILE_SEQ = 512


def _empty_q_blocks(block):
    """q blocks 1 and 2 (inside the first 64-row tile at block 16) and the
    last quarter of the q blocks see no block."""
    n = TILE_SEQ // block
    layout = np.ones((2, n, n), bool)
    layout[:, 1:3] = False
    layout[:, 3 * n // 4:] = False
    return layout


def _empty_kv_blocks(block):
    """kv blocks 1 and 2 and the last quarter of the kv blocks feed no q
    block; head 1 also has an empty diagonal."""
    n = TILE_SEQ // block
    layout = np.ones((2, n, n), bool)
    layout[:, :, 1:3] = False
    layout[:, :, 3 * n // 4:] = False
    layout[1, np.arange(n), np.arange(n)] = False
    return layout


TILE_LAYOUTS = {
    "fixed": lambda b: tsa.FixedSparsityConfig(
        num_heads=2, block=b, num_local_blocks=2, num_global_blocks=1,
        attention="unidirectional").make_layout(TILE_SEQ),
    "fixed_per_head": lambda b: tsa.FixedSparsityConfig(
        num_heads=3, block=b, num_local_blocks=2,
        different_layout_per_head=True,
        num_different_global_patterns=2).make_layout(TILE_SEQ),
    "bigbird": lambda b: tsa.BigBirdSparsityConfig(
        num_heads=2, block=b, num_random_blocks=1,
        num_sliding_window_blocks=3, seed=5).make_layout(TILE_SEQ),
    "longformer": lambda b: tsa.BSLongformerSparsityConfig(
        num_heads=2, block=b, num_sliding_window_blocks=3,
        global_block_indices=[1]).make_layout(TILE_SEQ),
    "variable": lambda b: tsa.VariableSparsityConfig(
        num_heads=2, block=b, num_random_blocks=1, local_window_blocks=[1, 2],
        global_block_indices=[0], seed=3).make_layout(TILE_SEQ),
    "empty_q_blocks": _empty_q_blocks,
    "empty_kv_blocks": _empty_kv_blocks,
}


def _tile_visibility(items, steps, heads, causal, kv_major):
    """Token-level [H, S, S] visibility of a walk, under the kernels' rule:
    a step's element is visible iff its mask is all ones, or its sub-block
    bit is set and (non-causal, off the diagonal tile, or q_pos >= k_pos).
    Also counts how often each tile is owned by an item."""
    nt = TILE_SEQ // tsk.TILE
    vis = np.zeros((heads, TILE_SEQ, TILE_SEQ), bool)
    owned = np.zeros((heads, nt), int)
    masks = steps[:, 1].view(np.uint32)
    tril = np.tril(np.ones((tsk.TILE, tsk.TILE), bool))
    for h, t0, t1, start, n in items:
        for w, tile in enumerate((t0, t1)):
            if tile < 0:
                continue
            owned[h, tile] += 1
            for other, m in zip(steps[start:start + n, 0],
                                masks[start:start + n]):
                m = int(m >> (16 * w)) & 0xFFFF
                qt, kt = (other, tile) if kv_major else (tile, other)
                bits = np.array([(m >> i) & 1 for i in range(16)],
                                bool).reshape(4, 4)
                tile_vis = np.kron(bits, np.ones((16, 16), bool))
                if m != 0xFFFF and causal and qt == kt:
                    tile_vis &= tril
                rows = slice(qt * tsk.TILE, (qt + 1) * tsk.TILE)
                cols = slice(kt * tsk.TILE, (kt + 1) * tsk.TILE)
                assert not (vis[h, rows, cols] & tile_vis).any()
                vis[h, rows, cols] |= tile_vis
    return vis, owned


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block", [16, 32, 64, 128])
@pytest.mark.parametrize("name", list(TILE_LAYOUTS))
def test_tile_tables_expand_to_layout(name, block, causal):
    """dq's and dk/dv's walks, expanded to tokens, equal the layout
    expanded by block (and tril under causal); every tile of every head is
    in exactly one item, and no step is dead (a zero mask on both tiles)."""
    layout = TILE_LAYOUTS[name](block)
    H, n, _ = layout.shape
    want = np.repeat(np.repeat(layout.astype(bool), block, 1), block, 2)
    if causal:
        want &= np.tril(np.ones((TILE_SEQ, TILE_SEQ), bool))
    tiles = tsk.build_tile_tables(layout, causal, block)
    for items, steps, kv_major in ((tiles.dq_items, tiles.dq_steps, False),
                                   (tiles.dkv_items, tiles.dkv_steps, True)):
        assert items.dtype == np.int32 and steps.dtype == np.int32
        assert (steps[:, 1] != 0).all()
        vis, owned = _tile_visibility(items, steps, H, causal, kv_major)
        assert (owned == 1).all()
        np.testing.assert_array_equal(vis, want)
    if name.startswith("empty"):
        assert not want.all(axis=(2 if name == "empty_q_blocks" else 1)
                            ).all()


@pytest.mark.parametrize("name", ["fixed", "bigbird", "empty_kv_blocks"])
def test_tile_work_list_heaviest_first(name):
    """Items run heaviest first, their step lists lie back to back in item
    order with ascending tiles, and *_max is the longest list; dq pairs
    neighbouring q tiles, dk/dv kv tiles of alike lists."""
    layout = TILE_LAYOUTS[name](16)
    tiles = tsk.build_tile_tables(layout, True, 16)
    nt = TILE_SEQ // tsk.TILE
    for items, steps, longest in (
            (tiles.dq_items, tiles.dq_steps, tiles.dq_max),
            (tiles.dkv_items, tiles.dkv_steps, tiles.dkv_max)):
        counts, starts = items[:, 4], items[:, 3]
        assert (np.diff(counts) <= 0).all()
        assert (starts == np.cumsum(counts) - counts).all()
        assert counts.sum() == len(steps) and longest == counts.max()
        for _, _, _, start, n in items:
            assert (np.diff(steps[start:start + n, 0]) > 0).all()
    assert sorted(map(tuple, tiles.dq_items[:, 1:3] % nt)) == sorted(
        (t, t + 1) for t in range(0, nt, 2) for _ in range(2))


def test_tile_pairing_beats_neighbours_on_fixed():
    """On a Fixed layout with a global column every local block the sorted
    dk/dv pairing leaves fewer dead slots than pairing neighbours: the
    global columns pair with each other."""
    layout = tsa.FixedSparsityConfig(
        num_heads=1, block=64, num_local_blocks=4, num_global_blocks=1,
        attention="unidirectional").make_layout(4096)
    tiles = tsk.build_tile_tables(layout, True, 64)
    masks = tsk.tile_masks(layout, True, 64)[0] != 0       # [t, u]
    neighbours = (masks[:, 0::2] | masks[:, 1::2]).sum()
    assert len(tiles.dkv_steps) < 0.8 * neighbours
    assert tiles.dkv_steps.shape[0] * 2 >= masks.sum()


def test_tile_tables_cached_and_uploaded():
    layout = TILE_LAYOUTS["bigbird"](32)
    a = tsk.build_tile_tables(layout, False, 32)
    assert a is tsk.build_tile_tables(layout.copy(), False, 32)
    assert a is not tsk.build_tile_tables(layout, True, 32)
    dev = tsk.device_tile_tables(layout, False, 32, "cpu")
    assert dev is tsk.device_tile_tables(layout.copy(), False, 32,
                                         torch.device("cpu"))
    for t, r in zip(dev, a):
        if isinstance(r, np.ndarray):
            assert t.dtype == torch.int32 and np.array_equal(t.numpy(), r)
        else:
            assert t == r
    with pytest.raises(ValueError, match="multiple of 64"):
        tsk.build_tile_tables(np.ones((1, 5, 5), bool), False, 16)


def test_tensor_core_route_and_tile_check():
    """bf16 / fp16 with S % 64 == 0 take the tensor-core kernels, which
    need the tile tables; f32 and a ragged last tile take the tile route."""
    x = torch.zeros(2, 128, 64)
    assert not tsk.tensor_core_route(x)
    assert tsk.tensor_core_route(x.bfloat16())
    assert tsk.tensor_core_route(x.half())
    assert not tsk.tensor_core_route(torch.zeros(2, 80, 64).bfloat16())
    with pytest.raises(ValueError, match="tiles="):
        tsk._check_tiles("sparse_bwd_dq", x.bfloat16(), 1, None)
    layout = np.ones((1, 8, 8), bool)
    tiles = tsk.device_tile_tables(layout, True, 16, "cpu")
    tsk._check_tiles("sparse_bwd_dq", x.bfloat16(), 1, tiles)
    with pytest.raises(ValueError, match="int32"):
        tsk._check_tiles("sparse_bwd_dq", x.bfloat16(), 1,
                         tiles._replace(dq_steps=tiles.dq_steps.long()))
    with pytest.raises(ValueError, match="1 heads and 2 tiles"):
        tsk._check_tiles("sparse_bwd_dq", x.bfloat16(), 2, tiles)
    with pytest.raises(ValueError, match="1 heads and 2 tiles"):
        tsk._check_tiles("sparse_bwd_dq", torch.zeros(2, 256, 64).half(),
                         1, tiles)


# ---------------------------------------------------------------------------
# the tensor-core forward's walk, the forward's routing, the layout key
# ---------------------------------------------------------------------------
def _empty_q_and_kv_blocks(block):
    """Both of the above: q blocks and kv blocks with no active block,
    inside a 64-row tile (at blocks 16 and 32) and as whole tiles."""
    return _empty_q_blocks(block) & _empty_kv_blocks(block)


FWD_WALK_LAYOUTS = {
    "fixed": TILE_LAYOUTS["fixed"],
    "bigbird": TILE_LAYOUTS["bigbird"],
    "empty_q_and_kv": _empty_q_and_kv_blocks,
}


def _walk_forward(q, k, v, tiles, scale, causal):
    """The tensor-core forward's arithmetic in torch, f32: for every dq item
    and each of its (one or two) q tiles, the steps in list order; a step
    whose mask for the tile is 0 is skipped; a mask of all ones is wholly
    visible, any other one keeps its active 16 x 16 sub-blocks and, on a
    causal diagonal tile, q_pos >= k_pos; then the online softmax with
    m_safe, p rounded to v's dtype before P V, o = acc / l_safe and
    lse = m + log(l_safe) (-1e30 for a row that saw no key)."""
    bh, s, d = q.shape
    T, H = tsk.TILE, tiles.nheads
    o = torch.full((bh, s, d), float("nan"))
    lse = torch.full((bh, s, 1), float("nan"))
    masks = tiles.dq_steps[:, 1].view(np.uint32)
    tril = torch.ones(T, T, dtype=torch.bool).tril()
    for b in range(bh // H):
        for h, t0, t1, start, n in tiles.dq_items:
            row = b * H + h
            for w, tile in enumerate((t0, t1)):
                if tile < 0:
                    continue
                rows = slice(tile * T, (tile + 1) * T)
                qt = q[row, rows].float()
                acc = torch.zeros(T, d)
                m = torch.full((T, 1), tsk.NEG_INF)
                l = torch.zeros(T, 1)
                for other, mask in zip(tiles.dq_steps[start:start + n, 0],
                                       masks[start:start + n]):
                    mask = int(mask >> (16 * w)) & 0xFFFF
                    if mask == 0:
                        continue
                    cols = slice(other * T, (other + 1) * T)
                    sc = qt @ k[row, cols].float().T * scale
                    if mask != 0xFFFF:
                        bits = torch.tensor(
                            [(mask >> i) & 1 for i in range(16)],
                            dtype=torch.bool).view(4, 4)
                        vis = bits.repeat_interleave(
                            16, 0).repeat_interleave(16, 1)
                        if causal and other == tile:
                            vis &= tril
                        sc = torch.where(vis, sc,
                                         torch.full_like(sc, tsk.NEG_INF))
                    m_new = torch.maximum(m, sc.amax(1, keepdim=True))
                    m_safe = torch.where(m_new <= tsk.NEG_INF * 0.5,
                                         torch.zeros_like(m_new), m_new)
                    p = torch.exp(sc - m_safe)
                    corr = torch.exp(m - m_new)
                    l = l * corr + p.sum(1, keepdim=True)
                    acc = acc * corr + p.to(v.dtype).float() @ \
                        v[row, cols].float()
                    m = m_new
                l_safe = torch.where(l == 0, torch.ones_like(l), l)
                o[row, rows] = (acc / l_safe).to(q.dtype)
                lse[row, rows] = m + torch.log(l_safe)
    return o, lse


@functools.lru_cache(maxsize=None)
def _fwd_walk_case(name, block, causal):
    """(layout, q, k, v [bh, S, D] f32, JAX o, JAX lse) at S 512, B 1."""
    layout = FWD_WALK_LAYOUTS[name](block)
    rng = np.random.default_rng(block + 2 * causal)
    q, k, v = (rng.normal(size=(layout.shape[0], TILE_SEQ, D))
               .astype(np.float32) for _ in range(3))
    tables = [jnp.asarray(t) for t in jsk.build_tables(layout, causal)]
    o, lse = jsk._sparse_fwd(*(jnp.asarray(a) for a in (q, k, v)),
                             *tables[:2], 1.0 / math.sqrt(D), causal, block,
                             layout.shape[0])
    return layout, q, k, v, np.asarray(o), np.asarray(lse)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block", [16, 32, 64, 128])
@pytest.mark.parametrize("name", list(FWD_WALK_LAYOUTS))
def test_tile_walk_forward_matches_jax_kernel(name, block, causal):
    """The tensor-core forward's walk over dq's items and steps gives the
    JAX ``_fwd_kernel``'s o and lse (interpret mode), f32, 2e-5; every row
    is written once, and a row that sees no key gets o = 0 and lse = -1e30
    exactly."""
    layout, q, k, v, o_ref, lse_ref = _fwd_walk_case(name, block, causal)
    tiles = tsk.build_tile_tables(layout, causal, block)
    o, lse = _walk_forward(*(torch.from_numpy(a) for a in (q, k, v)), tiles,
                           1.0 / math.sqrt(D), causal)
    np.testing.assert_allclose(o.numpy(), o_ref, **TOL)
    np.testing.assert_allclose(lse.numpy(), lse_ref, **TOL)
    want = np.repeat(np.repeat(layout.astype(bool), block, 1), block, 2)
    if causal:
        want &= np.tril(np.ones((TILE_SEQ, TILE_SEQ), bool))
    dead = torch.from_numpy(~want.any(-1))                 # [H, S]
    assert (o[dead] == 0).all() and (lse[dead] == tsk.NEG_INF).all()
    assert (lse[~dead] > tsk.NEG_INF / 2).all()
    if name == "empty_q_and_kv":
        assert dead.any()
        # whole q tiles with an empty list: items of no step
        assert (tiles.dq_items[:, 4] == 0).any()


def _fake_card(monkeypatch):
    """CPU tensors through the CUDA branch of the wrappers: the device
    check says CUDA, the kernels' checks pass, and the library records
    which entry point each call reaches (returning success)."""
    calls = []

    class Lib:
        def __getattr__(self, entry):
            return lambda *args: calls.append((entry, args)) or 0

    monkeypatch.setattr(tsk, "_device_of", lambda name, q: "cuda")
    monkeypatch.setattr(tsk, "_check", lambda *a, **kw: None)
    monkeypatch.setattr(tsk, "_stream", lambda q: 0)
    monkeypatch.setattr(tsk.cuda_build, "load", lambda name: Lib())
    return calls


def test_sparse_fwd_routes(monkeypatch):
    """bf16 / fp16 with S % 64 == 0 reach ds_sparse_fwd_hopper with dq's
    items and steps and need the tile tables; f32 and S 80 reach the tile
    kernels' ds_sparse_fwd; each launch counts once."""
    calls = _fake_card(monkeypatch)
    layout = np.ones((2, 8, 8), bool)
    tables = _torch_tables(layout, True)
    tiles = tsk.device_tile_tables(layout, True, 16, "cpu")
    args = (0.125, True, 16, 2)
    before = tsk.sparse_fwd.launches
    for dtype in (torch.bfloat16, torch.float16):
        x = torch.zeros(2, 128, 64, dtype=dtype)
        tsk.sparse_fwd(x, x, x, *tables[:2], *args, tiles=tiles)
        entry, a = calls[-1]
        assert entry == "ds_sparse_fwd_hopper"
        assert a[3:5] == (tiles.dq_items.data_ptr(),
                          tiles.dq_steps.data_ptr())
        assert a[11:13] == (tiles.dq_items.shape[0], tiles.dq_max)
    x = torch.zeros(2, 128, 64)
    tsk.sparse_fwd(x, x, x, *tables[:2], *args)
    assert calls[-1][0] == "ds_sparse_fwd"
    lay80 = np.ones((2, 5, 5), bool)
    x = torch.zeros(2, 80, 64, dtype=torch.bfloat16)
    tsk.sparse_fwd(x, x, x, *_torch_tables(lay80, True)[:2], *args)
    assert calls[-1][0] == "ds_sparse_fwd"
    assert tsk.sparse_fwd.launches == before + 4


def test_sparse_fwd_tensor_core_route_checks_tiles(monkeypatch):
    """Without tiles, or with tiles of another S or head count, the
    tensor-core forward raises the tile check's error and launches
    nothing."""
    calls = _fake_card(monkeypatch)
    layout = np.ones((2, 8, 8), bool)
    tables = _torch_tables(layout, True)
    x = torch.zeros(2, 128, 64, dtype=torch.bfloat16)
    args = (0.125, True, 16, 2)
    before = tsk.sparse_fwd.launches
    with pytest.raises(ValueError, match="tiles="):
        tsk.sparse_fwd(x, x, x, *tables[:2], *args)
    other_s = tsk.device_tile_tables(np.ones((2, 16, 16), bool), True, 16,
                                      "cpu")
    with pytest.raises(ValueError, match="2 heads and 4 tiles"):
        tsk.sparse_fwd(x, x, x, *tables[:2], *args, tiles=other_s)
    other_h = tsk.device_tile_tables(np.ones((1, 8, 8), bool), True, 16,
                                      "cpu")
    with pytest.raises(ValueError, match="1 heads and 2 tiles"):
        tsk.sparse_fwd(x, x, x, *tables[:2], *args, tiles=other_h)
    assert calls == [] and tsk.sparse_fwd.launches == before


def test_sparse_core_hands_tiles_to_forward(monkeypatch):
    """_SparseCore passes its tile tables to the forward as to dq and
    dk/dv."""
    seen = {}
    for name in ("sparse_fwd", "sparse_bwd_dq", "sparse_bwd_dkv"):
        wrapper = getattr(tsk, name)

        def spy(*a, _name=name, _wrapper=wrapper, tiles=None):
            seen[_name] = tiles
            return _wrapper(*a, tiles=tiles)

        monkeypatch.setattr(tsk, name, spy)
    layout, block, causal, q, k, v, w = _case("fixed_causal")
    tables = _torch_tables(layout, causal)
    tiles = tsk.device_tile_tables(layout, causal, block, "cpu")
    tq, tk, tv = (torch.from_numpy(_fold(a)).requires_grad_(True)
                  for a in (q, k, v))
    o = tsk._SparseCore.apply(tq, tk, tv, *tables, 0.125, causal, block,
                              layout.shape[0], tiles)
    (o * torch.from_numpy(_fold(w))).sum().backward()
    assert seen == {n: tiles for n in ("sparse_fwd", "sparse_bwd_dq",
                                       "sparse_bwd_dkv")}


def _count_serializations(monkeypatch):
    count = [0]
    serialize = tsk._layout_bytes

    def counted(layout):
        count[0] += 1
        return serialize(layout)

    monkeypatch.setattr(tsk, "_layout_bytes", counted)
    return count


def test_sparse_self_attention_serializes_its_layout_once(monkeypatch):
    """Repeated SparseSelfAttention calls on the kernel path serialize the
    cached (read-only) layout once; the output stays the same."""
    count = _count_serializations(monkeypatch)
    monkeypatch.setattr(tsa, "sparse_attention",
                        functools.partial(tsa.sparse_attention,
                                          impl="kernel"))
    cfg = tsa.FixedSparsityConfig(num_heads=2, block=16, num_local_blocks=2,
                                  attention="unidirectional")
    attn = tsa.SparseSelfAttention(cfg)
    assert not attn.get_layout(128).flags.writeable
    _, _, _, q, k, v, _ = _case("fixed_causal")
    x = [torch.from_numpy(a) for a in (q, k, v)]
    outs = [attn(*x) for _ in range(3)]
    assert count[0] == 1
    assert all(torch.equal(a, outs[0]) for a in outs)
    np.testing.assert_allclose(outs[0].numpy(), np.asarray(
        jsa.SparseSelfAttention(jsa.FixedSparsityConfig(
            num_heads=2, block=16, num_local_blocks=2,
            attention="unidirectional"))(*(jnp.asarray(a)
                                           for a in (q, k, v)))), **TOL)


def test_changed_writeable_layout_gets_new_tables(monkeypatch):
    """A writeable layout changed in place between two calls gets the
    tables of its new contents, serialized once a call; so does a
    read-only view of a writeable array."""
    count = _count_serializations(monkeypatch)
    layout, block, causal, q, k, v, _ = _case("fixed_causal")
    layout = layout.copy()
    x = [torch.from_numpy(a) for a in (q, k, v)]
    first = tsk.sparse_flash_attention(*x, layout, block, causal)
    assert count[0] == 1
    layout[:, 4:, :2] = 0                       # drop the global columns
    second = tsk.sparse_flash_attention(*x, layout, block, causal)
    assert count[0] == 2
    fresh = tsk.sparse_flash_attention(*x, layout.copy(), block, causal)
    assert torch.equal(second, fresh) and not torch.equal(first, second)
    for t, r in zip(tsk.device_tables(layout, causal, "cpu"),
                    tsk.build_tables(layout.copy(), causal)):
        assert np.array_equal(t.numpy(), r)
    view = layout.view()
    view.setflags(write=False)
    key = tsk._layout_key(view, causal)
    layout[:, :, :] = 1
    assert tsk._layout_key(view, causal) != key
