"""PyTorch port: the tile route of ragged paged attention, on the CPU.

On the card, bf16 / fp16 ``ragged_attention`` runs two kernels: the
tokens of runs of two or more tokens go to tensor-core query tiles of at
most 64 tokens (``csrc/ragged_hopper.cuh``), the single-token runs to the
paged decode kernel's split-K walk under the decode plan
(``ds_paged_decode_rows``). Here the plan of that route is emulated in
torch ops (``run_classes``, ``ragged_tile_plan``, ``ragged_tiles_plain``)
and held against the JAX ``ragged_attention`` (interpret mode, as the JAX
package's tests run it) on the same numpy inputs in fp32, with the JAX
tests' tolerance (rtol = atol = 2e-5): buffers with rows split across
64-token windows, a row whose two runs are separated by other rows,
descending lengths inside a run, padding in the middle, a one-token
continuation, page sizes 16-128, GQA groups 1, 2 and 4, head_dim 64 and
128, and the int8 pool. The wrapper's CUDA branch is driven with CPU
tensors through a stand-in library: which entry points a call reaches,
with which plan, and that it reads nothing back from the card.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deepspeed_tpu.inference.v2.kernels.ragged_attention import \
    ragged_attention as jax_ragged_attention
from deepspeed_tpu_torch.inference.v2.kernels import paged_attention as pa
from deepspeed_tpu_torch.inference.v2.kernels import ragged_attention as ra

# the suite runs in several worker processes that share the CPUs: a
# small intra-op pool keeps torch from crowding out the other workers
torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)

# the buffer of every test below, in order: (row, positions) for a run of
# that row's tokens, (None, n) for n padding tokens
EDGE_RUNS = [
    (0, list(range(100))),              # across the 64-token window edge
    (1, [40, 41, 42]),                  # a 3-token continuation
    (2, [77]),                          # a decode row
    (None, 5),                          # padding in the middle
    (0, list(range(100, 130))),         # row 0 again, behind other rows
    (3, list(range(49, 39, -1))),       # lengths descending inside a run
    (4, [60]),                          # a one-token continuation
    (5, list(range(64))),               # one whole tile
]


def _buffer(rng, runs, T, nh, kvh, hd, bs, q8=False):
    """numpy inputs of a ragged call over `runs`, padded to T: q, pool
    (f32, or int8 with f32 scales [nb, kvh]), row_ids, lengths, tables
    with each row's pages distinct and random."""
    ctx = {}
    for r, pos in runs:
        if r is not None:
            ctx[r] = max(ctx.get(r, 0), max(pos) + 1)
    R = max(ctx) + 1
    pages = [-(-ctx[r] // bs) for r in range(R)]
    nb = 1 + sum(pages) + 3
    perm = rng.permutation(np.arange(1, nb))
    tables = np.zeros((R, max(pages)), np.int32)
    cur = 0
    for r in range(R):
        tables[r, :pages[r]] = perm[cur:cur + pages[r]]
        cur += pages[r]
    row_ids, lengths = [], []
    for r, pos in runs:
        row_ids += [0] * pos if r is None else [r] * len(pos)
        lengths += [0] * pos if r is None else [p + 1 for p in pos]
    pad = T - len(row_ids)
    row_ids = np.array(row_ids + [0] * pad, np.int32)
    lengths = np.array(lengths + [0] * pad, np.int32)
    q = rng.normal(size=(T, nh, hd)).astype(np.float32)
    shape = (nb, bs, kvh, hd)
    if q8:
        k, v = (rng.integers(-127, 128, size=shape).astype(np.int8)
                for _ in range(2))
        scales = [(rng.uniform(0.5, 1.5, size=(nb, kvh)) / 127.0)
                  .astype(np.float32) for _ in range(2)]
    else:
        k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
        scales = []
    return [q, k, v, row_ids, lengths, tables, *scales]


def _jax(args):
    return np.asarray(jax_ragged_attention(*map(jnp.asarray, args)))


def _t(args):
    return [torch.from_numpy(np.array(a)) for a in args]


# ---------------------------------------------------------------------------
# classification and the plan
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rows,lengths,multi,single", [
    # a prefill chunk, a decode row, padding
    ([0, 0, 0, 1, 0, 0], [1, 2, 3, 9, 0, 0],
     [1, 1, 1, 0, 0, 0], [0, 0, 0, 1, 0, 0]),
    # pure decode: every row a run of one
    ([0, 1, 2, 3], [5, 1, 7, 2], [0, 0, 0, 0], [1, 1, 1, 1]),
    # one row in two runs split by another row; padding between runs of
    # one row parts them
    ([0, 0, 1, 0, 2, 0, 2], [4, 5, 3, 6, 8, 0, 9],
     [1, 1, 0, 0, 0, 0, 0], [0, 0, 1, 1, 1, 0, 1]),
    # descending lengths are a run; a length-0 token of the same row
    # (padding pointing at row 0) is not part of it
    ([0, 0, 0, 0], [9, 8, 7, 0], [1, 1, 1, 0], [0, 0, 0, 0]),
])
def test_run_classes(rows, lengths, multi, single):
    m, s = ra.run_classes(torch.tensor(rows, dtype=torch.int32),
                          torch.tensor(lengths, dtype=torch.int32))
    assert m.tolist() == [bool(x) for x in multi]
    assert s.tolist() == [bool(x) for x in single]


def test_tile_plan_cuts_runs_at_windows_and_rows():
    """The tile kernel's segments: a run cut where a 64-token window ends,
    each segment within one run, with its largest and smallest length
    (capped at the table width); singletons and padding in none."""
    rng = np.random.default_rng(0)
    args = _buffer(rng, EDGE_RUNS, 256, 2, 1, 16, 16)
    rows, lens = torch.from_numpy(args[3]), torch.from_numpy(args[4])
    plan = ra.ragged_tile_plan(rows, lens, cap=10_000)
    # tokens: row 0 0..99, row 1 100..102, a decode row 103, padding
    # 104..108, row 0 109..138, row 3 139..148 (descending), a one-token
    # continuation 149, row 5 150..213, padding to 256
    assert plan == [
        [(0, 64, 64, 1)],
        [(64, 36, 100, 65), (100, 3, 43, 41), (109, 19, 119, 101)],
        [(128, 11, 130, 120), (139, 10, 50, 41), (150, 42, 42, 1)],
        [(192, 22, 64, 43)]]
    segs = [s for w in plan for s in w]
    covered = sorted(t for t0, n, _, _ in segs for t in range(t0, t0 + n))
    multi, _ = ra.run_classes(rows, lens)
    assert covered == multi.nonzero().flatten().tolist()
    for t0, n, mx, mn in segs:
        assert n <= ra.TILE_ROWS and t0 // 64 == (t0 + n - 1) // 64
        assert len(set(args[3][t0:t0 + n])) == 1
        assert mx == args[4][t0:t0 + n].max()
        assert mn == args[4][t0:t0 + n].min()
    # capped at the table's width
    capped = ra.ragged_tile_plan(rows, lens, cap=48)
    assert max(mx for w in capped for _, _, mx, _ in w) == 48


# ---------------------------------------------------------------------------
# the emulation against the JAX kernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("nh,kvh,hd,bs", [
    (4, 2, 16, 16), (4, 2, 16, 32), (4, 2, 16, 64), (4, 2, 16, 128),  # bs
    (4, 4, 16, 16), (4, 1, 16, 16),                          # groups 1, 4
    (2, 2, 64, 16), (2, 1, 128, 32),                         # hd 64, 128
])
def test_tiles_plain_matches_jax_kernel(nh, kvh, hd, bs):
    rng = np.random.default_rng(nh * 1000 + kvh * 100 + hd + bs)
    args = _buffer(rng, EDGE_RUNS, 256, nh, kvh, hd, bs)
    ref = _jax(args)
    out = ra.ragged_tiles_plain(*_t(args)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    pad = args[4] == 0
    assert (out[pad] == 0.0).all()


def test_tiles_plain_matches_jax_kernel_int8_pool():
    rng = np.random.default_rng(7)
    args = _buffer(rng, EDGE_RUNS, 256, 4, 2, 16, 16, q8=True)
    ref = _jax(args)
    out = ra.ragged_tiles_plain(*_t(args)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    assert (out[args[4] == 0] == 0.0).all()


# a mixed buffer with more single-token runs than table rows: rows 0 and 1
# alternate one token at a time (every token a run of one), then row 2's
# 40-token chunk; the first R = 3 single-token runs take the rows' plan,
# the other three the plan for T
INTERLEAVED_RUNS = [(0, [300]), (1, [500]), (0, [301]), (1, [501]),
                    (0, [302]), (1, [502]), (2, list(range(40)))]


@pytest.mark.parametrize("runs", ["edge", "interleaved"])
def test_mixed_batch_singletons_match_jax_kernel(runs):
    """A mixed batch's single-token runs under the rows' plan (and past
    the R-th under T's) agree with the JAX kernel."""
    rng = np.random.default_rng(11)
    buf = EDGE_RUNS if runs == "edge" else INTERLEAVED_RUNS
    args = _buffer(rng, buf, 256 if runs == "edge" else 48, 4, 2, 16, 16)
    np.testing.assert_allclose(ra.ragged_tiles_plain(*_t(args)).numpy(),
                               _jax(args), **TOL)


def test_mixed_batch_singletons_take_the_rows_plan():
    """The first R single-token runs in buffer order take the chunks of
    page_split_plan(R, ...), the rest those of page_split_plan(T, ...)."""
    rng = np.random.default_rng(12)
    args = _t(_buffer(rng, INTERLEAVED_RUNS, 48, 4, 2, 16, 16))
    q, k, v, rows, lens, tables = args
    R, MB = tables.shape
    (coarse, _), (fine, _) = ra.singleton_plans(48, R, 2, MB, 16)
    assert coarse != fine
    out = ra.ragged_tiles_plain(*args)
    kp = pa.gather_pages(k, None, tables.long(), q.dtype)
    vp = pa.gather_pages(v, None, tables.long(), q.dtype)
    for idx, chunk in ((torch.arange(3), fine), (torch.arange(3, 6), coarse)):
        r = rows.long()[idx]
        want = pa._split_attend_plain(q[idx], kp[r], vp[r], lens[idx],
                                      chunk * 16)
        assert torch.equal(out[idx], want)


def test_pure_decode_singletons_take_the_decode_plan():
    """A pure-decode buffer is all single-token runs: no tile, and the
    split arithmetic with page_split_plan(T, kvh, MB, bs)'s chunk, which
    is the paged decode kernel's for N = T rows, bit for bit."""
    rng = np.random.default_rng(3)
    runs = [(r, [n - 1]) for r, n in enumerate([1, 17, 33, 64, 65, 100])]
    args = _t(_buffer(rng, runs, 6, 4, 2, 16, 16))
    q, k, v, rows, lens, tables = args
    assert all(not w for w in ra.ragged_tile_plan(rows, lens, 10_000))
    chunk_pages, _ = pa.page_split_plan(6, 2, tables.shape[1], 16)
    want = pa.paged_decode_split_plain(q, k, v, tables, lens, chunk_pages)
    assert torch.equal(ra.ragged_tiles_plain(*args), want)


def test_padded_pure_decode_takes_the_rows_plan():
    """A pure-decode buffer padded past its R rows (T 16, R 6): the
    single-token runs take page_split_plan(R, kvh, MB, bs)'s chunk, the
    paged decode kernel's for those R rows, bit for bit; padding is 0."""
    rng = np.random.default_rng(4)
    runs = [(r, [n - 1]) for r, n in enumerate([1, 17, 400, 1000, 2000, 65])]
    args = _t(_buffer(rng, runs, 16, 4, 2, 16, 16))
    q, k, v, rows, lens, tables = args
    R, MB = tables.shape
    assert pa.page_split_plan(16, 2, MB, 16) != pa.page_split_plan(R, 2, MB,
                                                                   16)
    chunk_pages, _ = pa.page_split_plan(R, 2, MB, 16)
    want = pa.paged_decode_split_plain(q[:R], k, v, tables, lens[:R],
                                       chunk_pages)
    out = ra.ragged_tiles_plain(*args)
    assert torch.equal(out[:R], want)
    assert (out[R:] == 0).all()


# ---------------------------------------------------------------------------
# routes and the wrapper's CUDA branch (stand-in library)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype,hd,bs,route", [
    (torch.bfloat16, 128, 64, "tiles"), (torch.float16, 64, 16, "tiles"),
    (torch.bfloat16, 128, 8, "tiles"), (torch.bfloat16, 128, 24, "tiles"),
    (torch.float32, 128, 64, "page_walk"),      # TF32 would not pass 2e-5
    (torch.bfloat16, 96, 64, "page_walk"),      # no 64-column boxes
    (torch.bfloat16, 128, 4, "page_walk"),      # a box under 8 rows
    (torch.float16, 32, 64, "page_walk"),
])
def test_ragged_route(dtype, hd, bs, route):
    q = torch.zeros((3, 4, hd), dtype=dtype)
    k = torch.zeros((2, bs, 2, hd), dtype=dtype)
    assert ra.ragged_route(q, k) == route
    assert ra.ragged_route(q, k.to(torch.int8)) == route


def test_singleton_blocks():
    # a decode-sized buffer: one block per (token, kv head), as a decode
    # call launches
    for T, kvh, MB, bs in ((6, 2, 8, 16), (8, 8, 32, 64), (64, 8, 32, 64)):
        n_split = pa.page_split_plan(T, kvh, MB, bs)[1]
        assert ra.singleton_blocks(T, kvh, n_split) == T * kvh
    # a prefill-sized buffer: bounded
    assert ra.singleton_blocks(8192, 8, 1) == ra.SINGLETON_BLOCKS
    assert ra.singleton_blocks(0, 8, 1) == 1


def _fake_card(monkeypatch, code=0):
    """CPU tensors through the wrapper's CUDA branch: the device check says
    CUDA, the argument checks pass, the libraries record each entry point
    reached and its arguments; any read of a tensor's values back to the
    host, or a synchronize, raises."""
    calls = []

    class Lib:
        def __init__(self, name):
            self.name = name

        def __getattr__(self, entry):
            return lambda *args: calls.append((self.name, entry, args)) \
                or code

    def no_read(*a, **kw):
        raise AssertionError("the wrapper read a value back from the card")

    monkeypatch.setattr(ra, "_device_of", lambda name, q: "cuda")
    monkeypatch.setattr(ra, "check_kernel_args", lambda *a, **kw: None)
    monkeypatch.setattr(ra, "_stream", lambda q: 0)
    monkeypatch.setattr(ra.cuda_build, "load", Lib)
    for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__int__"):
        monkeypatch.setattr(torch.Tensor, name, no_read)
    monkeypatch.setattr(torch.cuda, "synchronize", no_read)
    return calls


def _small_call(dtype=torch.bfloat16, q8=False, T=6, hd=128, bs=16, mb=3):
    q = torch.zeros((T, 4, hd), dtype=dtype)
    pool = torch.zeros((5, bs, 2, hd), dtype=torch.int8 if q8 else dtype)
    rows = torch.arange(T, dtype=torch.int32)
    lens = torch.ones(T, dtype=torch.int32)
    tables = torch.ones((T, mb), dtype=torch.int32)
    scales = [torch.ones((5, 2)), torch.ones((5, 2))] if q8 else []
    return (q, pool, pool.clone(), rows, lens, tables, *scales)


@pytest.mark.parametrize("q8", [False, True])
def test_tile_route_launches_tiles_then_singletons(monkeypatch, q8):
    """bf16: the query tiles (ds_ragged_tiles), then the single-token walk
    of the paged kernel (ds_paged_decode_rows) with the decode plan for
    N = T and one block per (token, kv head); no value is read back; one
    count a call, on the counter of its pool."""
    calls = _fake_card(monkeypatch)
    args = _small_call(q8=q8)
    before = (ra.ragged_attention.launches, ra.ragged_attention.q8_launches)
    ra.ragged_attention(*args)
    assert [(lib, entry) for lib, entry, _ in calls] == [
        ("ragged_attention", "ds_ragged_tiles"),
        ("paged_attention", "ds_paged_decode_rows")]
    tiles, rows = calls[0][2], calls[1][2]
    T, nh, kvh, hd, bs, MB, nb = 6, 4, 2, 128, 16, 3, 5
    assert tiles[11:19] == (T, nh, kvh, hd, bs, MB, nb, 2)  # bf16 code 2
    (chunk_pages, n_split), (fine_pages, fine_split) = \
        ra.singleton_plans(T, T, kvh, MB, bs)
    assert rows[17:30] == (T, nh, kvh, hd, bs, MB, chunk_pages, n_split, T,
                           fine_pages, fine_split, T * kvh, 2)
    scale_ptrs = (args[6].data_ptr(), args[7].data_ptr()) if q8 else \
        (None, None)
    assert tiles[3:5] == scale_ptrs and rows[3:5] == scale_ptrs
    assert rows[7] == args[3].data_ptr()                   # row_ids
    # the walk reads the scan the tile launch writes
    assert rows[12:14] == tiles[9:11]
    after = (ra.ragged_attention.launches, ra.ragged_attention.q8_launches)
    assert after == (before[0] + (not q8), before[1] + q8)


def test_pure_decode_call_matches_the_decode_call(monkeypatch):
    """A pure-decode ragged call hands the split walk what a paged decode
    call of the same rows hands it: the plan page_split_plan(N, kvh, MB,
    bs) for its N rows (and, for a rank past them, the same plan for N = T
    with the paged kernel's workspace), one block per (row, kv head)."""
    calls = _fake_card(monkeypatch)
    q, k, v, rows, lens, tables = _small_call(T=8, mb=32)
    ra.ragged_attention(q, k, v, rows, lens, tables)
    walk = calls[1][2]
    chunk_pages, n_split = pa.page_split_plan(8, 2, 32, 16)
    assert n_split > 1          # the partials are kept: a real workspace
    ws = pa._workspace(q.device, 8 * 2, n_split, 2, 128)
    assert walk[9:12] == tuple(w.data_ptr() for w in ws)
    assert walk[23:25] == (chunk_pages, n_split)
    assert walk[25:28] == (8, chunk_pages, n_split)     # R rows' plan
    assert walk[28] == 8 * 2            # one block per (row, kv head)


def test_page_walk_route_is_one_launch(monkeypatch):
    calls = _fake_card(monkeypatch)
    ra.ragged_attention(*_small_call(dtype=torch.float32))
    ra.ragged_attention(*_small_call(hd=96))
    assert [entry for _, entry, _ in calls] == ["ds_ragged_paged_attention"] * 2
    ra.ragged_attention(*_small_call(dtype=torch.float32, q8=True))
    assert calls[-1][1] == "ds_ragged_paged_attention_q8"


def test_a_launch_error_raises(monkeypatch):
    """No fallback: a failed launch raises and counts nothing."""
    _fake_card(monkeypatch, code=1)
    before = ra.ragged_attention.launches
    with pytest.raises(RuntimeError, match="ragged_attention tiles"):
        ra.ragged_attention(*_small_call())
    assert ra.ragged_attention.launches == before
