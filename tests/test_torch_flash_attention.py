"""PyTorch port: flash attention against the JAX package's kernels.

The port keeps a plain PyTorch version beside each hand-written CUDA
kernel of ``deepspeed_tpu_torch/ops/flash_attention.py``. Here, on the
CPU, the plain versions (and the port's autograd ``flash_attention``,
which runs them on CPU tensors) are held against the JAX Pallas kernels
run in interpret mode, as the JAX package's own tests run them: the
forward's o and lse against ``_flash_fwd``, the backward's dq/dk/dv
against ``_flash_bwd`` and against ``jax.grad`` through the
``custom_vjp``. Inputs come from a numpy seed; fp32, D = 64,
tolerance 2e-5. The CUDA kernels are held against the plain versions on
the card by chip_smoke.py.
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.ops import flash_attention as jfa
from deepspeed_tpu_torch.ops import flash_attention as tfa
from deepspeed_tpu_torch.sequence import layer as tlayer

# the suite runs in several worker processes that share the CPUs: a
# small intra-op pool keeps torch from crowding out the other workers
torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)
D = 64

# name -> (b, h, hk, sq, skv, causal)
CASES = {
    "causal": (2, 4, 4, 256, 256, True),
    "noncausal": (2, 4, 4, 256, 256, False),
    "gqa": (1, 8, 2, 128, 128, True),
    "sq_lt_skv": (1, 4, 2, 128, 256, True),
    "sq_gt_skv": (1, 4, 2, 256, 128, True),
}


def _inputs(case, seed=0):
    b, h, hk, sq, skv, causal = CASES[case]
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, sq, D)).astype(np.float32)
    k = rng.normal(size=(b, hk, skv, D)).astype(np.float32)
    v = rng.normal(size=(b, hk, skv, D)).astype(np.float32)
    w = rng.normal(size=(b, h, sq, D)).astype(np.float32)   # cotangent
    return q, k, v, w, causal


def _fold(x):
    return x.reshape(-1, *x.shape[2:])


def _jax_fwd(q, k, v, causal):
    qf, kf, vf = (jnp.asarray(_fold(a)) for a in (q, k, v))
    bq = jfa._pick_block(q.shape[2], 256)
    bk = jfa._pick_block(k.shape[2], 512)
    o, lse = jfa._flash_fwd(qf, kf, vf, 1.0 / math.sqrt(D), causal, bq, bk)
    return (qf, kf, vf, o, lse), (bq, bk)


@pytest.mark.parametrize("case", list(CASES))
def test_fwd_plain_matches_jax_kernel(case):
    q, k, v, _, causal = _inputs(case)
    (_, _, _, o_ref, lse_ref), _ = _jax_fwd(q, k, v, causal)
    o, lse = tfa.flash_fwd_plain(
        *(torch.from_numpy(_fold(a)) for a in (q, k, v)),
        1.0 / math.sqrt(D), causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), **TOL)
    assert lse.dtype == torch.float32 and lse.shape == (o.shape[0],
                                                        o.shape[1], 1)


@pytest.mark.parametrize("case", list(CASES))
def test_bwd_plain_matches_jax_kernels(case):
    q, k, v, w, causal = _inputs(case)
    res, (bq, bk) = _jax_fwd(q, k, v, causal)
    do = _fold(w)
    ref = jfa._flash_bwd(res, jnp.asarray(do), 1.0 / math.sqrt(D), causal,
                         bq, bk)
    t = [torch.from_numpy(np.array(a)) for a in res]
    got = tfa.flash_bwd_plain(*t, torch.from_numpy(do), 1.0 / math.sqrt(D),
                              causal)
    for a, r, name in zip(got, ref, ("dq", "dk", "dv")):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_autograd_matches_jax_grad(case):
    q, k, v, w, causal = _inputs(case)

    def jloss(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, causal=causal) * w)

    jo = jfa.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                             causal=causal)
    jg = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    to = tfa.flash_attention(tq, tk, tv, causal=causal)
    (to * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), **TOL)
    for t, r, name in zip((tq, tk, tv), jg, "qkv"):
        assert t.grad.shape == t.shape
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), **TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("case", list(CASES))
def test_mha_reference_matches_jax(case):
    q, k, v, _, causal = _inputs(case)
    ref = jfa.mha_reference(*(jnp.asarray(a) for a in (q, k, v)),
                            causal=causal)
    out = tfa.mha_reference(*(torch.from_numpy(a) for a in (q, k, v)),
                            causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_fully_masked_rows_give_zeros():
    """Sq > Skv under the bottom-right causal mask: query rows
    0 .. Sq - Skv - 1 see no key, so o = 0, lse = -1e30 and dq = 0."""
    q, k, v, w, causal = _inputs("sq_gt_skv")
    n_masked = q.shape[2] - k.shape[2]
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    o, lse = tfa.flash_fwd_plain(_fold(tq.detach()), _fold(tk.detach()),
                                 _fold(tv.detach()), 1.0 / math.sqrt(D), True)
    assert (o[:, :n_masked] == 0).all()
    assert (lse[:, :n_masked] == tfa.NEG_INF).all()
    assert torch.isfinite(lse[:, n_masked:]).all()
    out = tfa.flash_attention(tq, tk, tv, causal=True)
    (out * torch.from_numpy(w)).sum().backward()
    assert (tq.grad[:, :, :n_masked] == 0).all()
    assert (tq.grad[:, :, n_masked:] != 0).any()


def test_cpu_wrappers_launch_nothing():
    q, k, v, w, causal = _inputs("gqa")
    before = (tfa.flash_fwd.launches, tfa.flash_bwd_dq.launches,
              tfa.flash_bwd_dkv.launches)
    tq = torch.from_numpy(q).requires_grad_(True)
    tfa.flash_attention(tq, torch.from_numpy(k), torch.from_numpy(v)) \
        .sum().backward()
    assert (tfa.flash_fwd.launches, tfa.flash_bwd_dq.launches,
            tfa.flash_bwd_dkv.launches) == before


def test_routing_flash_only_at_multiples_of_128(monkeypatch):
    calls = []
    monkeypatch.setattr(tlayer, "flash_attention",
                        lambda *a, **kw: calls.append("flash") or a[0])
    monkeypatch.setattr(tlayer, "mha_reference",
                        lambda *a, **kw: calls.append("plain") or a[0])
    x128 = torch.zeros(1, 2, 128, D)
    x96 = torch.zeros(1, 2, 96, D)
    tlayer.sharded_attention(x128, x128, x128, use_flash=True)
    tlayer.sharded_attention(x96, x96, x96, use_flash=True)
    tlayer.sharded_attention(x128, x128, x128, use_flash=False)
    tlayer.sharded_attention(x128, torch.zeros(1, 2, 96, D),
                             torch.zeros(1, 2, 96, D), use_flash=True)
    assert calls == ["flash", "plain", "plain", "plain"]


def test_unported_attention_modes_raise():
    # Ulysses and ring run now (tests/test_torch_tensor_parallel.py); a
    # one-rank topology is the plain dispatch, and an unknown sequence-
    # parallel strategy raises
    from deepspeed_tpu_torch.parallel.topology import (MeshTopology,
                                                       TopologyConfig)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 2, 128, D, generator=g)
    want = tlayer.sharded_attention(x, x, x, use_flash=False)
    got = tlayer.sharded_attention(x, x, x, topo=MeshTopology(
        TopologyConfig(), world_size=1, rank=0), use_flash=False)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="seq_parallel_impl"):
        tlayer._inner_attention(x, x, x, True, False, 0, 0, sp_size=2,
                                impl="bogus")


@pytest.mark.parametrize("bad", ["dtype", "head_dim", "seq", "heads",
                                 "align"])
def test_kernel_argument_checks(bad):
    q = torch.zeros(4, 128, 64)
    k = torch.zeros(2, 128, 64)
    v = torch.zeros(2, 128, 64)
    if bad == "dtype":
        k = k.to(torch.bfloat16)
        exc = TypeError
    elif bad == "head_dim":
        q, k, v = q[..., :32].contiguous(), k[..., :32].contiguous(), \
            v[..., :32].contiguous()
        exc = ValueError
    elif bad == "seq":
        q = torch.zeros(4, 96, 64)
        exc = ValueError
    elif bad == "heads":
        k = v = torch.zeros(3, 128, 64)
        exc = ValueError
    else:
        # contiguous, but 4 bytes into its storage: TMA needs 16
        q = torch.zeros(4 * 128 * 64 + 1)[1:].view(4, 128, 64)
        assert q.is_contiguous() and q.data_ptr() % 16
        exc = ValueError
    with pytest.raises(exc, match="aligned" if bad == "align" else None):
        tfa._check("flash_fwd", q, k, v)
