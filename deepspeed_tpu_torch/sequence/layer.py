"""Attention dispatch: flash kernel or plain attention.

Port of the single-device part of ``deepspeed_tpu/sequence/layer.py``
(``_inner_attention`` :66, ``sharded_attention`` :99). The routing is the
JAX one: the flash kernels when ``use_flash`` holds and both sequence
lengths are multiples of 128, else :func:`mha_reference`. Sequence
parallelism (Ulysses or ring) and a topology with tensor or data
parallelism raise ``NotImplementedError`` (ROADMAP A8).
"""

from typing import Optional

from ..ops.flash_attention import flash_attention, mha_reference


def _inner_attention(q, k, v, causal, use_flash, block_q, block_kv, sp_size,
                     impl="ulysses", scale=None):
    """q/k/v: [B, H, S, D] on one device."""
    if sp_size > 1:
        raise NotImplementedError(
            f"sequence parallelism ({impl}, sp={sp_size}) is not ported to "
            "deepspeed_tpu_torch yet (ROADMAP A8)")
    s = q.shape[2]
    if use_flash and s % 128 == 0 and k.shape[2] % 128 == 0:
        return flash_attention(q, k, v, causal=causal, scale=scale,
                               block_q=block_q or None,
                               block_kv=block_kv or None)
    return mha_reference(q, k, v, causal=causal, scale=scale)


def sharded_attention(q, k, v, topo: Optional[object] = None,
                      causal: bool = True, use_flash: bool = True,
                      block_q: int = 128, block_kv: int = 128,
                      impl: str = "ulysses", scale=None):
    """Attention over [B, H, S, D]. Only ``topo=None`` (one device) is
    ported; any topology raises (ROADMAP A8)."""
    if topo is not None:
        raise NotImplementedError(
            "sharded_attention over a device topology (dp/tp/sp) is not "
            "ported to deepspeed_tpu_torch yet (ROADMAP A8)")
    return _inner_attention(q, k, v, causal, use_flash, block_q, block_kv, 1,
                            impl=impl, scale=scale)
