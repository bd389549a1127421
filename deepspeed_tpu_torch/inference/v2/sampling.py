"""Token sampling for the serving stack.

Port of ``deepspeed_tpu/inference/v2/sampling.py``:

* ``sample_tokens_rowwise`` — device-side temperature / top-p / top-k
  sampler with a key PER ROW (``fold_in_rows``); what
  ``InferenceEngineV2.generate`` and both decode paths (per-token and the
  fused window) use, so a row's sampled stream is independent of the batch
  it runs in. Rows with temperature <= 0 take the argmax.
* ``sample_tokens`` — one key for the whole batch (each row's key is the
  base key folded with its row index).
* ``greedy_tokens`` — device argmax as int32, the one definition of
  "greedy" the decode paths share.
* ``host_sample`` — the numpy sampler the SplitFuse scheduler runs per
  request (a per-request numpy Generator), copied exactly, so seeded
  scheduler streams match the JAX package's.

Keys. JAX derives row keys with threefry ``fold_in``; those bits cannot
be reproduced here. A key is a 32-bit integer held in an int64 tensor,
derived from (base seed, row seed, generated-token index) by a
counter-based hash written in torch integer ops: murmur3's 32-bit
finalizer over the folded words. Every product is formed from 16-bit
halves, so no step overflows int64 and the bits are the same on the CPU
and on the card. A row's draw depends only on its own key, never on the
rows around it or on padding (the invariant of the JAX docstring).

The draw. Each row turns its key into one uniform ``u`` in [0, 1) (24
bits) and picks by inverse CDF over the masked, renormalized support in
descending-logit order: the first sorted index whose cumulative
probability exceeds ``u`` times the total. The support — the top-p
prefix and the top-k ranks — is ``_topp_mask_sorted`` / ``_sorted_support``
of the JAX package, the same set for the same logits.

Top-p (nucleus): sort descending, keep the smallest prefix whose
cumulative probability reaches ``top_p`` (the first token always
survives), renormalize, sample.
"""

import numpy as np
import torch

NEG_INF = -1e30

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 ``x`` in [0, 2**32) and a 32-bit
    constant, from 16-bit halves so no intermediate passes 2**49."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer (a bijection on [0, 2**32))."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def _fold(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Fold a 32-bit word into a key (the ``fold_in`` of this port)."""
    return _mix32(_mul32(key, _GOLDEN) ^ _mix32((data + _GOLDEN) & _M32))


def prng_key(seed: int, device=None) -> torch.Tensor:
    """A base key (0-d int64 tensor) from an integer seed of any size:
    its 32-bit words are folded in one by one, low first."""
    seed = int(seed)
    n = max(2, -(-abs(seed).bit_length() // 32))
    words = [(seed >> (32 * i)) & _M32 for i in range(n)]
    if seed < 0:
        words.append(1)
    key = torch.tensor(0x2545F491, dtype=torch.int64, device=device)
    for w in words:
        key = _fold(key, torch.tensor(w, dtype=torch.int64, device=device))
    return key


def fold_in_rows(rng: torch.Tensor, row_seeds: torch.Tensor,
                 gen_idx: torch.Tensor) -> torch.Tensor:
    """[N] per-row keys: fold the row's stable seed, then its
    generated-token index, into the base key. Both the per-token and the
    fused-window decode paths derive keys this way, which is what makes
    their sampled streams the same and invariant to how the batch is
    composed or padded."""
    rs = row_seeds.to(torch.int64) & _M32
    gi = gen_idx.to(torch.int64) & _M32
    return _fold(_fold(rng.to(torch.int64).expand_as(rs), rs), gi)


def key_uniforms(keys: torch.Tensor) -> torch.Tensor:
    """One f32 uniform in [0, 1) per key (24 bits), any shape."""
    bits = _mix32(keys ^ 0x5BD1E995) >> 8
    return bits.to(torch.float32) * (1.0 / (1 << 24))


def _topp_mask_sorted(sorted_logits: torch.Tensor, top_p: torch.Tensor,
                      top_k: torch.Tensor = None) -> torch.Tensor:
    """Mask (to NEG_INF) the tail of descending-sorted logits whose
    cumulative softmax probability lies past top_p, and (when top_k > 0)
    every rank past top_k. top_p <= 0 clamps to keep-only-the-top-token."""
    probs = torch.softmax(sorted_logits, dim=-1)
    # exclusive cumsum: a token is kept while the mass BEFORE it is still
    # below top_p — the first token survives any top_p > 0
    cum_before = torch.cumsum(probs, dim=-1) - probs
    keep = cum_before < torch.clamp(top_p, min=1e-9)[..., None]
    if top_k is not None:
        V = sorted_logits.shape[-1]
        rank = torch.arange(V, device=sorted_logits.device)
        k = torch.where(top_k > 0, top_k, torch.full_like(top_k, V))
        keep = keep & (rank[None, :] < k[..., None])
    return torch.where(keep, sorted_logits,
                       torch.full_like(sorted_logits, NEG_INF))


def _sorted_support(logits: torch.Tensor, temperature: torch.Tensor,
                    top_p: torch.Tensor, top_k: torch.Tensor = None):
    """Shared scale/sort/mask body of both samplers: returns the
    descending sort ``order`` [N, V] and the NEG_INF-masked sorted logits
    the pick draws from."""
    scaled = logits.float() / torch.clamp(temperature, min=1e-6)[..., None]
    order = torch.argsort(-scaled, dim=-1, stable=True)
    sorted_logits = torch.gather(scaled, -1, order)
    return order, _topp_mask_sorted(sorted_logits, top_p, top_k)


def _inverse_cdf_pick(masked: torch.Tensor, u: torch.Tensor):
    """Sorted index drawn from softmax(masked) with the uniforms ``u``.
    The support is a prefix of the sorted order, so the pick is clamped
    to the support's last index (a rounding of ``u * total`` up to the
    total would otherwise run past it)."""
    probs = torch.softmax(masked, dim=-1)
    cdf = torch.cumsum(probs, dim=-1)
    target = u[:, None] * cdf[:, -1:]
    pick = torch.searchsorted(cdf, target, right=True)[:, 0]
    n_keep = (masked > NEG_INF / 2).sum(-1)
    return torch.minimum(pick, n_keep - 1)


def _unsort_pick(logits, order, pick, temperature):
    """Map sorted-index picks back to token ids, with temperature <= 0
    rows taking the plain argmax."""
    sampled = torch.gather(order, -1, pick[:, None])[:, 0]
    return torch.where(temperature <= 0.0, torch.argmax(logits, dim=-1),
                       sampled).to(torch.int32)


def sample_tokens_rowwise(logits: torch.Tensor, keys: torch.Tensor,
                          temperature: torch.Tensor, top_p: torch.Tensor,
                          top_k: torch.Tensor = None) -> torch.Tensor:
    """logits [N, V]; keys [N] from :func:`fold_in_rows`; temperature /
    top_p / top_k [N] (0 temperature = greedy; top_k 0/None = no rank
    cutoff). Returns [N] int32 tokens. Row r's draw depends only on its
    own key and logits. No host reads: the whole draw stays on the
    logits' device."""
    return sample_tokens_uniform(logits, key_uniforms(keys), temperature,
                                 top_p, top_k)


def sample_tokens_uniform(logits: torch.Tensor, u: torch.Tensor,
                          temperature: torch.Tensor, top_p: torch.Tensor,
                          top_k: torch.Tensor = None) -> torch.Tensor:
    """:func:`sample_tokens_rowwise` with the rows' uniforms ``u`` [N]
    (``key_uniforms`` of their keys) already drawn: the fused window
    draws a whole window's uniforms in one pass of the key hash."""
    order, masked = _sorted_support(logits, temperature, top_p, top_k)
    pick = _inverse_cdf_pick(masked, u)
    return _unsort_pick(logits, order, pick, temperature)


def sample_tokens(logits: torch.Tensor, rng: torch.Tensor,
                  temperature: torch.Tensor, top_p: torch.Tensor,
                  top_k: torch.Tensor = None) -> torch.Tensor:
    """One base key for the batch: row r draws with the base key folded
    with r (so a row's draw changes when the batch is recomposed; the
    decode paths use :func:`sample_tokens_rowwise`)."""
    N = logits.shape[0]
    rows = torch.arange(N, device=logits.device)
    keys = fold_in_rows(rng.to(logits.device), rows,
                        torch.zeros_like(rows))
    return sample_tokens_rowwise(logits, keys, temperature, top_p, top_k)


def greedy_tokens(logits: torch.Tensor) -> torch.Tensor:
    """Argmax next-token pick as int32 (first maximum on ties, as in
    JAX)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def host_sample(logits: np.ndarray, rng: np.random.Generator,
                temperature: float, top_p: float, top_k: int = 0) -> int:
    """One row, host-side: temperature / top-p / top-k with a per-request
    numpy Generator."""
    if temperature <= 0.0:
        return int(np.argmax(logits))
    scaled = logits.astype(np.float64) / max(temperature, 1e-6)
    order = np.argsort(-scaled)
    s = scaled[order]
    p = np.exp(s - s.max())
    p /= p.sum()
    cum_before = np.cumsum(p) - p
    keep = cum_before < max(top_p, 1e-9)  # <=0 clamps to top-token-only
    if top_k and top_k > 0:
        keep = keep & (np.arange(len(p)) < top_k)
    p = np.where(keep, p, 0.0)
    p /= p.sum()
    return int(order[rng.choice(len(p), p=p)])
