"""Token sampling for the serving stack.

Port of ``deepspeed_tpu/inference/v2/sampling.py``:

* ``greedy_tokens`` — device argmax as int32, the one definition of
  "greedy" the decode paths share.
* ``host_sample`` — the numpy sampler the SplitFuse scheduler runs per
  request (temperature / top-p / top-k with a per-request numpy
  Generator), copied exactly, so seeded streams match the JAX package.

The device-side samplers (``fold_in_rows``, ``sample_tokens_rowwise``) draw
from JAX's threefry keys and are not ported yet: ``generate()`` serves
greedy only.
"""

import numpy as np
import torch


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
