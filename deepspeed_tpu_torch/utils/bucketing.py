"""Shared static-shape bucketing helpers.

Port of ``deepspeed_tpu/utils/bucketing.py``. The serving hot paths pad
their inputs to these buckets so every layer keys its shapes the same way
(and so a later CUDA-graph capture sees a bounded set of shapes).

Two rules:

* :func:`pow2_bucket` — next power of two, capped. Used for decode batch
  rows, block-table widths, and both axes of the ragged (token x row)
  layout.
* :func:`ceil_bucket` — round up to a multiple, capped. Used for prefill
  chunk lengths.
"""


def pow2_bucket(count: int, cap: int) -> int:
    """Smallest power of two >= ``count`` (min 1), capped at ``cap``.

    ``count`` above ``cap`` clamps to ``cap`` (the caller's hard limit —
    e.g. max tracked sequences — is itself the final bucket even when it
    is not a power of two)."""
    if cap < 1:
        raise ValueError(f"bucket cap must be >= 1 (got {cap})")
    b = 1
    while b < count:
        b *= 2
    return min(b, cap)


def ceil_bucket(n: int, multiple: int, cap: int = None) -> int:
    """``n`` rounded up to a multiple of ``multiple``; when ``cap`` is
    given the result never exceeds ``cap`` rounded up the same way (the
    bucket for the largest admissible input)."""
    if multiple < 1:
        raise ValueError(f"bucket multiple must be >= 1 (got {multiple})")
    b = -(-n // multiple) * multiple
    if cap is not None:
        b = min(b, -(-cap // multiple) * multiple)
    return b
