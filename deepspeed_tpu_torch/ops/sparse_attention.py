"""Block-sparse attention.

Port of ``deepspeed_tpu/ops/sparse_attention.py``, the counterpart of the
reference's ``deepspeed.ops.sparse_attention`` stack: the [S/block,
S/block] grid of attention blocks gets a per-head binary layout, and only
active blocks take part.

* Layout builders (numpy, bit-identical to the JAX package's, with the
  same ``np.random.default_rng(seed)`` draws): Dense, Fixed (local windows
  and periodic global summary blocks), Variable (custom local windows,
  global and random blocks), BigBird (window, global, random) and
  BSLongformer (sliding window and global blocks at chosen indices).
* :func:`sparse_attention`: ``impl="kernel"`` runs the block-skipping
  kernels of ``ops/sparse_kernels.py`` (three hand-written CUDA kernels on
  the card, their plain versions on CPU tensors); ``impl="dense"`` is the
  masked-dense torch path; ``impl="auto"`` takes the kernel on CUDA tensors
  whenever the shapes allow and the dense path elsewhere, as the JAX
  package does off the TPU.
* :class:`SparseSelfAttention`: holds a config and caches its layout per
  sequence length.
"""

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Sparsity configs (reference ops/sparse_attention/sparsity_config.py)
# ---------------------------------------------------------------------------
@dataclass
class SparsityConfig:
    num_heads: int
    block: int = 16
    different_layout_per_head: bool = False

    def setup_layout(self, seq_len: int) -> np.ndarray:
        if seq_len % self.block != 0:
            raise ValueError(f"seq_len {seq_len} not divisible by block "
                             f"{self.block}")
        n = seq_len // self.block
        return np.zeros((self.num_heads, n, n), np.int64)

    def make_layout(self, seq_len: int) -> np.ndarray:
        raise NotImplementedError

    def _finalize(self, layout: np.ndarray, causal: bool) -> np.ndarray:
        if causal:
            n = layout.shape[-1]
            layout = layout * np.tril(np.ones((n, n), np.int64))
        return layout


@dataclass
class DenseSparsityConfig(SparsityConfig):
    """All blocks active (testing baseline)."""

    def make_layout(self, seq_len: int) -> np.ndarray:
        return self.setup_layout(seq_len) + 1


@dataclass
class FixedSparsityConfig(SparsityConfig):
    """Local block windows; the last `num_global_blocks` of each window
    attend globally (and are attended to), repeating every
    `num_local_blocks`."""

    num_local_blocks: int = 4
    num_global_blocks: int = 1
    attention: str = "bidirectional"      # or "unidirectional"
    horizontal_global_attention: bool = False
    num_different_global_patterns: int = 1

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[-1]
        for h in range(self.num_heads):
            pat = (h % self.num_different_global_patterns
                   if self.different_layout_per_head else 0)
            for i in range(n):
                w0 = (i // self.num_local_blocks) * self.num_local_blocks
                # local window
                layout[h, i, w0:min(w0 + self.num_local_blocks, n)] = 1
                # global columns: last num_global_blocks of each window
                # (offset by the head's pattern index)
                for w in range(0, n, self.num_local_blocks):
                    g0 = w + self.num_local_blocks - self.num_global_blocks \
                        - pat
                    g0 = max(w, g0)
                    layout[h, i, g0:min(g0 + self.num_global_blocks, n)] = 1
            if self.horizontal_global_attention:
                for w in range(0, n, self.num_local_blocks):
                    g0 = max(w, w + self.num_local_blocks
                             - self.num_global_blocks)
                    layout[h, g0:min(g0 + self.num_global_blocks, n), :] = 1
        causal = self.attention == "unidirectional"
        return self._finalize(layout, causal)


@dataclass
class VariableSparsityConfig(SparsityConfig):
    """Custom local window sizes, explicit global block indices and random
    blocks."""

    num_random_blocks: int = 0
    local_window_blocks: Optional[list] = None     # e.g. [4, 2, 1]
    global_block_indices: Optional[list] = None    # e.g. [0]
    global_block_end_indices: Optional[list] = None
    attention: str = "bidirectional"
    horizontal_global_attention: bool = False
    seed: int = 0

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[-1]
        windows = self.local_window_blocks or [4]
        globals_ = self.global_block_indices or [0]
        rng = np.random.default_rng(self.seed)
        for h in range(self.num_heads):
            # local: consume windows in order, last repeats
            i = 0
            widx = 0
            while i < n:
                w = windows[min(widx, len(windows) - 1)]
                layout[h, i:i + w, i:i + w] = 1
                i += w
                widx += 1
            # global columns (and rows if horizontal)
            if self.global_block_end_indices:
                spans = zip(globals_, self.global_block_end_indices)
            else:
                spans = ((g, g + 1) for g in globals_)
            for g0, g1 in spans:
                layout[h, :, g0:min(g1, n)] = 1
                if self.horizontal_global_attention:
                    layout[h, g0:min(g1, n), :] = 1
            # random blocks
            for i in range(n):
                if self.num_random_blocks:
                    cols = rng.choice(n, self.num_random_blocks,
                                      replace=False)
                    layout[h, i, cols] = 1
        return self._finalize(layout, self.attention == "unidirectional")


@dataclass
class BigBirdSparsityConfig(SparsityConfig):
    """Sliding window, global edge blocks and random blocks per row."""

    num_random_blocks: int = 1
    num_sliding_window_blocks: int = 3
    num_global_blocks: int = 1
    attention: str = "bidirectional"
    seed: int = 0

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[-1]
        w = self.num_sliding_window_blocks // 2
        rng = np.random.default_rng(self.seed)
        for h in range(self.num_heads):
            for i in range(n):
                layout[h, i, max(0, i - w):min(n, i + w + 1)] = 1
                cols = rng.choice(n, min(self.num_random_blocks, n),
                                  replace=False)
                layout[h, i, cols] = 1
            g = min(self.num_global_blocks, n)
            layout[h, :, :g] = 1
            layout[h, :g, :] = 1
            layout[h, :, n - g:] = 1
            layout[h, n - g:, :] = 1
        return self._finalize(layout, self.attention == "unidirectional")


@dataclass
class BSLongformerSparsityConfig(SparsityConfig):
    """Sliding window and global attention at chosen block indices."""

    num_sliding_window_blocks: int = 3
    global_block_indices: Optional[list] = None
    global_block_end_indices: Optional[list] = None
    attention: str = "bidirectional"

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        n = layout.shape[-1]
        w = self.num_sliding_window_blocks // 2
        globals_ = self.global_block_indices or [0]
        for h in range(self.num_heads):
            for i in range(n):
                layout[h, i, max(0, i - w):min(n, i + w + 1)] = 1
            if self.global_block_end_indices:
                spans = zip(globals_, self.global_block_end_indices)
            else:
                spans = ((g, g + 1) for g in globals_)
            for g0, g1 in spans:
                layout[h, :, g0:min(g1, n)] = 1
                layout[h, g0:min(g1, n), :] = 1
        return self._finalize(layout, self.attention == "unidirectional")


# ---------------------------------------------------------------------------
# Execution
# ---------------------------------------------------------------------------
def sparse_attention(q, k, v, layout: np.ndarray, block: int,
                     causal: bool = False, softmax_scale: Optional[float]
                     = None, impl: str = "auto") -> torch.Tensor:
    """Block-sparse attention. q/k/v: [B, H, S, D]; layout [H, S/b, S/b].

    impl="kernel": the block-skipping kernels (ops/sparse_kernels.py);
    compute and memory scale with the ACTIVE blocks. impl="dense": the
    masked-dense torch path. "auto" takes the kernel on CUDA tensors when
    S % block == 0 and block >= 8, else the dense path; a shape that the
    CUDA kernels do not take then raises, it never runs dense quietly.

    Inactive blocks never contribute (masked at -1e30 before the softmax);
    with the causal flag the intra-block diagonal is causal too.
    """
    B, H, S, D = q.shape
    if impl == "auto":
        impl = ("kernel" if q.device.type == "cuda" and S % block == 0
                and block >= 8 else "dense")
    if impl == "kernel":
        from .sparse_kernels import sparse_flash_attention

        return sparse_flash_attention(q, k, v, layout, block, causal=causal,
                                      scale=softmax_scale)
    scale = softmax_scale or 1.0 / math.sqrt(D)
    lay = torch.as_tensor(np.asarray(layout, bool), device=q.device)
    # expand block layout to token resolution: [H, S, S]
    mask = lay.repeat_interleave(block, 1).repeat_interleave(block, 2)
    if causal:
        mask = mask & torch.ones(S, S, dtype=torch.bool,
                                 device=q.device).tril()[None]
    # the product in q's dtype, then f32, as jnp.einsum(...).astype(f32)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    scores = torch.where(mask[None], scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    # rows with no active block (fully masked) produce zeros, not NaNs
    any_active = mask.any(dim=-1)                         # [H, S]
    probs = torch.where(any_active[None, :, :, None], probs,
                        torch.zeros_like(probs))
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


class SparseSelfAttention:
    """The reference's ``ops/sparse_attention/sparse_self_attention.py``
    wrapper: holds a SparsityConfig, builds and caches the layout per
    sequence length."""

    def __init__(self, sparsity_config: SparsityConfig,
                 attn_mask_mode: str = "mul", max_seq_length: int = 2048):
        self.config = sparsity_config
        self.attn_mask_mode = attn_mask_mode
        self._layouts = {}

    def get_layout(self, seq_len: int) -> np.ndarray:
        """The layout for seq_len, built once and kept read-only, so that
        the kernels' table look-up keys it by identity
        (``sparse_kernels._layout_key``) instead of serializing it every
        call."""
        if seq_len not in self._layouts:
            layout = np.array(self.config.make_layout(seq_len))
            layout.setflags(write=False)
            self._layouts[seq_len] = layout
        return self._layouts[seq_len]

    def __call__(self, q, k, v, causal: bool = True):
        layout = self.get_layout(q.shape[2])
        return sparse_attention(q, k, v, layout, self.config.block,
                                causal=causal)
