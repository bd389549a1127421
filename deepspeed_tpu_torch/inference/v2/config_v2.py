"""Ragged inference engine configuration.

Port of ``deepspeed_tpu/inference/v2/config_v2.py``: the same two
dataclasses, fields and defaults. Features the port does not serve yet
raise ``NotImplementedError`` at construction instead of being ignored:
the LoRA bank (``max_lora_adapters``), tensor/expert parallelism, the KV
spill tier, and the stitched ``ragged_attention="off"`` dispatch, whose
prefill needs the flash-attention kernel. The int8 KV pool (``kv_quant``) and
weight-only quantization (``quant_bits`` 8 or 4) are served.
"""

from dataclasses import dataclass, field
from typing import Optional


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to deepspeed_tpu_torch yet (ROADMAP {item})")


def check_ragged_mode(mode: str) -> None:
    """Validate a ``ragged_attention`` mode: "auto" and "on" both run
    every put() as one ragged step; "off" is not ported."""
    if mode not in ("auto", "on", "off"):
        raise ValueError(
            f"ragged_attention must be 'auto', 'on' or 'off' "
            f"(got {mode!r})")
    if mode == "off":
        raise _not_ported(
            "ragged_attention='off' (its stitched prefill runs the "
            "flash-attention kernel, ops/flash_attention.py)", "A6a")


@dataclass
class DSStateManagerConfig:
    max_tracked_sequences: int = 64          # concurrent sequences
    max_ragged_batch_size: int = 768         # tokens per put() (prefill cap)
    max_ragged_sequence_count: int = 512
    max_seq_len: int = 2048
    num_blocks: int = 256                    # KV pool size (incl. null block)
    block_size: int = 64                     # tokens per KV block
    memory_reserve_fraction: float = 0.0
    # share full KV blocks across requests with identical token prefixes
    # (ragged_manager.py; off by default)
    enable_prefix_caching: bool = False
    enable_kv_spill: bool = False
    kv_spill_host_bytes: int = 64 << 20
    kv_spill_dir: Optional[str] = None
    kv_spill_disk_bytes: int = 256 << 20
    kv_spill_namespace: Optional[str] = None

    def __post_init__(self):
        if self.enable_kv_spill:
            raise _not_ported("the KV spill tier (enable_kv_spill)", "A9")


@dataclass
class RaggedInferenceEngineConfig:
    state_manager: DSStateManagerConfig = field(
        default_factory=DSStateManagerConfig)
    tensor_parallel_size: int = 1
    expert_parallel_size: int = 1
    dtype: str = "bfloat16"
    prefill_bucket: int = 64                 # prompt lengths pad to multiples
    # hand-written paged/ragged attention kernels; False selects their
    # plain PyTorch versions (for comparison, never as a fallback)
    use_paged_kernel: bool = True
    # weight-only quantization (0 = off): weights rest as int8 / packed
    # int4 with per-block f32 scales, dequantized right before use
    quant_bits: int = 0
    # int8 KV pool with per-(block, kv head) f32 scales: ~2x the tokens
    # in the same device memory
    kv_quant: bool = False
    # fused multi-token decode: K decode steps per window with one [N, K]
    # device-to-host transfer; 1 = per-token decode
    decode_window: int = 8
    # "auto"/"on": every put() runs as one ragged step; "off" (the
    # stitched prefill/continue/decode dispatch) is not ported
    ragged_attention: str = "auto"
    max_lora_adapters: int = 0
    lora_rank: int = 8
    spec_mode: str = "auto"
    seed: int = 0

    def __post_init__(self):
        # serving geometry knobs are registered tunables
        # (runtime/tunables.py): validate against the documented range
        # and publish the effective value + provenance for /statusz
        from ...runtime import tunables
        for key, name in (("decode_window", "serving.decode_window"),
                          ("prefill_bucket", "serving.prefill_bucket")):
            tunables.check(name, getattr(self, key), label=key)
            tunables.observe(name, getattr(self, key), "config")
        if self.spec_mode not in ("auto", "ngram", "draft"):
            raise ValueError(
                f"spec_mode must be 'auto', 'ngram' or 'draft', got "
                f"{self.spec_mode!r}")
        check_ragged_mode(self.ragged_attention)
        if self.max_lora_adapters < 0:
            raise ValueError("max_lora_adapters must be >= 0")
        if self.quant_bits and (self.tensor_parallel_size != 1
                                or self.expert_parallel_size != 1):
            raise ValueError(
                "quant_bits requires tensor_parallel_size == "
                "expert_parallel_size == 1 (shardings are declared "
                "against dense leaves)")
        if self.max_lora_adapters:
            raise _not_ported("the LoRA adapter bank (max_lora_adapters)",
                              "A11")
        if self.tensor_parallel_size != 1 or self.expert_parallel_size != 1:
            raise _not_ported("tensor/expert-parallel serving", "A8")

    @classmethod
    def from_dict(cls, d: dict) -> "RaggedInferenceEngineConfig":
        d = dict(d or {})
        sm = d.pop("state_manager", {})
        if isinstance(sm, dict):
            sm = DSStateManagerConfig(**sm)
        return cls(state_manager=sm, **d)
