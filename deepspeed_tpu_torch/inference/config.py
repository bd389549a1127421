"""Inference config for ``init_inference``.

Port of ``deepspeed_tpu/inference/config.py`` (reference
``DeepSpeedInferenceConfig``): the same legacy aliases and dtype names, and
the fields the v1 engine (``inference/engine.py``) and the ragged v2
engine (``use_ragged=True``) read, with the JAX defaults. Keys that nothing
reads yet (``enable_cuda_graph``, ``replace_with_kernel_inject``, ROADMAP
A6e) take the unknown-key warning.
"""

import logging
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

logger = logging.getLogger(__name__)


@dataclass
class TensorParallelConfig:
    tp_size: int = 1


@dataclass
class DeepSpeedInferenceConfig:
    dtype: str = "bfloat16"
    tensor_parallel: TensorParallelConfig = field(
        default_factory=TensorParallelConfig)
    max_out_tokens: int = 1024          # prompt + new tokens per generate()
    min_out_tokens: int = 1
    max_batch_size: int = 8
    checkpoint: Optional[str] = None
    quant_bits: Optional[int] = None
    seed: int = 0                       # seeded weights when none are given
    use_ragged: bool = False
    ragged: Optional[Dict[str, Any]] = None  # RaggedInferenceEngineConfig

    @classmethod
    def from_dict_or_kwargs(cls, config: Optional[Dict[str, Any]], kwargs):
        merged: Dict[str, Any] = dict(config or {})
        merged.update({k: v for k, v in kwargs.items() if v is not None})
        tp = merged.pop("tensor_parallel", {})
        if isinstance(tp, int):
            tp = {"tp_size": tp}
        if "mp_size" in merged:              # reference legacy alias
            tp = {"tp_size": merged.pop("mp_size")}
        known = {f for f in cls.__dataclass_fields__
                 if f != "tensor_parallel"}
        unknown = set(merged) - known
        if unknown:
            logger.warning(
                f"init_inference: ignoring unknown config keys "
                f"{sorted(unknown)} (known: "
                f"{sorted(known | {'tensor_parallel', 'mp_size'})})")
        cfg = cls(**{k: v for k, v in merged.items() if k in known})
        cfg.tensor_parallel = (TensorParallelConfig(**tp)
                               if isinstance(tp, dict) else tp)
        aliases = {"fp32": "float32", "float": "float32",
                   "float32": "float32", "fp16": "float16",
                   "half": "float16", "float16": "float16",
                   "bf16": "bfloat16", "bfloat16": "bfloat16"}
        key = str(cfg.dtype).replace("torch.", "")
        if key not in aliases:
            raise ValueError(
                f"unsupported inference dtype {cfg.dtype!r}; one of "
                f"{sorted(set(aliases))}")
        cfg.dtype = aliases[key]
        return cfg
