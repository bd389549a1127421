"""deepspeed_tpu_torch — the PyTorch/CUDA port of deepspeed_tpu.

The port mirrors the JAX package's paths (``deepspeed_tpu/x/y.py`` ->
``deepspeed_tpu_torch/x/y.py``) and keeps its parameter-tree layout, so
weights move between the two by name. It imports neither ``jax`` nor
anything of ``deepspeed_tpu``. Its kernels are hand-written for Hopper
(``csrc/``) and built at first use (``ops/op_builder/cuda.py``).

This slice serves: ``pipeline()`` / ``init_inference(use_ragged=True)``
over the ragged v2 engine (``inference/v2``). Entry points run on the GPU
unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from .pipeline import ServePipeline, pipeline  # noqa: F401


def init_inference(model=None, config=None, params=None, device=None,
                   **kwargs):
    """Inference engine entry (reference deepspeed/__init__.py:269).

    ``use_ragged=True`` builds the ragged v2 engine
    (:class:`~.inference.v2.engine_v2.InferenceEngineV2`) for a native
    ``TransformerLM``; ``params`` supplies trained weights (a tree of
    tensors or arrays in the JAX package's layout). The v1 engine, HF
    modules and ``checkpoint`` loading are not ported yet."""
    from .inference.config import DeepSpeedInferenceConfig

    cfg = DeepSpeedInferenceConfig.from_dict_or_kwargs(config, kwargs)
    if not cfg.use_ragged:
        raise NotImplementedError(
            "only the ragged v2 engine (use_ragged=True) is ported to "
            "deepspeed_tpu_torch yet")
    if cfg.checkpoint:
        raise NotImplementedError(
            "use_ragged=True does not take 'checkpoint' yet; pass params")
    from .inference.v2 import InferenceEngineV2, RaggedInferenceEngineConfig
    rdict = dict(cfg.ragged or {})
    rdict.setdefault("dtype", cfg.dtype)
    rdict.setdefault("tensor_parallel_size", cfg.tensor_parallel.tp_size)
    if cfg.quant_bits:
        rdict.setdefault("quant_bits", cfg.quant_bits)
    return InferenceEngineV2(model,
                             RaggedInferenceEngineConfig.from_dict(rdict),
                             params=params, device=device)
