"""deepspeed_tpu_torch — the PyTorch/CUDA port of deepspeed_tpu.

The port mirrors the JAX package's paths (``deepspeed_tpu/x/y.py`` ->
``deepspeed_tpu_torch/x/y.py``) and keeps its parameter-tree layout, so
weights move between the two by name. It imports neither ``jax`` nor
anything of ``deepspeed_tpu``. Its kernels are hand-written for Hopper
(``csrc/``) and built at first use (``ops/op_builder/cuda.py``).

It serves: ``pipeline()`` / ``init_inference(use_ragged=True)`` over the
ragged v2 engine (``inference/v2``, with the int8 KV pool under
``kv_quant``), and plain ``init_inference()`` over the v1 dense-cache
engine (``inference/engine.py``); under ``quant_bits`` 8 or 4 both keep
their weights quantized (``inference/quantization.py``); the v1 engine
also loads its weights from a training checkpoint
(``init_inference(checkpoint=...)``). It trains: ``initialize()`` returns
the :class:`~.runtime.engine.DeepSpeedTpuEngine`, data parallel over
``torch.distributed`` at ZeRO stages 0-3 (``comm/``,
``parallel/topology.py``, ``runtime/zero/partition.py``, bucketed
gradient reduction in ``runtime/grad_overlap.py``; ranks started by
``launcher/launch.py``, fed by ``runtime/dataloader.py``; NCCL on the
card, gloo on the CPU), whose ``train_batch()`` runs the flash-attention
kernels forward and backward. At one rank its optimizer state may live
on the card, in page-locked host memory with the update streamed through
the card (``offload_optimizer {device: cpu, pin_memory: true}``,
``runtime/offload.py``), or with the host C++ optimizer in host memory or
in swap files (``{device: cpu}`` / ``{device: nvme}``,
``runtime/zero/offload.py``, ``ops/cpu_optimizers.py``, ``ops/aio.py``,
sources in ``csrc/host/`` built by ``g++`` at first use).
``save_checkpoint`` / ``load_checkpoint`` write and read the JAX package's
checkpoint format (``checkpoint/state_checkpoint.py``,
``utils/zero_to_fp32.py``) at any data-parallel world. Still raising:
optimizer offload at more than one rank and ``offload_param`` (ROADMAP
A9), tensor / sequence / pipeline / expert parallelism (A8), ZeRO++
(A10), universal checkpoints and
``init_inference(use_ragged=True, checkpoint=...)`` (A5). Entry points run
on the GPU unless the caller passes ``device="cpu"``.

It serves online too: ``inference/v2/serve`` is the JAX package's
single-replica serving runtime — ``ServingEngine`` (streaming
``submit()`` with deadlines and cancellation that frees KV blocks),
admission control (bounded queue, token budget, tenant fairness), the
continuous-batching loop thread and ``ServingAPI``, the HTTP surface
(NDJSON ``/generate``, ``/healthz``, Prometheus ``/metrics``,
``/statusz``, ``/debug/timeline``, ``/debug/postmortem``; overload is a
429). ``telemetry/`` is the JAX package's metrics registry, spans, flight
recorder, anomaly detectors and post-mortem bundles, and ``generate()``
samples (temperature / top-p / top-k) on the device. The fleet tier
(router, replicas, KV handoff, weight pushes) is ROADMAP A7, the online
adapter A12, speculation and LoRA A11.
"""

__version__ = "0.1.0"

from typing import Any, Optional, Tuple

from .pipeline import ServePipeline, pipeline  # noqa: F401
from .runtime.config import DeepSpeedConfig  # noqa: F401
from .runtime.engine import DeepSpeedTpuEngine  # noqa: F401
from .runtime.lr_schedules import LRScheduler  # noqa: F401


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None,
               distributed_port: int = 29500, mpu=None,
               dist_init_required: Optional[bool] = None, collate_fn=None,
               config=None, config_params=None, seed: int = 0,
               topology=None, params=None, device=None,
               ) -> Tuple[DeepSpeedTpuEngine, Any, Any, Any]:
    """Initialize the training engine (reference deepspeed/__init__.py:64,
    JAX ``deepspeed_tpu.initialize``).

    Starts the process group first (``comm.init_distributed``, JAX
    :58): the launcher's ranks, or one rank on a free local port; on
    ``nccl`` for the card and ``gloo`` for ``device="cpu"``. Returns
    ``(engine, optimizer, training_dataloader, lr_scheduler)``; the
    dataloader is a :class:`~.runtime.dataloader.DeepSpeedDataLoader` of
    ``training_data`` (global micro-batches, which the engine cuts by
    rank; the engine draws from it when ``train_batch()`` gets no batch),
    or None. ``model`` exposes ``init_params(generator, dtype)`` and
    ``apply(params, batch, train=...)``; ``params`` (the JAX tree layout,
    the same on every rank) replaces its seeded init. ``device=None``
    trains on the GPU and raises without one. As in the JAX function,
    ``optimizer``, ``model_parameters``, ``mpu`` and
    ``dist_init_required`` are accepted and not read (the optimizer comes
    from the config)."""
    from .comm import comm
    from .runtime.dataloader import DeepSpeedDataLoader, RepeatingLoader
    from .utils.device import resolve_device

    config = config if config is not None else config_params
    if config is None and args is not None and hasattr(args, "deepspeed_config"):
        config = args.deepspeed_config
    if config is None:
        raise ValueError("a config (dict or json path) is required")
    on_cpu = resolve_device(device).type == "cpu"
    comm.init_distributed(dist_backend="gloo" if on_cpu else None,
                          distributed_port=distributed_port)
    ds_config = DeepSpeedConfig(config, world_size=comm.get_world_size())
    dataloader = None
    if training_data is not None:
        dataloader = DeepSpeedDataLoader(
            training_data,
            micro_batch_size=ds_config.train_micro_batch_size_per_gpu,
            dp_world_size=ds_config.dp_world_size,
            collate_fn=collate_fn)
    engine = DeepSpeedTpuEngine(
        model, ds_config, params=params, device=device, seed=seed,
        lr_scheduler=lr_scheduler, topology=topology,
        dataloader=RepeatingLoader(dataloader) if dataloader else None)
    return engine, engine.optimizer, dataloader, engine.lr_scheduler


def init_distributed(dist_backend: Optional[str] = None, **kwargs):
    """Reference deepspeed/__init__.py init_distributed passthrough."""
    from .comm import comm
    return comm.init_distributed(dist_backend=dist_backend, **kwargs)


def init_inference(model=None, config=None, params=None, device=None,
                   **kwargs):
    """Inference engine entry (reference deepspeed/__init__.py:269).

    Returns the v1 dense-cache engine
    (:class:`~.inference.engine.InferenceEngine`) for a native
    ``TransformerLM``, or with ``use_ragged=True`` the ragged v2 engine
    (:class:`~.inference.v2.engine_v2.InferenceEngineV2`). ``params``
    supplies trained weights (a tree of tensors or arrays in the JAX
    package's layout); for the v1 engine ``checkpoint=`` (a training
    checkpoint directory) does. HF modules, and ``checkpoint`` with
    ``use_ragged=True`` (as in the JAX package), are not ported yet."""
    from .inference.config import DeepSpeedInferenceConfig

    cfg = DeepSpeedInferenceConfig.from_dict_or_kwargs(config, kwargs)
    if not cfg.use_ragged:
        from .inference.engine import InferenceEngine
        return InferenceEngine(model, cfg, params=params, device=device)
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
