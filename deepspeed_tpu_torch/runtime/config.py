"""JSON config system.

Port of ``deepspeed_tpu/runtime/config.py``: the same dataclass schema and
the same :class:`DeepSpeedConfig`, so one dict hydrates to the same values
and raises the same :class:`ConfigError`\\ s in both packages (unknown keys,
the batch triple ``train = micro x gas x dp``, the ZeRO stage range, the
cross-block rejects). The data-parallel world is ``world_size // (tp * pp
* sp)``; ``world_size`` defaults to 1 (``initialize()`` passes the
process group's).

What the schema accepts is more than this slice runs. :func:`check_ported`
raises ``NotImplementedError``, naming its ROADMAP item, for every key set
to a value the port does not implement yet; the engine calls it, so no key
is silently ignored.
"""

import json
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

from . import tunables
from .config_utils import AUTO, ConfigError, as_dict, hydrate, subconfig


@dataclass
class FP16Config:
    """Reference: runtime/fp16 loss-scaling config block."""

    enabled: bool = False
    auto_cast: bool = False
    loss_scale: float = 0.0  # 0 => dynamic
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    consecutive_hysteresis: bool = False
    min_loss_scale: float = 1.0


@dataclass
class BF16Config:
    enabled: bool = False


@dataclass
class OffloadConfig:
    """Reference: runtime/zero/offload_config.py (device: cpu|nvme)."""

    device: str = "none"
    nvme_path: Optional[str] = None
    pin_memory: bool = False
    buffer_count: int = 4
    buffer_size: int = 100_000_000
    pipeline_read: bool = False
    pipeline_write: bool = False
    fast_init: bool = False
    ratio: float = 1.0

    def __post_init__(self):
        if self.device not in ("none", "cpu", "nvme"):
            raise ConfigError(
                f"offload device must be 'cpu' or 'nvme' (or 'none'), "
                f"got {self.device!r}")
        if self.device == "nvme" and not self.nvme_path:
            raise ConfigError(
                "offload device 'nvme' requires nvme_path")
        if self.buffer_count < 1:
            raise ConfigError(
                f"offload buffer_count must be >= 1, got "
                f"{self.buffer_count}")
        if self.buffer_size <= 0:
            raise ConfigError(
                f"offload buffer_size must be > 0, got "
                f"{self.buffer_size}")
        if not 0.0 < self.ratio <= 1.0:
            raise ConfigError(
                f"offload ratio must be in (0, 1], got {self.ratio}")


@dataclass
class ZeroConfig:
    """Reference: runtime/zero/config.py:81 DeepSpeedZeroConfig."""

    stage: int = 0
    contiguous_gradients: bool = True
    reduce_scatter: bool = True
    reduce_bucket_size: int = 500_000_000
    allgather_partitions: bool = True
    allgather_bucket_size: int = 500_000_000
    overlap_comm: bool = True
    overlap_grad_reduce: str = "auto"
    offload_optimizer: OffloadConfig = subconfig(OffloadConfig)
    offload_param: OffloadConfig = subconfig(OffloadConfig)
    sub_group_size: int = 1_000_000_000
    stage3_max_live_parameters: int = 1_000_000_000
    stage3_max_reuse_distance: int = 1_000_000_000
    stage3_prefetch_bucket_size: int = 50_000_000
    stage3_param_persistence_threshold: int = 100_000
    stage3_gather_16bit_weights_on_model_save: bool = False
    ignore_unused_parameters: bool = True
    round_robin_gradients: bool = False
    zero_hpz_partition_size: int = 1
    zero_quantized_weights: bool = False
    zero_quantized_gradients: bool = False
    quantized_reduce: str = "off"   # off | int8 | fp8
    quant_block: int = 2048
    quantized_reduce_hierarchy: int = 0
    mics_shard_size: int = -1
    mics_hierarchical_params_gather: bool = False

    def __post_init__(self):
        if self.stage not in (0, 1, 2, 3):
            raise ConfigError(f"zero_optimization.stage must be 0-3, got {self.stage}")
        for key in ("reduce_bucket_size", "allgather_bucket_size",
                    "stage3_prefetch_bucket_size"):
            tunables.check(f"zero_optimization.{key}",
                           getattr(self, key), exc=ConfigError)
        if self.overlap_grad_reduce not in ("auto", "bucketed", "off"):
            raise ConfigError(
                "zero_optimization.overlap_grad_reduce must be one of "
                f"'auto'|'bucketed'|'off', got {self.overlap_grad_reduce!r}")
        if self.quantized_reduce not in ("off", "int8", "fp8"):
            raise ConfigError(
                "zero_optimization.quantized_reduce must be one of "
                f"'off'|'int8'|'fp8', got {self.quantized_reduce!r}")
        tunables.check("zero_optimization.quant_block", self.quant_block,
                       exc=ConfigError)
        if self.quantized_reduce_hierarchy < 0:
            raise ConfigError(
                "zero_optimization.quantized_reduce_hierarchy must be "
                f">= 0 (a host count, 0/1 = flat), got "
                f"{self.quantized_reduce_hierarchy}")
        if (self.quantized_reduce_hierarchy > 1
                and self.quantized_reduce == "off"):
            raise ConfigError(
                "zero_optimization.quantized_reduce_hierarchy shapes "
                "the quantized ring — set quantized_reduce to "
                "'int8'|'fp8' (or drop the hierarchy knob)")
        if self.quantized_reduce != "off":
            if self.stage == 3:
                raise ConfigError(
                    "zero_optimization.quantized_reduce targets stages 0-2 "
                    "(stage-3 gradients reduce inside the parameter "
                    "gather's VJP; use zero_quantized_gradients for the "
                    "qgZ int8 all-to-all there)")
            if self.zero_quantized_gradients:
                raise ConfigError(
                    "quantized_reduce and zero_quantized_gradients both "
                    "quantize the gradient exchange — pick one transport")
        offloaded = (self.offload_optimizer.device != "none"
                     or self.offload_param.device != "none")
        if self.quantized_reduce != "off" and offloaded:
            raise ConfigError(
                "zero_optimization.quantized_reduce requires the "
                "standard jitted step: ZeRO-Offload / ZeRO-Infinity "
                "keep their own gradient transports")
        if self.offload_optimizer.pin_memory:
            if self.offload_optimizer.device == "nvme":
                raise ConfigError(
                    "offload_optimizer.pin_memory selects the tiered "
                    "HOST-RAM tier and composes with device 'cpu' only; "
                    "'nvme' runs the AIO-swapped host optimizer "
                    "(drop pin_memory or set device: cpu)")
            if (self.offload_optimizer.device == "cpu"
                    and self.stage not in (1, 2)):
                raise ConfigError(
                    "tiered optimizer offload (offload_optimizer "
                    "{device: cpu, pin_memory: true}) targets ZeRO "
                    f"stages 1/2 (got stage {self.stage}); stage-3 "
                    "state already shards via the parameter plan, "
                    "stage 0 has no sharded optimizer tier")
            if (self.offload_optimizer.device == "cpu"
                    and (self.zero_quantized_gradients
                         or self.zero_quantized_weights)):
                raise ConfigError(
                    "tiered optimizer offload does not compose with "
                    "ZeRO++ quantized gradients/weights (the streamed "
                    "update rides the plain bucketed grad program)")
        if self.zero_hpz_partition_size > 1 and self.stage != 3:
            raise ConfigError(
                f"zero_hpz_partition_size={self.zero_hpz_partition_size} "
                f"requires zero stage 3 (got stage {self.stage})")
        if self.zero_hpz_partition_size > 1 and self.mics_shard_size > 1:
            raise ConfigError(
                "zero_hpz_partition_size and mics_shard_size cannot be "
                "combined: both partition over the shard sub-axis with "
                "opposite replication semantics")


@dataclass
class OptimizerConfig:
    type: str = "adamw"
    params: Dict[str, Any] = field(default_factory=dict)


@dataclass
class SchedulerConfig:
    type: Optional[str] = None
    params: Dict[str, Any] = field(default_factory=dict)


@dataclass
class PipelineConfig:
    """Pipeline-parallel block (reference: PipelineModule kwargs)."""

    stages: int = 1
    partition_method: str = "parameters"
    seed_layers: bool = False
    activation_checkpoint_interval: int = 0
    pipe_partitioned: bool = True
    grad_partitioned: bool = True
    num_microbatches: Optional[int] = None


@dataclass
class ActivationCheckpointingConfig:
    """Reference: activation_checkpointing/checkpointing.py:1057 configure()."""

    partition_activations: bool = False
    cpu_checkpointing: bool = False
    contiguous_memory_optimization: bool = False
    number_checkpoints: Optional[int] = None
    synchronize_checkpoint_boundary: bool = False
    profile: bool = False
    policy: str = "nothing_saveable"


@dataclass
class CommsLoggerConfig:
    enabled: bool = False
    verbose: bool = False
    prof_all: bool = True
    debug: bool = False
    prof_ops: List[str] = field(default_factory=list)


@dataclass
class FlopsProfilerConfig:
    enabled: bool = False
    profile_step: int = 1
    module_depth: int = -1
    top_modules: int = 1
    detailed: bool = True
    output_file: Optional[str] = None


@dataclass
class TensorboardConfig:
    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedTpuJobName"


@dataclass
class WandbConfig:
    enabled: bool = False
    group: Optional[str] = None
    team: Optional[str] = None
    project: str = "deepspeed_tpu"


@dataclass
class CSVConfig:
    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedTpuJobName"


@dataclass
class DiagnosticsConfig:
    """The ``diagnostics`` block (copy of the JAX package's schema,
    ``telemetry/anomaly.py``): flight recorder, anomaly detector and
    post-mortem knobs. The port has no diagnostics yet (ROADMAP A7)."""

    enabled: bool = True
    recorder_max_bytes: int = 2 << 20
    loss_window: int = 64
    loss_zscore: float = 8.0
    grad_attribution: bool = True
    attribution_top_k: int = 3
    ttft_slo_s: float = 1.0
    tpot_slo_s: float = 0.25
    slo_target: float = 0.99
    burn_threshold: float = 2.0
    slo_fast_window_s: float = 30.0
    slo_slow_window_s: float = 600.0
    slo_min_samples: int = 50
    stall_enabled: bool = True
    stall_factor: float = 8.0
    stall_min_deadline_s: float = 60.0
    stall_check_interval_s: float = 0.25
    postmortem_dir: str = "postmortems"
    postmortem_on_anomaly: bool = False
    postmortem_on_crash: bool = False
    postmortem_min_interval_s: float = 60.0
    postmortem_last_events: int = 512

    def __post_init__(self):
        if not 0.0 < self.slo_target < 1.0:
            raise ValueError(
                f"diagnostics.slo_target must be in (0, 1), got "
                f"{self.slo_target}")
        if self.slo_fast_window_s > self.slo_slow_window_s:
            raise ValueError(
                "diagnostics.slo_fast_window_s must not exceed "
                "slo_slow_window_s")


@dataclass
class TelemetryConfig:
    enabled: bool = True
    flush_interval: int = 10
    xla_annotations: bool = False


@dataclass
class DataTypesConfig:
    grad_accum_dtype: Optional[str] = None


@dataclass
class CheckpointConfig:
    tag_validation: str = "Warn"  # Ignore | Warn | Fail
    load_universal: bool = False
    use_node_local_storage: bool = False
    parallel_write: Dict[str, Any] = field(default_factory=dict)
    async_save: bool = False


@dataclass
class AioConfig:
    block_size: int = 1_048_576
    queue_depth: int = 8
    thread_count: int = 1
    single_submit: bool = False
    overlap_events: bool = True


@dataclass
class MoEConfig:
    enabled: bool = False
    num_experts: int = 1
    expert_parallel_size: int = 1
    capacity_factor: float = 1.0
    eval_capacity_factor: float = 1.0
    min_capacity: int = 4
    top_k: int = 1
    noisy_gate_policy: Optional[str] = None
    drop_tokens: bool = True
    use_residual: bool = False


@dataclass
class EigenvalueConfig:
    enabled: bool = False
    verbose: bool = False
    max_iter: int = 100
    tol: float = 1e-2
    stability: float = 1e-6
    gas_boundary_resolution: int = 1
    layer_name: str = "bert.encoder.layer"
    layer_num: int = 0


@dataclass
class PLDConfig:
    enabled: bool = False
    theta: float = 1.0
    gamma: float = 0.001


@dataclass
class ElasticityConfig:
    enabled: bool = False
    max_train_batch_size: int = 2000
    micro_batch_sizes: List[int] = field(default_factory=lambda: [2, 4, 6])
    min_gpus: int = 1
    max_gpus: int = 10000
    min_time: int = 0
    prefer_larger_batch: bool = True
    ignore_non_elastic_batch_info: bool = False
    version: float = 0.1


@dataclass
class HybridEngineConfig:
    enabled: bool = False
    max_out_tokens: int = 512
    inference_tp_size: int = 1
    release_inference_cache: bool = False
    pin_parameters: bool = True
    tp_gather_partition_size: int = 8
    publish_bucket_bytes: int = 16 << 20
    rollout_queue_size: int = 64
    delta_publish: bool = True
    delta_quant: str = "int8"
    delta_block: int = 2048
    serving: Dict[str, Any] = field(default_factory=dict)


@dataclass
class DeepSpeedTpuConfig:
    """Top-level typed view of the JSON config (reference key names)."""

    train_batch_size: Optional[Union[int, str]] = None
    train_micro_batch_size_per_gpu: Optional[Union[int, str]] = None
    gradient_accumulation_steps: Optional[Union[int, str]] = None
    steps_per_print: int = 10
    wall_clock_breakdown: bool = False
    dump_state: bool = False
    prescale_gradients: bool = False
    gradient_predivide_factor: float = 1.0
    gradient_clipping: float = 0.0
    sparse_gradients: bool = False
    memory_breakdown: bool = False
    disable_allgather: bool = False

    optimizer: Optional[OptimizerConfig] = None
    scheduler: Optional[SchedulerConfig] = None
    fp16: FP16Config = subconfig(FP16Config)
    bf16: BF16Config = subconfig(BF16Config)
    zero_optimization: ZeroConfig = subconfig(ZeroConfig)
    pipeline: PipelineConfig = subconfig(PipelineConfig)
    activation_checkpointing: ActivationCheckpointingConfig = subconfig(ActivationCheckpointingConfig)
    comms_logger: CommsLoggerConfig = subconfig(CommsLoggerConfig)
    flops_profiler: FlopsProfilerConfig = subconfig(FlopsProfilerConfig)
    tensorboard: TensorboardConfig = subconfig(TensorboardConfig)
    wandb: WandbConfig = subconfig(WandbConfig)
    csv_monitor: CSVConfig = subconfig(CSVConfig)
    telemetry: TelemetryConfig = subconfig(TelemetryConfig)
    diagnostics: DiagnosticsConfig = subconfig(DiagnosticsConfig)
    data_types: DataTypesConfig = subconfig(DataTypesConfig)
    checkpoint: CheckpointConfig = subconfig(CheckpointConfig)
    aio: AioConfig = subconfig(AioConfig)
    moe: MoEConfig = subconfig(MoEConfig)
    eigenvalue: EigenvalueConfig = subconfig(EigenvalueConfig)
    progressive_layer_drop: PLDConfig = subconfig(PLDConfig)
    elasticity: ElasticityConfig = subconfig(ElasticityConfig)
    hybrid_engine: HybridEngineConfig = subconfig(HybridEngineConfig)

    tensor_parallel_size: int = 1
    sequence_parallel_size: int = 1

    zero_allow_untested_optimizer: bool = True
    zero_force_ds_cpu_optimizer: bool = False
    communication_data_type: Optional[str] = None
    seq_parallel_communication_data_type: str = "fp32"
    curriculum_learning: Dict[str, Any] = field(default_factory=dict)
    data_efficiency: Dict[str, Any] = field(default_factory=dict)
    compression_training: Dict[str, Any] = field(default_factory=dict)
    autotuning: Dict[str, Any] = field(default_factory=dict)
    train_steps: Optional[int] = None


def _contains_auto(node) -> bool:
    if isinstance(node, str):
        return node == AUTO
    if isinstance(node, (list, tuple)):
        return any(_contains_auto(v) for v in node)
    return False


def _scrub_auto(node):
    """Drop every ``"auto"`` value recursively (a list holding one is auto
    as a whole): a dropped key falls back to the field default."""
    if isinstance(node, dict):
        return {k: _scrub_auto(v) for k, v in node.items()
                if not (isinstance(v, str) and v == AUTO)
                and not (isinstance(v, (list, tuple)) and _contains_auto(v))}
    if isinstance(node, (list, tuple)):
        return type(node)(_scrub_auto(v) for v in node)
    return node


def _coerce_optional_blocks(raw: Dict[str, Any]) -> Dict[str, Any]:
    raw = _scrub_auto(raw)
    for key, cls in (("optimizer", OptimizerConfig), ("scheduler", SchedulerConfig)):
        if isinstance(raw.get(key), dict):
            raw[key] = hydrate(cls, raw[key], path=f"{key}.")
    return raw


# optimizer.type names of the 1-bit family (JAX runtime/fp16/onebit)
_ONEBIT_OPTIMIZERS = ("onebitadam", "1bitadam", "onebitlamb", "1bitlamb",
                      "zerooneadam", "01adam", "zoadam")


def is_onebit_optimizer(name: str) -> bool:
    return name.lower().replace("_", "").replace("-", "") in _ONEBIT_OPTIMIZERS


class DeepSpeedConfig:
    """Parse + validate a config (path or dict) and resolve batch-size math
    (train_batch = micro * gas * dp_world, reference runtime/config.py)."""

    def __init__(self, config: Union[str, Dict[str, Any]], world_size: Optional[int] = None):
        if isinstance(config, str):
            with open(config, "r") as fh:
                raw: Dict[str, Any] = json.load(fh)
        elif isinstance(config, dict):
            raw = config
        else:
            raise ConfigError(f"config must be a path or dict, got {type(config)}")
        self.raw = raw
        self.cfg = hydrate(DeepSpeedTpuConfig, _coerce_optional_blocks(raw))
        self.world_size = 1 if world_size is None else world_size
        mp = self.cfg.tensor_parallel_size * self.cfg.pipeline.stages * self.cfg.sequence_parallel_size
        if self.world_size % mp != 0:
            raise ConfigError(
                f"device count {self.world_size} not divisible by tp*pp*sp={mp}")
        self.dp_world_size = self.world_size // mp
        self._resolve_batch_sizes()
        if self.cfg.zero_optimization.offload_optimizer.device != "none" \
                and self.cfg.optimizer is not None \
                and is_onebit_optimizer(self.cfg.optimizer.type):
            raise ConfigError(
                "offload_optimizer does not compose with 1-bit "
                "optimizers (they own their error-feedback state "
                "and communication); use the standard optimizer "
                "registry or drop the offload block")

    def _resolve_batch_sizes(self):
        c = self.cfg
        tb = None if c.train_batch_size is None else int(c.train_batch_size)
        mb = (None if c.train_micro_batch_size_per_gpu is None
              else int(c.train_micro_batch_size_per_gpu))
        gas = (None if c.gradient_accumulation_steps is None
               else int(c.gradient_accumulation_steps))
        dp = self.dp_world_size
        if tb is not None and mb is not None and gas is None:
            gas, rem = divmod(tb, mb * dp)
            if rem:
                raise ConfigError(
                    f"train_batch_size {tb} not divisible by micro_batch*dp = {mb}*{dp}")
        elif tb is not None and gas is not None and mb is None:
            mb, rem = divmod(tb, gas * dp)
            if rem:
                raise ConfigError(
                    f"train_batch_size {tb} not divisible by gas*dp = {gas}*{dp}")
        elif mb is not None and tb is None:
            gas = gas or 1
            tb = mb * gas * dp
        elif tb is not None and mb is None and gas is None:
            gas = 1
            mb, rem = divmod(tb, dp)
            if rem:
                raise ConfigError(f"train_batch_size {tb} not divisible by dp {dp}")
        elif tb is None and mb is None:
            raise ConfigError(
                "must provide train_batch_size or train_micro_batch_size_per_gpu")
        if tb != mb * gas * dp:
            raise ConfigError(
                f"inconsistent batch config: train_batch_size {tb} != "
                f"micro {mb} * gas {gas} * dp {dp}")
        self.train_batch_size = tb
        self.train_micro_batch_size_per_gpu = mb
        self.gradient_accumulation_steps = gas

    @property
    def zero_stage(self) -> int:
        return self.cfg.zero_optimization.stage

    @property
    def precision_dtype(self) -> str:
        if self.cfg.fp16.enabled and self.cfg.bf16.enabled:
            raise ConfigError("fp16 and bf16 cannot both be enabled")
        if self.cfg.fp16.enabled:
            return "float16"
        if self.cfg.bf16.enabled:
            return "bfloat16"
        return "float32"

    def to_dict(self) -> Dict[str, Any]:
        return as_dict(self.cfg)


# -- what this slice runs ---------------------------------------------------
# keys that run at any value
_PORTED = {
    "train_batch_size", "train_micro_batch_size_per_gpu",
    "gradient_accumulation_steps", "steps_per_print", "gradient_clipping",
    "wall_clock_breakdown", "optimizer", "scheduler", "bf16.enabled",
    "fp16.enabled", "fp16.loss_scale", "fp16.initial_scale_power",
    "fp16.loss_scale_window", "fp16.hysteresis", "fp16.min_loss_scale",
    # optimizer offload (runtime/offload.py, runtime/zero/offload.py)
    "zero_optimization.offload_optimizer.device",
    "zero_optimization.offload_optimizer.nvme_path",
    "zero_optimization.offload_optimizer.pin_memory",
    "zero_optimization.offload_optimizer.buffer_count",
    "zero_optimization.stage3_prefetch_bucket_size",
    "aio.block_size", "aio.thread_count", "checkpoint.async_save",
    # ZeRO over torch.distributed (runtime/zero/partition.py,
    # runtime/grad_overlap.py)
    "zero_optimization.stage", "zero_optimization.reduce_bucket_size",
    "zero_optimization.allgather_bucket_size",
    "zero_optimization.overlap_grad_reduce",
    "zero_optimization.overlap_comm",
    "zero_optimization.stage3_param_persistence_threshold",
}
# keys and the values that run: switching off what the port does not
# have
_PORTED_VALUES = {"telemetry.enabled": (False,),
                  "diagnostics.enabled": (False,),
                  "activation_checkpointing.policy": ("everything_saveable",)}
# keys the JAX package itself leaves inert, by the rationale of its
# dead-key audit (tests/unit/runtime/test_config_keys.py INERT_BY_DESIGN)
_INERT = {
    "allgather_partitions", "contiguous_gradients", "round_robin_gradients",
    "ignore_unused_parameters", "grad_partitioned", "pipe_partitioned",
    "disable_allgather", "prescale_gradients", "gradient_predivide_factor",
    "stage3_max_live_parameters", "stage3_max_reuse_distance",
    "stage3_gather_16bit_weights_on_model_save", "sub_group_size",
    "mics_hierarchical_params_gather", "zero_allow_untested_optimizer",
    "zero_force_ds_cpu_optimizer", "auto_cast", "consecutive_hysteresis",
    "grad_accum_dtype", "communication_data_type",
    "seq_parallel_communication_data_type", "dump_state", "tag_validation",
    "use_node_local_storage", "parallel_write", "train_steps",
    "inference_tp_size", "release_inference_cache",
    "tp_gather_partition_size", "pin_parameters", "fast_init",
    "num_microbatches", "seed_layers", "data_efficiency", "buffer_size",
    "pipeline_read", "pipeline_write", "activation_checkpoint_interval",
    # the AIO thread pool's own knobs (JAX ops/aio.py reads neither)
    "queue_depth", "single_submit", "overlap_events",
}
# everything else, by the ROADMAP item (section A) that ports it; the
# longest matching prefix wins
_ROADMAP = {
    "zero_optimization": "A4 (ZeRO over torch.distributed)",
    "zero_optimization.offload_optimizer": "A9 (memory tiers)",
    "zero_optimization.offload_param": "A9 (memory tiers)",
    "zero_optimization.zero_hpz_partition_size": "A10 (ZeRO++)",
    "zero_optimization.zero_quantized_weights": "A10 (ZeRO++)",
    "zero_optimization.zero_quantized_gradients": "A10 (ZeRO++)",
    "zero_optimization.quantized_reduce": "A10 (quantized communication)",
    "zero_optimization.quantized_reduce_hierarchy":
        "A10 (quantized communication)",
    "zero_optimization.quant_block": "A10 (quantized communication)",
    "aio": "A9 (memory tiers)",
    "pipeline": "A8 (parallel modes)",
    "tensor_parallel_size": "A8 (parallel modes)",
    "sequence_parallel_size": "A8 (parallel modes)",
    "moe": "A8 (parallel modes)",
    "activation_checkpointing": "A3 (remat policies beyond "
                                "nothing_saveable)",
    "activation_checkpointing.cpu_checkpointing": "A9 (memory tiers)",
    "checkpoint": "A5 (checkpoint interop)",
    "telemetry": "A7 (telemetry)",
    "diagnostics": "A7 (telemetry)",
    "hybrid_engine": "A11 (RLHF and hybrid engine)",
}
_ROADMAP_DEFAULT = "A12 (remainder)"


def _leaves(obj, default, path="") -> Iterator[Tuple[str, Any]]:
    """(dotted path, value) of every leaf of ``obj`` that differs from
    ``default``."""
    if is_dataclass(obj) and is_dataclass(default):
        for f in fields(obj):
            yield from _leaves(getattr(obj, f.name), getattr(default, f.name),
                               f"{path}{f.name}.")
    elif obj != default:
        yield path[:-1], obj


def unported_keys(ds_config: DeepSpeedConfig) -> List[Tuple[str, Any, str]]:
    """(key, value, ROADMAP item) of every config key set to a value this
    slice does not run."""
    base = hydrate(DeepSpeedTpuConfig, {})
    out = []
    for path, value in _leaves(ds_config.cfg, base):
        top = path.split(".")[0]
        if (path in _PORTED or top in _PORTED
                or value in _PORTED_VALUES.get(path, ())
                or path.split(".")[-1] in _INERT):
            continue
        item = max((k for k in _ROADMAP
                    if path == k or path.startswith(k + ".")),
                   key=len, default=None)
        out.append((path, value, _ROADMAP[item] if item else _ROADMAP_DEFAULT))
    if ds_config.dp_world_size != 1 and \
            ds_config.cfg.zero_optimization.offload_optimizer.device != "none":
        out.append(("world_size", ds_config.world_size,
                    "A9 (memory tiers: optimizer offload at more than one "
                    "rank)"))
    if ds_config.cfg.optimizer is not None and \
            is_onebit_optimizer(ds_config.cfg.optimizer.type):
        out.append(("optimizer.type", ds_config.cfg.optimizer.type,
                    "A10 (1-bit optimizers)"))
    return out


def check_ported(ds_config: DeepSpeedConfig) -> None:
    """Raise ``NotImplementedError`` naming every key this slice does not
    run, each with its ROADMAP item."""
    bad = unported_keys(ds_config)
    if bad:
        listed = "; ".join(f"'{k}' = {v!r} (ROADMAP {item})"
                           for k, v, item in bad)
        raise NotImplementedError(
            f"config keys not ported to deepspeed_tpu_torch yet: {listed}. "
            f"The port trains data parallel at ZeRO stages 0-3, with "
            f"optimizer offload at one rank")
