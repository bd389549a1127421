"""Pipeline parallelism (JAX ``deepspeed_tpu/runtime/pipe``; reference
deepspeed/pipe facade + runtime/pipe)."""

from .module import (LayerSpec, PipelineModule,  # noqa: F401
                     TiedLayerSpec, partition_balanced)
from .pipeline import (broadcast_from_last, pipeline_1f1b,  # noqa: F401
                       pipeline_scan, stage_index, tick_table)
