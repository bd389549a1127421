"""deepspeed_tpu_torch.comm — collectives over torch.distributed.

Port of ``deepspeed_tpu/comm`` (the reference's ``deepspeed.comm``):
the same public surface, on NCCL on the card and gloo on the CPU.
"""

from .comm import (  # noqa: F401
    ReduceOp,
    all_gather_into_tensor,
    all_reduce,
    all_to_all,
    all_to_all_single,
    allgather_fn,
    axis_rank,
    axis_size,
    barrier,
    broadcast,
    configure,
    destroy_process_group,
    get_backend,
    get_comms_logger,
    get_device_count,
    get_local_rank,
    get_rank,
    get_world_size,
    has_all_gather_into_tensor,
    has_reduce_scatter_tensor,
    inference_all_reduce,
    init_distributed,
    is_initialized,
    log_summary,
    permute,
    recv_prev,
    reduce_scatter_fn,
    reduce_scatter_tensor,
    resolve_group,
    send_next,
    send_prev,
    timed_op,
    tp_copy,
    tp_reduce,
)
