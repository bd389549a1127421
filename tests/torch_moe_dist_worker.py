"""Rank body of the multi-rank MoE tests (``tests/test_torch_moe_distributed.py``).

Runs in processes started by ``torch.multiprocessing.spawn`` and imports only
the port (no ``jax``): it trains ``deepspeed_tpu_torch`` MoE engines at world
2 over gloo on the inputs the test wrote (``inputs.pt``: numpy weights and
batches), runs the safe-mode sweep on the expert-parallel engines and
writes what each rank saw to ``rank<r>.pt``.
"""

import os

import numpy as np
import torch

MOE_SMALL = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                 num_layers=2, num_heads=4, max_seq_len=64, use_flash=False,
                 moe_num_experts=4, moe_top_k=2, moe_capacity_factor=1.0)
STEPS = 3
# name -> (model overrides, ZeRO stage, expert_parallel_size)
CASES = {"dp2": ({}, 1, 1), "ep2_z1": ({}, 1, 2), "ep2_z3": ({}, 3, 2),
         "ep2_dropless": (dict(moe_top_k=1, moe_dropless=True), 1, 2)}


def train_config(stage, ep, micro=2, gas=2):
    return {
        "train_micro_batch_size_per_gpu": micro,
        "gradient_accumulation_steps": gas,
        "optimizer": {"type": "adamw",
                      "params": {"lr": 1e-3, "weight_decay": 0.01}},
        "gradient_clipping": 1.0,
        "zero_optimization": {"stage": stage,
                              "stage3_param_persistence_threshold": 0},
        "moe": {"enabled": True, "num_experts": 4,
                "expert_parallel_size": ep},
        "steps_per_print": 10 ** 9,
        "telemetry": {"enabled": False},
    }


def model_cfg(name):
    return dict(MOE_SMALL, **CASES[name][0])


def engine(name, weights, micro=2):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.checkpoint.interop import params_from_numpy
    from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM

    _, stage, ep = CASES[name]
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=TransformerLM(TransformerConfig(**model_cfg(name))),
        config=train_config(stage, ep, micro=micro), device="cpu",
        params=weights)
    return eng


def full_params(eng):
    """The whole f32 master params (every rank takes part in the gather)."""
    from deepspeed_tpu_torch.checkpoint import state_checkpoint as ckpt

    tree = eng._train_state()["master_params"]
    return {k: v.detach().float().numpy().copy()
            for k, v in ckpt.leaf_paths(tree)}


def run(rank, world, port, workdir):
    os.environ.update({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                       "RANK": str(rank), "WORLD_SIZE": str(world),
                       "LOCAL_RANK": str(rank)})
    for k in ("DS_TPU_COORDINATOR", "DS_TPU_NUM_PROCESSES",
              "DS_TPU_PROCESS_ID"):
        os.environ.pop(k, None)
    torch.set_num_threads(2)
    from deepspeed_tpu_torch.checkpoint.interop import params_from_numpy
    from deepspeed_tpu_torch.moe import sharded_moe
    from deepspeed_tpu_torch.utils.sanity import check_engine_sanity

    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    out = {}
    # count the (token, choice) pairs the capacity drops on this rank
    dropped = [0]
    route = sharded_moe._route_top2

    def counting(*args, **kwargs):
        r = route(*args, **kwargs)
        dropped[0] += int((~r.keep).sum())
        return r

    sharded_moe._route_top2 = counting
    for name in CASES:
        dropped[0] = 0
        eng = engine(name, params_from_numpy(inp["weights"][name]))
        out[f"losses_{name}"] = [eng.train_batch(batch=b)
                                 for b in inp["batches"][:STEPS]]
        out[f"params_{name}"] = full_params(eng)
        out[f"dropped_{name}"] = dropped[0]
        out[f"local_e_up_{name}"] = tuple(
            eng.params["layers"]["e_up"].shape)
        if CASES[name][2] > 1:
            # the safe-mode sweep holds each rank's experts against the
            # ranks holding the same experts only
            out[f"sanity_{name}"] = check_engine_sanity(
                eng, raise_on_error=False)
        if name == "ep2_z1":
            eng.save_checkpoint(os.path.join(workdir, "ck_ep2"), tag="t")
            if rank == 1:
                with torch.no_grad():
                    eng.params["final_norm"].add_(1.0)
            out["sanity_desync_ep2"] = check_engine_sanity(
                eng, raise_on_error=False)
        eng.close()
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
