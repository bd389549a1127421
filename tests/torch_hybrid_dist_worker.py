"""Rank body of the expert-parallel hybrid-engine test
(``tests/test_torch_hybrid_engine.py::test_hybrid_engine_moe_expert_parallel``).

Runs in processes started by ``torch.multiprocessing.spawn`` and imports
only the port (no ``jax``): each rank of a world-2 gloo group builds the
hybrid engine (ep 2, ZeRO 2) from the inputs the test wrote (``inputs.pt``:
numpy weights and one batch), takes one train step, publishes (the expert
leaves gathered over the expert ranks) and generates on its colocated tp 1 /
ep 1 serving engine, then writes what it saw to ``rank<r>.pt``.
"""

import os

import numpy as np
import torch

WORLD = 2
# the JAX hybrid-engine tests' model (tests/unit/runtime/
# test_hybrid_engine.py ``_cfg``); fp32
CFG = dict(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=2,
           num_heads=4, max_seq_len=64, remat=False, use_flash=False)
MOE_CFG = dict(CFG, moe_num_experts=4, moe_capacity_factor=2.0)
PROMPT = [[3, 5, 7]]
NEW = 4


def train_config(moe: bool = False) -> dict:
    cfg = {
        "train_micro_batch_size_per_gpu": 2,
        "gradient_accumulation_steps": 1,
        "optimizer": {"type": "adamw", "params": {"lr": 1e-2}},
        "zero_optimization": {"stage": 2},
        "hybrid_engine": {"enabled": True, "max_out_tokens": 64},
        "steps_per_print": 10 ** 9,
        "telemetry": {"enabled": False},
    }
    if moe:
        cfg["moe"] = {"enabled": True, "num_experts": 4,
                      "expert_parallel_size": 2}
    return cfg


def moe_batch(seq: int = 16) -> dict:
    """The global batch [gas 1, micro 2 x world, seq]."""
    rng = np.random.default_rng(0)
    return {"input_ids": rng.integers(0, 64, (1, 2 * WORLD, seq),
                                      dtype=np.int64)}


def run(rank, world, port, workdir):
    os.environ.update({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                       "RANK": str(rank), "WORLD_SIZE": str(world),
                       "LOCAL_RANK": str(rank)})
    for k in ("DS_TPU_COORDINATOR", "DS_TPU_NUM_PROCESSES",
              "DS_TPU_PROCESS_ID"):
        os.environ.pop(k, None)
    torch.set_num_threads(2)
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.checkpoint.interop import params_from_numpy
    from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM
    from deepspeed_tpu_torch.runtime.hybrid_engine import \
        DeepSpeedHybridEngine

    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=TransformerLM(TransformerConfig(**MOE_CFG)),
        config=train_config(moe=True), device="cpu",
        params=params_from_numpy(inp["weights"]))
    out = {"hybrid": isinstance(eng, DeepSpeedHybridEngine),
           "local_experts": int(eng.params["layers"]["e_up"].shape[1])}
    out["loss"] = float(eng.train_batch(batch=inp["batch"]))
    out["generated"] = eng.generate(np.array(PROMPT), max_new_tokens=NEW)
    out["weight_version"] = eng.weight_version
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
