"""Rank body of the tensor / sequence / MiCS parallel tests
(``tests/test_torch_tensor_parallel.py``).

Runs in processes started by ``torch.multiprocessing.spawn`` and imports
only the port (no ``jax``): four gloo ranks train ``deepspeed_tpu_torch``
engines on the inputs the test wrote (``inputs.pt``: numpy weights and
batches) at dp 2 x tp 2, tp 2 x sp 2 (Ulysses and ring) and MiCS, run the
v1 and v2 inference engines at tp 2, save and load tensor-parallel
checkpoints and run the safe-mode sweep, and write what each rank saw to
``rank<r>.pt``.
"""

import os

import numpy as np
import torch

FLAGSHIP_SMALL = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
                      num_layers=2, num_heads=8, num_kv_heads=4,
                      max_seq_len=128, flash_min_seq=128)
WORLD, STEPS, MICRO_ROWS = 4, 3, 4     # a global micro-batch of 4 rows

# name -> (ZeRO stage, tp, sp, mics_shard_size, optimizer, model overrides)
CASES = {
    "dp2_tp2_z0": (0, 2, 1, 1, "adamw", {}),
    "dp2_tp2_z3": (3, 2, 1, 1, "adamw", {}),
    "tp2_sp2_ulysses": (3, 2, 2, 1, "adamw", {}),
    "tp2_sp2_ring": (3, 2, 2, 1, "adamw", {"seq_parallel_impl": "ring"}),
    "mics2_z3": (3, 1, 1, 2, "adamw", {}),
    "lamb_dp2_tp2_z1": (1, 2, 1, 1, "lamb", {}),
    "lamb_dp2_tp2_z2": (2, 2, 1, 1, "lamb", {}),
    "lamb_dp2_tp2_z3": (3, 2, 1, 1, "lamb", {}),
    "moe_dp2_tp2_z1": (1, 2, 1, 1, "adamw",
                       {"moe_num_experts": 4, "moe_top_k": 2,
                        "moe_capacity_factor": 2.0}),
    # the residual MoE's dense branch is SwiGLU whatever the activation
    "moe_residual_gelu_dp2_tp2_z1": (1, 2, 1, 1, "adamw",
                                     {"moe_num_experts": 4, "moe_top_k": 2,
                                      "moe_capacity_factor": 2.0,
                                      "moe_use_residual": True,
                                      "activation": "gelu"}),
    "moe_dropless_dp2_tp2_z1": (1, 2, 1, 1, "adamw",
                                {"moe_num_experts": 4, "moe_top_k": 1,
                                 "moe_dropless": True}),
}


# the cases of the dense model (each other case has weights of its own)
DENSE = [n for n, c in CASES.items() if "moe_num_experts" not in c[5]]


def train_config(name, reduce_scatter=True):
    stage, tp, sp, mics, opt, model = CASES[name]
    dp = WORLD // (tp * sp)
    moe = ({"moe": {"enabled": True, "num_experts": model["moe_num_experts"]}}
           if "moe_num_experts" in model else {})
    return {**moe,
        "train_micro_batch_size_per_gpu": MICRO_ROWS // dp,
        "gradient_accumulation_steps": 2,
        "optimizer": {"type": opt,
                      "params": {"lr": 1e-3, "weight_decay": 0.01}},
        "gradient_clipping": 0.5,
        "tensor_parallel_size": tp,
        "sequence_parallel_size": sp,
        "zero_optimization": {"stage": stage,
                              "stage3_param_persistence_threshold": 0,
                              "mics_shard_size": mics,
                              "reduce_scatter": reduce_scatter},
        "steps_per_print": 10 ** 9,
        "telemetry": {"enabled": False},
    }


def model_cfg(name=None):
    return dict(FLAGSHIP_SMALL, **(CASES[name][5] if name else {}))


def engine(name, weights, **kw):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.checkpoint.interop import params_from_numpy
    from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM

    eng, *_ = deepspeed_tpu_torch.initialize(
        model=TransformerLM(TransformerConfig(**model_cfg(name))),
        config=train_config(name, **kw), device="cpu",
        params=None if weights is None else params_from_numpy(weights))
    return eng


def full_params(eng):
    """The whole f32 master params, or params where there is no master
    (every rank takes part in the gathers)."""
    from deepspeed_tpu_torch.checkpoint import state_checkpoint as ckpt

    state = eng._train_state()
    tree = state["master_params"] or state["params"]
    return {k: v.detach().float().numpy().copy()
            for k, v in ckpt.leaf_paths(tree)}


def _train(eng, batches):
    return [eng.train_batch(batch=b) for b in batches]


def _inference(inp, out):
    """v1 and v2 at tp 2 (two replicas of a model group of two)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.checkpoint.interop import params_from_numpy
    from deepspeed_tpu_torch.inference.v2 import (
        DSStateManagerConfig, InferenceEngineV2, RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM

    w = params_from_numpy(inp["weights"])
    v1 = deepspeed_tpu_torch.init_inference(
        TransformerLM(TransformerConfig(**FLAGSHIP_SMALL)),
        config={"dtype": "fp32", "tensor_parallel": {"tp_size": 2},
                "max_out_tokens": 64}, params=w, device="cpu")
    ids = inp["prompts_v1"]
    out["v1_logits"] = v1.forward(ids).numpy()
    out["v1_tokens"] = v1.generate(ids, max_new_tokens=8)
    out["v1_local_wq"] = tuple(v1.params["layers"]["wq"].shape)
    sm = DSStateManagerConfig(max_tracked_sequences=4, max_seq_len=128,
                              num_blocks=17, block_size=16)
    v2 = InferenceEngineV2(
        TransformerLM(TransformerConfig(**FLAGSHIP_SMALL)),
        RaggedInferenceEngineConfig(state_manager=sm, dtype="float32",
                                    prefill_bucket=16,
                                    tensor_parallel_size=2),
        params=w, device="cpu")
    prompt = inp["prompt_v2"]
    out["v2_put"] = np.asarray(v2.put([1], [prompt])[0])
    out["v2_decode"] = np.asarray(v2.put([1], [[40]])[0])
    v2.flush(1)
    out["v2_tokens"] = [np.asarray(t) for t in
                        v2.generate(inp["prompts_v2"], max_new_tokens=8)]
    out["v2_pool_heads"] = int(v2.kv_cache["k"].shape[3])


def run(rank, world, port, workdir):
    os.environ.update({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                       "RANK": str(rank), "WORLD_SIZE": str(world),
                       "LOCAL_RANK": str(rank)})
    for k in ("DS_TPU_COORDINATOR", "DS_TPU_NUM_PROCESSES",
              "DS_TPU_PROCESS_ID"):
        os.environ.pop(k, None)
    torch.set_num_threads(1)
    from deepspeed_tpu_torch.utils.sanity import check_engine_sanity

    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    batches = inp["batches"]
    out = {}
    for name in CASES:
        eng = engine(name, inp["weights"] if name in DENSE
                     else inp["case_weights"][name])
        out[f"losses_{name}"] = _train(eng, batches[:STEPS])
        out[f"params_{name}"] = full_params(eng)
        out[f"local_wq_{name}"] = tuple(eng.params["layers"]["wq"].shape)
        if name == "dp2_tp2_z3":
            eng.save_checkpoint(os.path.join(workdir, "ck_tp2"), tag="t")
        if name == "dp2_tp2_z0":
            # the safe-mode sweep: clean, then after rank 1 moves a leaf
            # every rank holds alike
            out["sanity_clean"] = check_engine_sanity(eng)
            if rank == 1:
                with torch.no_grad():
                    eng.params["final_norm"].add_(1.0)
            out["sanity_desync"] = check_engine_sanity(
                eng, raise_on_error=False)
        eng.close()
    # reduce_scatter off changes no number (JAX reads the key nowhere)
    for rs in (True, False):
        eng = engine("dp2_tp2_z3", inp["weights"], reduce_scatter=rs)
        out[f"rs_{rs}"] = (_train(eng, batches[:2]), full_params(eng))
        eng.close()
    # a checkpoint saved at tp 1 (world 1) loads at dp 2 x tp 2
    eng = engine("dp2_tp2_z3", None)
    eng.load_checkpoint(os.path.join(workdir, "ck_tp1"), tag="t")
    out["from_tp1"] = full_params(eng)
    out["from_tp1_next"] = _train(eng, batches[STEPS:STEPS + 1])
    eng.close()
    _inference(inp, out)
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
