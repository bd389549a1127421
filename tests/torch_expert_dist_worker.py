"""Rank body of the expert-parallel ZeRO and composition tests
(``tests/test_torch_expert_zero_distributed.py``).

Runs in processes started by ``torch.multiprocessing.spawn`` and imports
only the port (no ``jax``): four gloo ranks train ``deepspeed_tpu_torch``
engines on the inputs the test wrote (``inputs.pt``: numpy weights and
batches): the ``dryrun_multichip`` modes (c), (c1d) and (c2) (expert
leaves' ZeRO shards over the ranks holding the same experts), ZeRO-2 and
the optimizer offload at ep 2 x dp 2, and the compositions tp 2 x ep 2,
sp 2 x ep 2 (MoE under Ulysses), MiCS 2 x ep 2 and MiCS 2 x sp 2; save
native and universal checkpoints at ep 2 x dp 2 and load them back at
ep 2, and write what each rank saw to ``rank<r>.pt``.
"""

import os

import numpy as np
import torch

SMALL = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
             num_layers=2, num_heads=4, max_seq_len=64)
MOE = dict(moe_num_experts=4, moe_capacity_factor=2.0)
WORLD, STEPS, ROWS, S = 4, 3, 4, 64     # a global micro-batch of 4 rows

# name -> (ZeRO stage, tp, sp, mics, ep, model overrides, config extras)
CASES = {
    # dryrun_multichip (c), (c1d), (c2): ep 2 x dp 2
    "c_ep2_dp2_z1": (1, 1, 1, 1, 2, MOE, {}),
    "c1d_dropless_ep2_z1": (1, 1, 1, 1, 2,
                            dict(MOE, moe_dropless=True), {}),
    "c2_ep2_z3": (3, 1, 1, 1, 2, MOE, {}),
    "ep2_dp2_z2": (2, 1, 1, 1, 2, dict(MOE, moe_top_k=2), {}),
    "ep2_dp2_offload": (2, 1, 1, 1, 2, MOE,
                        {"offload_optimizer": {"device": "cpu"}}),
    # the compositions
    "tp2_ep2_z1": (1, 2, 1, 1, 2, dict(MOE, moe_top_k=2), {}),
    # top-2 at capacity 1.0 drops tokens: the global order of two rows'
    # chunks decides which
    "sp2_ep2_z2": (2, 1, 2, 1, 2, dict(MOE, moe_top_k=2,
                                       moe_capacity_factor=1.0), {}),
    "mics2_ep2_z3": (3, 1, 1, 2, 2, dict(MOE, moe_top_k=2), {}),
    "mics2_sp2_z3": (3, 1, 2, 2, 1, {}, {}),
}


def model_cfg(name):
    return dict(SMALL, **CASES[name][5])


def train_config(name, world=WORLD):
    """The case's config; at world 1 its model and optimizer on one rank
    (no tp, sp, MiCS or ep)."""
    stage, tp, sp, mics, ep, model, extra = CASES[name]
    if world == 1:
        tp = sp = mics = ep = 1
    dp = world // (tp * sp)
    cfg = {
        "train_micro_batch_size_per_gpu": ROWS // dp,
        "gradient_accumulation_steps": 2,
        "optimizer": {"type": "adamw",
                      "params": {"lr": 1e-3, "weight_decay": 0.01}},
        "gradient_clipping": 0.5,
        "tensor_parallel_size": tp,
        "sequence_parallel_size": sp,
        "zero_optimization": {"stage": stage,
                              "stage3_param_persistence_threshold": 0,
                              "mics_shard_size": mics, **extra},
        "steps_per_print": 10 ** 9,
        "telemetry": {"enabled": False},
    }
    if "moe_num_experts" in model:
        cfg["moe"] = {"enabled": True, "num_experts": 4,
                      "expert_parallel_size": ep}
    return cfg


def engine(name, weights, world=WORLD):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.checkpoint.interop import params_from_numpy
    from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM

    eng, *_ = deepspeed_tpu_torch.initialize(
        model=TransformerLM(TransformerConfig(**model_cfg(name))),
        config=train_config(name, world), device="cpu",
        params=None if weights is None else params_from_numpy(weights))
    return eng


def full_params(eng):
    """The whole f32 master params (every rank takes part in the
    gathers)."""
    from deepspeed_tpu_torch.checkpoint import state_checkpoint as ckpt

    state = eng._train_state()
    tree = state["master_params"] or state["params"]
    return {k: v.detach().float().numpy().copy()
            for k, v in ckpt.leaf_paths(tree)}


def run(rank, world, port, workdir):
    os.environ.update({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                       "RANK": str(rank), "WORLD_SIZE": str(world),
                       "LOCAL_RANK": str(rank)})
    for k in ("DS_TPU_COORDINATOR", "DS_TPU_NUM_PROCESSES",
              "DS_TPU_PROCESS_ID"):
        os.environ.pop(k, None)
    torch.set_num_threads(1)
    from deepspeed_tpu_torch.checkpoint import universal as tuni
    from deepspeed_tpu_torch.utils.sanity import check_engine_sanity

    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    batches = inp["batches"]
    out = {}
    for name in CASES:
        eng = engine(name, inp["weights"][name])
        out[f"losses_{name}"] = [eng.train_batch(batch=b)
                                 for b in batches[:STEPS]]
        out[f"params_{name}"] = full_params(eng)
        lp = eng.params["layers"]
        out[f"local_{name}"] = {k: tuple(lp[k].shape)
                                for k in ("e_up", "wq") if k in lp}
        if eng._master_leaves is not None:
            out[f"master_{name}"] = {
                n: tuple(m.shape) for n, m in zip(eng._leaf_names,
                                                  eng._master_leaves)
                if n in ("layers/e_up", "layers/wq")}
        out[f"sanity_{name}"] = check_engine_sanity(eng, raise_on_error=False)
        if name == "c_ep2_dp2_z1":
            ck = os.path.join(workdir, "ck_ep2")
            eng.save_checkpoint(ck, tag="t")
            out["next_c"] = eng.train_batch(batch=batches[STEPS])
            eng.close()
            if rank == 0:
                tuni.ds_to_universal(ck, os.path.join(workdir, "uni_ep2"))
            import torch.distributed as dist
            dist.barrier()
            # back at ep 2 x dp 2: native, then universal
            for kind in ("native", "universal"):
                eng = engine(name, None)
                if kind == "native":
                    eng.load_checkpoint(ck, tag="t")
                else:
                    eng.load_universal_checkpoint(
                        os.path.join(workdir, "uni_ep2"))
                out[f"reload_{kind}"] = full_params(eng)
                out[f"reload_{kind}_next"] = eng.train_batch(
                    batch=batches[STEPS])
                eng.close()
            continue
        eng.close()
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
