"""Rank body of the memory-tier tests at four ranks
(``tests/test_torch_tiers_distributed.py``).

Runs in processes started by ``torch.multiprocessing.spawn`` and imports
only the port (no ``jax``): four gloo ranks train ``deepspeed_tpu_torch``
engines on the inputs the test wrote (``inputs.pt``: numpy weights and
batches): ZeRO-Infinity (``offload_param`` nvme) at dp 4 and dp 2 x tp 2
(its optimizer state in host RAM, and once on NVMe), the tiered optimizer
offload, the host C++ optimizer and ``offload_param`` cpu at dp 2 x tp 2,
dp 2 x sp 2 and MiCS 2 x dp 2, LAMB over the tiered tier at dp 4 and
dp 2 x tp 2, and each tiered case's resident twin; an Infinity engine at
dp 2 x tp 2 saves a checkpoint. Each rank writes what it saw to
``rank<r>.pt``.
"""

import os

import torch

# the tiny model of tests/test_torch_infinity.py
TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_layers=4, num_heads=4, max_seq_len=64, use_flash=False,
            remat=True)
WORLD, STEPS, ROWS, S, GAS = 4, 3, 4, 64, 2   # global micro-batch: 4 rows
CKPT_CASE = "inf_dp2_tp2"

# name -> (tp, sp, mics, tier, optimizer)
CASES = {
    "inf_dp4": (1, 1, 1, "infinity", "adamw"),
    "inf_dp2_tp2": (2, 1, 1, "infinity", "adamw"),
    "inf_nvme_dp2_tp2": (2, 1, 1, "infinity_nvme", "adamw"),
    "tiered_dp2_tp2": (2, 1, 1, "tiered", "adamw"),
    "tiered_dp2_sp2": (1, 2, 1, "tiered", "adamw"),
    "tiered_mics2_dp2": (1, 1, 2, "tiered", "adamw"),
    "host_dp2_tp2": (2, 1, 1, "host", "adamw"),
    "host_dp2_sp2": (1, 2, 1, "host", "adamw"),
    "host_mics2_dp2": (1, 1, 2, "host", "adamw"),
    "param_cpu_dp2_tp2": (2, 1, 1, "param_cpu", "adamw"),
    "param_cpu_dp2_sp2": (1, 2, 1, "param_cpu", "adamw"),
    "param_cpu_mics2_dp2": (1, 1, 2, "param_cpu", "adamw"),
    "lamb_tiered_dp4": (1, 1, 1, "tiered", "lamb"),
    "lamb_tiered_dp2_tp2": (2, 1, 1, "tiered", "lamb"),
}
TIERED = [n for n, c in CASES.items() if c[3] == "tiered"]


def train_config(name, world=WORLD, nvme_path=None, tier=None):
    """The case's config (``tier`` overrides its tier: "resident" drops
    the offload keys); at world 1 its model and optimizer on one rank (no
    tp, sp or MiCS)."""
    tp, sp, mics, case_tier, opt = CASES[name]
    tier = tier or case_tier
    if world == 1:
        tp = sp = mics = 1
    dp = world // (tp * sp)
    zero = {"stage": 2, "stage3_param_persistence_threshold": 0,
            "mics_shard_size": mics}
    if tier.startswith("infinity"):
        zero["stage"] = 3
        zero["offload_param"] = {"device": "nvme", "nvme_path": nvme_path}
        if tier == "infinity_nvme":
            zero["offload_optimizer"] = {"device": "nvme",
                                         "nvme_path": nvme_path}
    elif tier == "tiered":
        # a small bucket: the stacked leaves are cut between layers
        zero.update(offload_optimizer={"device": "cpu", "pin_memory": True},
                    stage3_prefetch_bucket_size=20000)
    elif tier == "host":
        zero["offload_optimizer"] = {"device": "cpu"}
    elif tier == "param_cpu":
        zero["stage"] = 3
        zero["offload_param"] = {"device": "cpu"}
    return {"train_micro_batch_size_per_gpu": ROWS // dp,
            "gradient_accumulation_steps": GAS,
            "optimizer": {"type": opt,
                          "params": {"lr": 1e-3, "weight_decay": 0.01}},
            "gradient_clipping": 0.5,
            "tensor_parallel_size": tp, "sequence_parallel_size": sp,
            "zero_optimization": zero, "steps_per_print": 10 ** 9,
            "telemetry": {"enabled": False}}


def engine(name, weights, world=WORLD, nvme_path=None, tier=None):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.checkpoint.interop import params_from_numpy
    from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM

    eng, *_ = deepspeed_tpu_torch.initialize(
        model=TransformerLM(TransformerConfig(**TINY)),
        config=train_config(name, world, nvme_path, tier), device="cpu",
        params=None if weights is None else params_from_numpy(weights))
    return eng


def whole_state(eng):
    """The whole f32 master params and moments (every rank takes part in
    the gathers)."""
    from deepspeed_tpu_torch.checkpoint import state_checkpoint as ckpt

    state = eng._train_state()
    tree = state["master_params"] or state["params"]
    master = {k: v.detach().float().numpy().copy()
              for k, v in ckpt.leaf_paths(tree)}
    moments = {f"{m}/{k}": v.detach().float().numpy().copy()
               for m, sub in state["opt_state"].items()
               for k, v in ckpt.leaf_paths(sub)}
    return master, moments


def _files(d, suffix):
    return sorted((f, os.path.getsize(os.path.join(d, f)))
                  for f in os.listdir(d) if f.endswith(suffix))


def run(rank, world, port, workdir):
    os.environ.update({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                       "RANK": str(rank), "WORLD_SIZE": str(world),
                       "LOCAL_RANK": str(rank)})
    for k in ("DS_TPU_COORDINATOR", "DS_TPU_NUM_PROCESSES",
              "DS_TPU_PROCESS_ID"):
        os.environ.pop(k, None)
    torch.set_num_threads(1)
    import torch.distributed as dist

    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    batches, weights = inp["batches"], inp["weights"]
    nvme = os.path.join(workdir, "nvme")
    out = {}
    for name in CASES:
        tier = CASES[name][3]
        eng = engine(name, weights, nvme_path=nvme)
        if tier.startswith("infinity"):
            inf = eng._infinity
            out[f"files_{name}"] = _files(inf.param_dir, ".params")
            if tier == "infinity_nvme":
                out[f"optim_files_{name}"] = _files(inf.optim_dir, ".optim")
        out[f"losses_{name}"] = [eng.train_batch(batch=b)
                                 for b in batches[:STEPS]]
        out[f"params_{name}"], out[f"moments_{name}"] = whole_state(eng)
        if eng.host_opt is not None:
            out[f"master_{name}"] = {
                n: tuple(m.shape) for n, m in zip(
                    eng._leaf_names, eng.host_opt.get_all_leaves()[0])}
        if name == CKPT_CASE:
            eng.save_checkpoint(os.path.join(workdir, "ck_inf"), tag="t")
            out["next_inf"] = eng.train_batch(batch=batches[STEPS])
        eng.close()
        if name in TIERED:
            res = engine(name, weights, tier="resident")
            out[f"res_losses_{name}"] = [res.train_batch(batch=b)
                                         for b in batches[:STEPS]]
            out[f"res_params_{name}"], out[f"res_moments_{name}"] = \
                whole_state(res)
            res.close()
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
