"""Rank body of the quantized-communication tests
(``tests/test_torch_zeropp_distributed.py``).

Runs in processes started by ``torch.multiprocessing.spawn`` and imports
only the port (no ``jax``): four gloo ranks run the port's quantized
transports on the per-rank inputs the test wrote (``inputs.pt``), then
train ``deepspeed_tpu_torch`` engines from its numpy weights and batches:
ZeRO++ (``dryrun_multichip`` (e), (e2) and (f), qgZ at stage 2, hpZ
alone, qwZ / qgZ x tp 2), ``quantized_reduce`` int8 at stages 0-2, fp8
and two-level, the 1-bit optimizers, the fp16 overflow skip under the
int8 ring, and the dryrun modes' own bf16 configs. Each rank writes what
it saw to ``rank<r>.pt``.
"""

import os

import torch

SMALL = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
             num_layers=2, num_heads=4, max_seq_len=64)
# dryrun_multichip's model (_flagship_cfg(small=True))
FLAGSHIP_SMALL = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
                      num_layers=2, num_heads=8, num_kv_heads=4,
                      max_seq_len=128)
WORLD, STEPS, ROWS, S = 4, 3, 4, 64     # a global micro-batch of 4 rows
QW = {"zero_quantized_weights": True}
QG = {"zero_quantized_gradients": True}
ADAMW = ("adamw", {"lr": 1e-3, "weight_decay": 0.01})

# name -> (ZeRO stage, tp, sp, zero_optimization extras, optimizer)
CASES = {
    # dryrun_multichip (e), (f) and their parts
    "e_qwz_qgz_z3": (3, 1, 1, dict(QW, **QG), ADAMW),
    "qgz_z2": (2, 1, 1, QG, ADAMW),
    "f_hpz2_qwz_z3": (3, 1, 1, dict(QW, zero_hpz_partition_size=2), ADAMW),
    "hpz2_z3": (3, 1, 1, {"zero_hpz_partition_size": 2}, ADAMW),
    # qwZ / qgZ x tp 2 and its unquantized run (JAX's TransformerLM
    # raises under ZeRO++ x tp on this jaxlib: OWN_ORACLE)
    "zpp_tp2_z3": (3, 2, 1, dict(QW, **QG), ADAMW),
    "tp2_z3": (3, 2, 1, {}, ADAMW),
    # the quantized gradient rings
    "qr_int8_z0": (0, 1, 1, {"quantized_reduce": "int8"}, ADAMW),
    "qr_int8_z1": (1, 1, 1, {"quantized_reduce": "int8"}, ADAMW),
    "qr_int8_z2": (2, 1, 1, {"quantized_reduce": "int8"}, ADAMW),
    "qr_fp8_z2": (2, 1, 1, {"quantized_reduce": "fp8"}, ADAMW),
    "qr_int8_hier2_z2": (2, 1, 1, {"quantized_reduce": "int8",
                                   "quantized_reduce_hierarchy": 2}, ADAMW),
    # the 1-bit optimizers (ZeRO 0, no clipping) across their freeze
    # steps; ZeroOneAdam syncs at step 1 and steps locally at step 2, on
    # the variance of step 0 alone: eps 1e-4 bounds its updates where
    # that variance is ~0 (at 1e-8 they reach ~1e4 lr and the run is
    # chaotic in both packages)
    "onebit_adam": (0, 1, 1, {}, ("OneBitAdam",
                                  {"lr": 1e-3, "freeze_step": 2})),
    "onebit_lamb": (0, 1, 1, {}, ("OneBitLamb",
                                  {"lr": 1e-3, "freeze_step": 2})),
    "zoadam": (0, 1, 1, {}, ("ZeroOneAdam",
                             {"lr": 1e-3, "eps": 1e-4, "var_freeze_step": 1,
                              "local_step_scaler": 1,
                              "local_step_clipper": 2})),
}
QUANT_BLOCK = 256       # small enough that every bucket spans blocks
# cases held against the port's own unquantized run and a JAX run of
# another case on the same global batch, not against JAX in their own
# topology: name -> (the port's run, the JAX case)
OWN_ORACLE = {"zpp_tp2_z3": ("tp2_z3", "e_qwz_qgz_z3")}

# (e2): ZeRO++ x Ulysses sp 2, against the port's own unquantized sp-2
# run (JAX's test_zeropp_composes_with_sequence_parallel: bf16, lr 1e-2)
E2_STEPS = 4
# the dryrun modes' own bf16 configs (one step each)
DRYRUN = {
    "e": {"stage": 3, "stage3_param_persistence_threshold": 0, **QW, **QG},
    "e2": {"stage": 3, "stage3_param_persistence_threshold": 0, **QW, **QG},
    "f": {"stage": 3, "stage3_param_persistence_threshold": 0,
          "zero_hpz_partition_size": 2, **QW},
}


def train_config(name, world=WORLD):
    stage, tp, sp, extra, (opt, params) = CASES[name]
    dp = world // (tp * sp)
    onebit = opt != "adamw"
    cfg = {
        "train_micro_batch_size_per_gpu": ROWS // dp,
        "gradient_accumulation_steps": 2,
        "optimizer": {"type": opt, "params": params},
        "gradient_clipping": 0.0 if onebit else 0.5,
        "tensor_parallel_size": tp,
        "sequence_parallel_size": sp,
        "zero_optimization": {"stage": stage,
                              "stage3_param_persistence_threshold": 0,
                              "quant_block": QUANT_BLOCK, **extra},
        "steps_per_print": 10 ** 9,
        "telemetry": {"enabled": False},
    }
    return cfg


def e2_config(quant: bool, sp: int = 2):
    """A global micro-batch of 4 rows at dp 2 x sp 2 (and at dp 4)."""
    z = {"stage": 3, "stage3_param_persistence_threshold": 0}
    if quant:
        z.update(QW, **QG)
    return {"train_micro_batch_size_per_gpu": ROWS // (WORLD // sp),
            "bf16": {"enabled": True},
            "sequence_parallel_size": sp,
            "optimizer": {"type": "adamw", "params": {"lr": 1e-2}},
            "zero_optimization": z, "steps_per_print": 10 ** 9,
            "telemetry": {"enabled": False}}


def dryrun_config(mode: str):
    cfg = {"train_micro_batch_size_per_gpu": 1,
           "gradient_accumulation_steps": 2,
           "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
           "bf16": {"enabled": True}, "gradient_clipping": 1.0,
           "steps_per_print": 10 ** 9, "telemetry": {"enabled": False},
           "zero_optimization": dict(DRYRUN[mode])}
    if mode == "e2":
        cfg["sequence_parallel_size"] = 2
    return cfg


def engine(model_cfg, config, weights):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.checkpoint.interop import params_from_numpy
    from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM

    eng, *_ = deepspeed_tpu_torch.initialize(
        model=TransformerLM(TransformerConfig(**model_cfg)), config=config,
        device="cpu",
        params=None if weights is None else params_from_numpy(weights))
    return eng


def full_params(eng):
    """The whole f32 master params, or the params where there is none
    (every rank takes part in the gathers)."""
    if eng.onebit_mode:
        leaves = eng._master_leaves if eng.has_master else eng._param_leaves
        return {k: v.detach().float().numpy().copy()
                for k, v in zip(eng._leaf_names, leaves)}
    from deepspeed_tpu_torch.checkpoint import state_checkpoint as ckpt

    state = eng._train_state()
    tree = state["master_params"] or state["params"]
    return {k: v.detach().float().numpy().copy()
            for k, v in ckpt.leaf_paths(tree)}


def _transports(rank, inp, out):
    """The transport functions on this rank's inputs, for the test to hold
    against the JAX functions under shard_map."""
    from deepspeed_tpu_torch.comm import compressed as tc
    from deepspeed_tpu_torch.comm import quantized as tq

    t = {k: torch.from_numpy(v[rank].copy()) for k, v in inp["fn"].items()}
    res = {}
    for mode in ("int8", "fp8"):
        res[f"rs_{mode}"] = tq.ring_reduce_scatter_quant(
            t["rows"], None, WORLD, block=64, mode=mode)
        res[f"ag_{mode}"] = tq.ring_all_gather_quant(
            t["row"], None, WORLD, block=64, mode=mode)
    for g in (1, 2):
        res[f"rs_hier{g}"] = tq.ring_reduce_scatter_hier(
            t["rows"], None, WORLD, g, block=64)
        res[f"ag_hier{g}"] = tq.ring_all_gather_hier(
            t["row"], None, WORLD, g, block=64)
    res["qgz"] = tq.all_to_all_quant_reduce(t["grad"], 1, None, block=64)
    res["qwz"] = tq.quantized_all_gather(t["shard"], 1, None, block=64)
    res["onebit"] = tc.compressed_allreduce(t["buf"], t["werr"], t["serr"])
    out["fn"] = {k: (tuple(x.numpy().copy() for x in v)
                     if isinstance(v, tuple) else v.numpy().copy())
                 for k, v in res.items()}


def run(rank, world, port, workdir):
    os.environ.update({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                       "RANK": str(rank), "WORLD_SIZE": str(world),
                       "LOCAL_RANK": str(rank)})
    for k in ("DS_TPU_COORDINATOR", "DS_TPU_NUM_PROCESSES",
              "DS_TPU_PROCESS_ID"):
        os.environ.pop(k, None)
    torch.set_num_threads(1)
    import torch.distributed as dist
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.runtime.grad_overlap import ring_wire_bytes
    from deepspeed_tpu_torch.telemetry import MetricsRegistry, set_registry

    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    batches = inp["batches"]
    out = {}
    comm.init_distributed("gloo")
    _transports(rank, inp, out)
    for name in CASES:
        eng = engine(SMALL, train_config(name), inp["weights"])
        out[f"losses_{name}"] = [eng.train_batch(batch=b)
                                 for b in batches[:STEPS]]
        out[f"params_{name}"] = full_params(eng)
        if eng.quant_reduce_state is not None:
            out[f"qerr_{name}"] = float(eng._quant_error_norm())
        if name == "f_hpz2_qwz_z3":
            out["hpz_local_wq"] = tuple(eng.params["layers"]["wq"].shape)
            out["hpz_master_wq"] = tuple(
                eng._master_leaves[eng._leaf_names.index("layers/wq")].shape)
            # a checkpoint holds whole leaves: it loads back under hpZ
            ck = os.path.join(workdir, "ck_hpz")
            eng.save_checkpoint(ck, tag="t")
            out["hpz_next"] = eng.train_batch(batch=batches[0])
            eng.close()
            eng = engine(SMALL, train_config(name), None)
            eng.load_checkpoint(ck, tag="t")
            out["hpz_reload"] = full_params(eng)
            out["hpz_reload_next"] = eng.train_batch(batch=batches[0])
        if name == "zoadam":
            st = eng._onebit.state
            out["zoadam_acc"] = {
                n: a.numpy().copy()
                for n, a in zip(eng._leaf_names, st["momentum_acc"])}
        eng.close()
    # the quantized-reduce gauges, and the fp16 overflow skip: every step
    # overflows, the residuals stay zero and the params untouched
    prev = set_registry(MetricsRegistry())
    cfg = dict(train_config("qr_int8_z2"), telemetry={"enabled": True})
    eng = engine(SMALL, cfg, inp["weights"])
    eng.train_batch(batch=batches[0])
    reg = eng.telemetry
    out["gauge_bytes"] = reg.gauge("training_reduce_quantized_bytes",
                                   "").value
    out["gauge_err"] = reg.gauge("training_quant_error_feedback_norm",
                                 "").value
    out["plan_bytes"] = (
        ring_wire_bytes(eng.grad_bucket_plan, WORLD, quantized=True,
                        quant_block=QUANT_BLOCK),
        ring_wire_bytes(eng.grad_bucket_plan, WORLD))
    eng.close()
    set_registry(prev)
    for q in ("int8", "off"):
        cfg = train_config("qr_int8_z2")
        cfg["zero_optimization"]["quantized_reduce"] = q
        cfg["fp16"] = {"enabled": True, "initial_scale_power": 24,
                       "loss_scale_window": 1000}
        eng = engine(SMALL, cfg, inp["weights"])
        for b in batches[:2]:
            eng.train_batch(batch=b)
        out[f"fp16_skip_{q}"] = (eng.skipped_steps, full_params(eng))
        if q == "int8":
            out["fp16_skip_residuals"] = [
                x.numpy().copy() for v in eng.quant_reduce_state.values()
                for x in v.values()]
        eng.close()
    # (e2) against the port's own unquantized sp-2 run
    for quant in (True, False):
        eng = engine(SMALL, e2_config(quant), inp["weights"])
        out[f"e2_{quant}"] = [eng.train_batch(batch=inp["e2_batch"])
                              for _ in range(E2_STEPS)]
        eng.close()
    for mode in DRYRUN:
        eng = engine(FLAGSHIP_SMALL, dryrun_config(mode),
                     inp["flagship_weights"])
        out[f"dryrun_{mode}"] = eng.train_batch(
            batch=inp["dryrun_batch"][mode])
        eng.close()
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
