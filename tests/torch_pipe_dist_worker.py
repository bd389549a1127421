"""Rank body of the pipeline-parallel tests
(``tests/test_torch_pipeline_distributed.py``).

Runs in processes started by ``torch.multiprocessing.spawn`` and imports
only the port (no ``jax``): four gloo ranks train ``deepspeed_tpu_torch``
engines in pipeline mode on the inputs the test wrote (``inputs.pt``:
numpy weights and batches): ``TransformerLM`` at pp 2 x dp 2 (ZeRO 0 and
1), pp 4, with 4 experts (pp 2 x dp 2; pp 2 x ep 2 with the aux loss off
and on), under the host C++ optimizer (fp32 and bf16) and under fp16, and
``PipelineModule`` layer lists at pp 2 x tp 2, pp 2 x sp 2, with tied
layers, with stacked storage at pp 4 and with stacked and replicated
layers at pp 2 x dp 2 (also under fp16); it evaluates, checks the
refusals, saves native checkpoints, round-trips a universal directory
pp 4 -> pp 1 -> pp 4, and writes what each rank saw to ``rank<r>.pt``.
"""

import logging
import os

import numpy as np
import torch

WORLD, STEPS, GAS = 4, 3, 4
ROWS = 4                  # a global micro-batch of 4 rows
HID, S, VOCAB = 32, 64, 128

# the JAX package's pipeline test model (tests/unit/pipe/test_pipeline.py)
LM = dict(vocab_size=VOCAB, hidden_size=64, intermediate_size=128,
          num_layers=4, num_heads=4, max_seq_len=S, use_flash=False)
MOE = dict(moe_num_experts=4, moe_top_k=1, moe_capacity_factor=1.0,
           moe_min_capacity=4)

# name -> (model kind, pp, extra config, model overrides)
CASES = {
    "pp2_dp2_z0": ("lm", 2, {}, {}),
    "pp2_dp2_z1": ("lm", 2, {"zero_optimization": {"stage": 1}}, {}),
    "pp4": ("lm", 4, {}, {}),
    "moe_pp2_dp2": ("lm", 2, {}, dict(MOE, moe_aux_loss_coef=0.05)),
    "moe_pp2_ep2_aux0": ("lm", 2, {"moe": {"enabled": True, "num_experts": 4,
                                           "expert_parallel_size": 2}},
                         dict(MOE, moe_aux_loss_coef=0.0)),
    "moe_pp2_ep2": ("lm", 2, {"moe": {"enabled": True, "num_experts": 4,
                                      "expert_parallel_size": 2}},
                    dict(MOE, moe_aux_loss_coef=0.05)),
    "offload_pp2": ("lm", 2, {"zero_optimization": {
        "stage": 1, "offload_optimizer": {"device": "cpu"}}}, {}),
    "offload_bf16_pp2": ("lm", 2, {"bf16": {"enabled": True},
                                   "zero_optimization": {
        "stage": 1, "offload_optimizer": {"device": "cpu"}}}, {}),
    "pm_pp2_tp2": ("pm_tp", 2, {"tensor_parallel_size": 2}, {}),
    "pm_pp2_sp2": ("pm_sp", 2, {"sequence_parallel_size": 2}, {}),
    # layers that own the seq axis at pp 1: the engine's manual seq mode
    # (no Ulysses loss split; the seq ranks read the same rows)
    "pm_pp1_sp2": ("pm_sp", 1, {"sequence_parallel_size": 2}, {}),
    "pm_mixed_pp2": ("pm_mixed", 2, {}, {}),
    "pm_tied_pp4": ("pm_tied", 4, {}, {}),
    "pm_stacked_pp4": ("pm_stacked", 4, {}, {}),
}
FP16 = {"fp16": {"enabled": True, "initial_scale_power": 8}}
# fp16 runs (autograd through model.apply) -> the case they reconfigure
FP16_RUNS = {"fp16": "pp2_dp2_z0", "fp16_pm": "pm_mixed_pp2"}


def train_config(name, **extra):
    kind, pp, cfg, _ = CASES[name]
    tp = cfg.get("tensor_parallel_size", 1)
    sp = cfg.get("sequence_parallel_size", 1)
    dp = WORLD // (pp * tp * sp)
    out = {"train_micro_batch_size_per_gpu": ROWS // dp,
           "gradient_accumulation_steps": GAS,
           "optimizer": {"type": "adamw",
                         "params": {"lr": 1e-3, "weight_decay": 0.01}},
           "gradient_clipping": 1.0,
           "pipeline": {"stages": pp},
           "zero_optimization": {"stage": 0},
           "steps_per_print": 10 ** 9,
           "telemetry": {"enabled": False}}
    out.update(cfg)
    out.update(extra)
    return out


def lm_cfg(name):
    return dict(LM, **CASES[name][3])


# -- PipelineModule layers (the JAX test's, tests/unit/pipe) --------------
class Linear:
    """A functional layer of the PipelineModule protocol."""

    def __init__(self, d_in, d_out, act=True, seed_scale=0.2):
        self.d_in, self.d_out, self.act = d_in, d_out, act
        self.seed_scale = seed_scale

    def init(self, generator):
        w = torch.randn((self.d_in, self.d_out), generator=generator)
        return {"w": w * self.seed_scale, "b": torch.zeros(self.d_out)}

    def apply(self, params, x):
        # jnp's promotion: f32 rows through fp16 weights compute in f32
        dt = torch.promote_types(x.dtype, params["w"].dtype)
        y = x.to(dt) @ params["w"].to(dt) + params["b"].to(dt)
        return torch.tanh(y) if self.act else y


class ColParallelLinear(Linear):
    """Output-split linear over the model axis (Megatron's ``f``)."""
    axis = "model"

    def partition_spec(self, topo):
        on = topo.axis_size(self.axis) > 1
        return {"w": (None, self.axis) if on else (),
                "b": (self.axis,) if on else ()}

    def apply(self, params, x):
        from deepspeed_tpu_torch.comm.comm import tp_copy
        return super().apply(params, tp_copy(x, self.axis))


class RowParallelLinear(Linear):
    """Input-split linear; ``tp_reduce`` (``g``) restores the output."""
    axis = "model"

    def partition_spec(self, topo):
        on = topo.axis_size(self.axis) > 1
        return {"w": (self.axis, None) if on else (), "b": ()}

    def apply(self, params, x):
        from deepspeed_tpu_torch.comm.comm import tp_reduce
        y = tp_reduce(x @ params["w"], self.axis) + params["b"]
        return torch.tanh(y) if self.act else y


class SeqCol(ColParallelLinear):
    axis = "seq"


class SeqRow(RowParallelLinear):
    axis = "seq"


class InProj(Linear):
    pass


def head_fwd(params, x):
    # the tied use: project back with the transpose
    return x @ params["w"].T.to(x.dtype)


def mse_loss(out, batch):
    return torch.mean((out - batch["y"].float()) ** 2)


def pm_layers(kind):
    from deepspeed_tpu_torch import LayerSpec, TiedLayerSpec

    if kind == "pm_tp":
        return [LayerSpec(ColParallelLinear, HID, 2 * HID),
                LayerSpec(RowParallelLinear, 2 * HID, HID),
                LayerSpec(ColParallelLinear, HID, 2 * HID),
                LayerSpec(RowParallelLinear, 2 * HID, HID, act=False)]
    if kind == "pm_sp":
        return [LayerSpec(SeqCol, HID, 2 * HID),
                LayerSpec(SeqRow, 2 * HID, HID),
                LayerSpec(SeqCol, HID, 2 * HID),
                LayerSpec(SeqRow, 2 * HID, HID, act=False)]
    if kind == "pm_tied":
        return [TiedLayerSpec("proj", InProj, HID, HID, act=False),
                LayerSpec(Linear, HID, HID),
                LayerSpec(Linear, HID, HID),
                TiedLayerSpec("proj", InProj, HID, HID, act=False,
                              forward_fn=head_fwd)]
    if kind == "pm_mixed":
        # at pp 2 the middle four are stacked ([2, ...] a stage), the ends
        # replicated
        return ([LayerSpec(InProj, HID, HID, act=False)]
                + [LayerSpec(Linear, HID, HID) for _ in range(4)]
                + [LayerSpec(InProj, HID, HID, act=False)])
    return [LayerSpec(Linear, HID, HID) for _ in range(8)]


def make_model(name):
    from deepspeed_tpu_torch import PipelineModule
    from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM

    kind = CASES[name][0]
    if kind == "lm":
        return TransformerLM(TransformerConfig(**lm_cfg(name)))
    return PipelineModule(pm_layers(kind), mse_loss,
                          partition_method="uniform", input_ndim=2)


def engine(name, weights, config=None, **cfg_model):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.checkpoint.interop import params_from_numpy

    eng, *_ = deepspeed_tpu_torch.initialize(
        model=make_model(name), config=config or train_config(name),
        device="cpu",
        params=None if weights is None else params_from_numpy(weights))
    return eng


def batch_for(name, batches):
    """The case's global batches: token ids for a TransformerLM, x / y
    rows for a layer list."""
    return batches["lm" if CASES[name][0] == "lm" else "pm"]


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


def _raises(fn):
    """The exception type and message ``fn`` raises (None if it does
    not)."""
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 - recorded for the test
        return type(exc).__name__, str(exc)
    return None


def _refusals(inp, out):
    """ZeRO 3, fp16 x offload and the shims refuse pipeline mode."""
    from deepspeed_tpu_torch.runtime import engine as teng_mod

    w = inp["weights"]["pp2_dp2_z0"]
    out["zero3"] = _raises(lambda: engine(
        "pp2_dp2_z0", w, train_config(
            "pp2_dp2_z0", zero_optimization={"stage": 3})))
    built = []
    orig = teng_mod.DeepSpeedTpuEngine._init_offload

    def spy(self, items):
        built.append(True)
        return orig(self, items)

    teng_mod.DeepSpeedTpuEngine._init_offload = spy
    try:
        out["fp16_offload"] = _raises(lambda: engine(
            "offload_pp2", w, train_config("offload_pp2", **FP16)))
    finally:
        teng_mod.DeepSpeedTpuEngine._init_offload = orig
    out["fp16_offload_host_built"] = bool(built)
    eng = engine("pp2_dp2_z0", w)
    b = inp["batches"]["lm"][0]
    out["shim_forward"] = _raises(lambda: eng.forward(
        {"input_ids": b["input_ids"][0]}))
    out["shim_backward"] = _raises(lambda: eng.backward())
    out["shim_step"] = _raises(lambda: eng.step())
    eng.close()


def _universal_round_trip(workdir, rank, inp, out):
    """PipelineModule pp 4 (stacked) -> universal -> pp 1 -> universal ->
    pp 4 (JAX test_universal_checkpoint.py:170)."""
    from deepspeed_tpu_torch.checkpoint.universal import ds_to_universal
    import torch.distributed as dist

    name = "pm_stacked_pp4"
    batches = batch_for(name, inp["batches"])
    eng4 = engine(name, inp["weights"][name])
    out["uni_local_stack"] = tuple(eng4.params["stack_000"]["w"].shape)
    eng4.train_batch(batch=batches[0])
    eng4.save_checkpoint(os.path.join(workdir, "ck_pm4"), tag="t")
    w4 = full_params(eng4)
    step4 = (eng4._step, eng4.global_steps)
    eng4.close()
    if rank == 0:
        ds_to_universal(os.path.join(workdir, "ck_pm4"),
                        os.path.join(workdir, "uni_pm4"), tag="t")
    dist.barrier()
    eng1 = engine(name, None, train_config(name, pipeline={"stages": 1},
                                           train_micro_batch_size_per_gpu=1))
    eng1.load_universal_checkpoint(os.path.join(workdir, "uni_pm4"))
    w1 = full_params(eng1)
    out["uni_pp1_keys"] = sorted(w1)
    out["uni_pp1_equal"] = all(
        np.array_equal(w1[f"layer_{j:03d}/w"], w4["stack_000/w"][j])
        for j in range(8))
    out["uni_pp1_step"] = (eng1._step, eng1.global_steps) == step4
    eng1.save_checkpoint(os.path.join(workdir, "ck_pm1"), tag="t")
    eng1.close()
    if rank == 0:
        ds_to_universal(os.path.join(workdir, "ck_pm1"),
                        os.path.join(workdir, "uni_pm1"), tag="t")
    dist.barrier()
    eng4b = engine(name, None)
    eng4b.load_universal_checkpoint(os.path.join(workdir, "uni_pm1"))
    out["uni_pp4_equal"] = np.array_equal(full_params(eng4b)["stack_000/w"],
                                          w4["stack_000/w"])
    out["uni_pp4_next"] = eng4b.train_batch(batch=batches[1])
    eng4b.close()


def run(rank, world, port, workdir):
    os.environ.update({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                       "RANK": str(rank), "WORLD_SIZE": str(world),
                       "LOCAL_RANK": str(rank)})
    for k in ("DS_TPU_COORDINATOR", "DS_TPU_NUM_PROCESSES",
              "DS_TPU_PROCESS_ID"):
        os.environ.pop(k, None)
    torch.set_num_threads(1)
    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    out = {}
    for name in CASES:
        batches = batch_for(name, inp["batches"])
        eng = engine(name, inp["weights"][name])
        out[f"losses_{name}"] = _train(eng, batches[:STEPS])
        out[f"params_{name}"] = full_params(eng)
        out[f"local_{name}"] = {k: tuple(v.shape) for k, v in
                                zip(eng._leaf_names, eng._param_leaves)}
        if name == "pp2_dp2_z0":
            out["eval_pp2_dp2"] = eng.eval_batch(batch=batches[STEPS])
        if name == "pp2_dp2_z1":
            eng.save_checkpoint(os.path.join(workdir, "ck_pp2"), tag="t")
        if name == "pm_stacked_pp4":
            out["eval_pm_stacked"] = eng.eval_batch(batch=batches[STEPS])
        eng.close()
    # fp16: autograd through the pipelined forward, with the warning
    for run_name, name in FP16_RUNS.items():
        seen = []
        handler = logging.Handler()
        handler.emit = seen.append
        lg = logging.getLogger("deepspeed_tpu_torch")
        lg.addHandler(handler)
        try:
            eng = engine(name, inp["weights"][run_name],
                         train_config(name, **FP16))
        finally:
            lg.removeHandler(handler)
        out[f"{run_name}_warned"] = [r.getMessage() for r in seen
                                     if r.levelno >= logging.WARNING]
        out[f"losses_{run_name}"] = _train(
            eng, batch_for(name, inp["batches"])[:STEPS])
        out[f"params_{run_name}"] = full_params(eng)
        eng.close()
    _refusals(inp, out)
    _universal_round_trip(workdir, rank, inp, out)
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
