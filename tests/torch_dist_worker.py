"""Rank body of the multi-rank port tests (``tests/test_torch_distributed.py``).

Runs in processes started by ``torch.multiprocessing.spawn`` and imports only
the port (no ``jax``): it trains ``deepspeed_tpu_torch`` engines at world 2
over gloo on the inputs the test wrote (``inputs.pt``: numpy weights and
batches) and writes what each rank saw to ``rank<r>.pt``.
"""

import os

import numpy as np
import torch

FLAGSHIP_SMALL = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
                      num_layers=2, num_heads=8, num_kv_heads=4,
                      max_seq_len=128, flash_min_seq=128)


def train_config(stage, micro=2, gas=2, mode="auto", threshold=0, **extra):
    cfg = {
        "train_micro_batch_size_per_gpu": micro,
        "gradient_accumulation_steps": gas,
        "optimizer": {"type": "adamw",
                      "params": {"lr": 1e-3, "weight_decay": 0.01}},
        "scheduler": {"type": "WarmupLR",
                      "params": {"warmup_min_lr": 1e-4,
                                 "warmup_max_lr": 1e-3,
                                 "warmup_num_steps": 2}},
        "gradient_clipping": 0.5,
        "zero_optimization": {"stage": stage,
                              "overlap_grad_reduce": mode,
                              "stage3_param_persistence_threshold": threshold,
                              # small buckets: several per layer
                              "reduce_bucket_size": 20000,
                              "allgather_bucket_size": 20000},
        "steps_per_print": 10 ** 9,
        "telemetry": {"enabled": False},
    }
    cfg.update(extra)
    return cfg


class TinyLinear:
    """loss = mean over rows of sum(x * w) in f32, w of 8 fp16 elements:
    the gradient of w[j] is the mean of column j times the loss scale, so
    large columns 4-7 on rank 1's rows overflow fp16 there, and after the
    reduce-scatter only in the shard rank 1 owns."""

    def init_params(self, generator, dtype=torch.float32):
        return {"w": torch.full((8,), 0.01, dtype=dtype,
                                device=generator.device)}

    def apply(self, params, batch, train=True, rng=None):
        return (batch["x"].float() * params["w"].float()).sum(-1).mean()


OFFLOAD = {"tiered": {"device": "cpu", "pin_memory": True},
           "legacy": {"device": "cpu"}}
# the tiered update targets stages 1/2 (a config refusal at 3, as in JAX)
OFFLOAD_CASES = [("tiered", 1), ("tiered", 2), ("legacy", 1), ("legacy", 2),
                 ("legacy", 3)]


def ckpt_leaves(eng):
    """(path, whole fp32 master) of an offloaded engine (every rank takes
    part in the gather)."""
    from deepspeed_tpu_torch.checkpoint import state_checkpoint as ckpt

    return ckpt.leaf_paths(eng._train_state()["master_params"])


def _engine(config, params=None, model=None):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.checkpoint.interop import params_from_numpy
    from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM

    model = model or TransformerLM(TransformerConfig(**FLAGSHIP_SMALL))
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=model, config=config, device="cpu",
        params=None if params is None else params_from_numpy(params))
    return eng


def _full_params(eng):
    """The whole compute params (every rank takes part in the gather)."""
    from deepspeed_tpu_torch.checkpoint import state_checkpoint as ckpt

    tree = eng._train_state()["params"]
    return {k: v.detach().float().numpy().copy()
            for k, v in ckpt.leaf_paths(tree)}


def _train(eng, batches):
    return [eng.train_batch(batch=b) for b in batches]


def run(rank, world, port, workdir):
    os.environ.update({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                       "RANK": str(rank), "WORLD_SIZE": str(world),
                       "LOCAL_RANK": str(rank)})
    for k in ("DS_TPU_COORDINATOR", "DS_TPU_NUM_PROCESSES",
              "DS_TPU_PROCESS_ID"):
        os.environ.pop(k, None)
    torch.set_num_threads(2)
    import torch.distributed as dist

    from deepspeed_tpu_torch.comm import comm

    inp = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=False)
    weights, batches = inp["weights"], inp["batches"]
    out = {}

    # 1. stages 0-3 against the JAX dp=2 engines; stage 3 also saves
    for stage in range(4):
        eng = _engine(train_config(stage), weights)
        out[f"mode{stage}"] = eng.grad_overlap_mode
        out[f"losses{stage}"] = _train(eng, batches[:3])
        out[f"gnorm{stage}"] = eng.get_global_grad_norm()
        out[f"params{stage}"] = _full_params(eng)
        if stage == 3:
            eng.save_checkpoint(os.path.join(workdir, "ckpt_w2"), tag="s3")
            out["cont_losses"] = _train(eng, batches[3:5])
            out["cont_params"] = _full_params(eng)
    out["backend"] = dist.get_backend()
    out["world"] = dist.get_world_size()

    # 2. bucketed against off, gas 1 and 2 (stage 3 with persistent leaves
    # that ride the buckets)
    for gas in (1, 2):
        bs = [{"input_ids": b["input_ids"][:gas]} for b in batches[:3]]
        for stage in range(4):
            thr = 1000 if stage == 3 else 0
            for mode in ("bucketed", "off"):
                eng = _engine(train_config(stage, gas=gas, mode=mode,
                                           threshold=thr), weights)
                key = f"ovl{stage}_{gas}_{mode}"
                out[key] = (eng.grad_overlap_mode, _train(eng, bs),
                            _full_params(eng),
                            None if eng.grad_bucket_plan is None else
                            eng.grad_bucket_plan.num_buckets)

    # 3. the returned loss is the mean over the group: this rank's own
    # mean loss before the update, against train_batch's
    eng = _engine(train_config(0), weights)
    with torch.no_grad():
        rows = eng._shard_batch(batches[0])
        local = torch.stack([eng.model.apply(eng.params, m).float()
                             for m in eng._micro_batches(rows)]).mean()
    both = torch.zeros(world)
    both[rank] = local
    comm.all_reduce(both)
    out["local_losses"] = both.tolist()
    out["returned_loss"] = eng.train_batch(batch=batches[0])

    # 4. fp16: the overflow lives in rank 1's rows and, after the
    # reduce-scatter, in rank 1's shard only; both ranks must skip
    for stage in (2, 3):
        cfg = train_config(stage, fp16={"enabled": True,
                                        "initial_scale_power": 16})
        eng = _engine(cfg, model=TinyLinear())
        x = np.full((2, 4, 8), 0.01, np.float32)
        x[:, 2:, 4:] = 1e4              # rank 1's rows, columns 4-7
        before = [p.detach().clone() for p in eng._param_leaves]
        loss = eng.train_batch(batch={"x": x})
        g = eng._grad_shards[0] if stage == 2 else eng._grad_acc[0]
        out[f"fp16_{stage}"] = {
            "local_finite": bool(torch.isfinite(g).all()),
            "skipped": eng.skipped_steps, "loss_scale": eng.loss_scale,
            "loss": loss,
            "unchanged": all(torch.equal(p.detach(), q) for p, q in
                             zip(eng._param_leaves, before))}

    # 5. a checkpoint written at world 1 (by the test) loads at world 2
    eng = _engine(train_config(3, micro=2), weights)
    eng.load_checkpoint(os.path.join(workdir, "ckpt_w1"), tag="s3")
    out["w1_cont_losses"] = _train(eng, batches[3:5])
    out["w1_cont_params"] = _full_params(eng)

    # 5b. a universal directory converted from a stage-0 checkpoint at
    # world 1 (by the test) loads at stage 3, world 2
    eng = _engine(train_config(3, micro=2), weights)
    eng.load_universal_checkpoint(os.path.join(workdir, "uni_w1"))
    out["uni_step"] = (eng._step, eng.global_steps)
    out["uni_cont_losses"] = _train(eng, batches[3:5])
    out["uni_cont_params"] = _full_params(eng)

    # 6. optimizer offload at world 2: each rank's host tier holds its
    # shard of the master and moments (against the JAX dp=2 engine)
    for kind, stage in OFFLOAD_CASES:
        cfg = train_config(stage)
        cfg["zero_optimization"]["offload_optimizer"] = OFFLOAD[kind]
        eng = _engine(cfg, inp["offload_weights"])
        host = eng.host_opt
        out[f"off_{kind}{stage}"] = {
            "losses": _train(eng, batches[:3]),
            "params": _full_params(eng),
            "host_bytes": sum(host.sizes) * 4 * (1 + len(host.state_keys)),
            "full_bytes": sum(int(np.prod(s)) for s in
                              eng._full_shapes.values()) * 4 *
            (1 + len(host.state_keys)),
            "master": {k: v.numpy().copy() for k, v in ckpt_leaves(eng)}}
        eng.close()

    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()
