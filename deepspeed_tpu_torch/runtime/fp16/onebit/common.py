"""What the 1-bit optimizers share.

Port of ``deepspeed_tpu/runtime/fp16/onebit/common.py``. The reference
implements OnebitAdam, OnebitLamb and ZeroOneAdam as three torch
optimizers over a compressed communication backend (runtime/fp16/onebit/
{adam,lamb,zoadam}.py, runtime/comm/nccl.py); their engine step here is
one :class:`CompressedStep`:

* each rank takes its gradients over its own rows (the GAS loop), with no
  reduction, and divides them by gas;
* each rank keeps its own optimizer state: the momentum, and a worker
  and a server error for the compressed allreduce (the JAX package keeps
  them as arrays with a leading world axis, sharded over the data axes);
* every momentum leaf joins ONE flat buffer, so a sync is a single
  compressed collective (:meth:`OnebitContext.compressed_mean`);
* the optimizer's own arithmetic is its ``impl``: ``init_extra(ctx)``
  (the state, leaf lists and scalars), ``update(ctx, grads, master,
  state, step, lr) -> squared grad norm``, which updates ``master`` and
  ``state`` in place leaf by leaf (a Mistral-7B-width momentum is 4.5 GB
  in f32: whole-tree temporaries would not fit beside the state) and may
  consume ``grads``, and optionally ``forward_params(ctx, params, master,
  state)``, the params the gradients are taken at (ZeroOneAdam's
  per-rank drift).

Its branches (warm-up or compression, a sync step or a local one) are
chosen on the host from the step counter, which every rank holds alike.
"""

from dataclasses import dataclass
from typing import Any, Dict, List

import torch

from ....comm import comm
from ....comm.compressed import compressed_allreduce, padded_numel
from ....ops.quantizer import f32_reciprocal


@dataclass
class OnebitContext:
    """What the optimizer impl knows of the engine."""

    opt: Any
    group: Any
    n: int
    total: int
    padded: int
    shapes: List[tuple]
    numels: List[int]
    device: Any
    compute_dtype: Any = torch.bfloat16

    @property
    def num_leaves(self) -> int:
        return len(self.shapes)

    def zeros(self) -> List[torch.Tensor]:
        return [torch.zeros(s, dtype=torch.float32, device=self.device)
                for s in self.shapes]

    def flatten(self, leaves) -> torch.Tensor:
        return torch.cat([t.reshape(-1) for t in leaves])

    def unflatten(self, flat) -> List[torch.Tensor]:
        out, off = [], 0
        for shape, numel in zip(self.shapes, self.numels):
            out.append(flat[off:off + numel].view(shape))
            off += numel
        return out

    def pmean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean over the data-parallel ranks (``lax.pmean``)."""
        if self.n == 1:
            return t
        t = t.clone()
        comm.all_reduce(t, group=self.group)
        return t.div_(self.n)

    def compressed_mean(self, leaves, worker_error, server_error):
        """The 1-bit averaged allreduce of a list of leaves, as one flat
        buffer. At one rank there is nothing to compress: the identity,
        as the reference's ``if self.size > 1`` guards have it."""
        if self.n == 1:
            return leaves, worker_error, server_error
        flat = torch.zeros(self.padded, dtype=torch.float32,
                           device=self.device)
        flat[:self.total] = self.flatten(leaves)
        avg, we, se = compressed_allreduce(flat, worker_error, server_error,
                                           self.group)
        return self.unflatten(avg[:self.total]), we, se

    @staticmethod
    def tree_norm_sq(leaves) -> torch.Tensor:
        out = None
        for x in leaves:
            s = x.square().sum()
            out = s if out is None else out + s
        return out

    @staticmethod
    def mask_dead(leaves, v):
        """Zero the entries whose variance never saw a gradient (v == 0):
        a sign cannot say zero, so dead entries would take +-scale noise
        from every compressed collective, which the eps-sized denominator
        then blows up (the reference's ``exp_avg_mask``, automatic). Leaf
        by leaf, as they are consumed."""
        for x, v_ in zip(leaves, v):
            yield torch.where(v_ > 0, x, torch.zeros_like(x))


def check_engine(engine, name: str):
    """The compositions a 1-bit optimizer refuses (JAX :124): it handles
    its own communication over pure data parallelism."""
    topo = engine.topology
    for ax in ("model", "seq", "expert", "pipe"):
        if topo.axis_size(ax) != 1:
            raise AssertionError(
                f"{name} requires pure data parallelism (got {ax}>1)")
    if engine.zero_stage != 0:
        raise AssertionError(
            f"{name} handles its own communication; set zero stage 0")
    if engine.fp16_enabled:
        raise AssertionError(
            f"{name}: use bf16 (fp16 loss scaling unsupported)")
    if engine.config.gradient_clipping:
        raise AssertionError(
            f"{name}: gradient clipping is incompatible with local-momentum "
            f"compression (same restriction as the reference)")


class CompressedStep:
    """The engine's train step for a 1-bit optimizer (JAX
    ``build_compressed_train_step`` :138). ``state`` is this rank's."""

    def __init__(self, engine, impl):
        check_engine(engine, type(impl).__name__)
        self.engine = engine
        self.impl = impl
        master = (engine._master_leaves if engine.has_master
                  else engine._param_leaves)
        shapes = [tuple(m.shape) for m in master]
        numels = [int(torch.Size(s).numel()) for s in shapes]
        total = sum(numels)
        n = engine.dp_world_size
        self.ctx = OnebitContext(
            opt=impl.opt, group=engine.group, n=n, total=total,
            padded=padded_numel(total, n), shapes=shapes, numels=numels,
            device=engine.device, compute_dtype=engine.compute_dtype)
        self.state: Dict[str, Any] = impl.init_extra(self.ctx)

    @torch.no_grad()
    def _forward_params(self, params, master):
        if not hasattr(self.impl, "forward_params"):
            return params
        fwd = self.impl.forward_params(self.ctx, params, master, self.state)
        return [p.requires_grad_(True) for p in fwd]

    def step(self, dev_batch) -> Dict[str, Any]:
        """One batch: local gradients, the optimizer's update (its
        collectives inside), the compute params from the new master."""
        eng = self.engine
        params = eng._param_leaves
        master = eng._master_leaves if eng.has_master else params
        leaves = self._forward_params(params, master)
        if hasattr(eng.model, "layer_gather"):
            eng.model.layer_gather = None    # stage 0: nothing to gather
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=eng.device)
               for p in leaves]
        losses = []
        tree = eng._tree(leaves)
        for micro in eng._micro_batches(dev_batch):
            loss = eng.model.apply(tree, micro, train=True).float()
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            with torch.no_grad():
                for a, g in zip(acc, grads):
                    if g is not None:
                        a.add_(g)
            del grads
            losses.append(loss.detach())
        del tree, leaves
        with torch.no_grad():
            inv = f32_reciprocal(eng.gas).to(eng.device)
            for a in acc:
                a.mul_(inv)
            loss = self.ctx.pmean(torch.stack(losses).mean())
            lr = eng._lr_fn(eng._step)
            grads, acc = acc, None     # the update may drop them as it goes
            gnorm_sq = self.impl.update(
                self.ctx, grads, [m.detach() for m in master], self.state,
                eng._step, lr)
            del grads
            if eng.has_master:
                for p, m in zip(params, master):
                    p.copy_(m)
        eng._step += 1
        return {"loss": loss, "grad_norm": gnorm_sq.sqrt(), "lr": lr,
                "skipped": 0}
