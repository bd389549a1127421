"""Generic layer-list pipeline API.

Port of ``deepspeed_tpu/runtime/pipe/module.py`` (``LayerSpec`` :54,
``TiedLayerSpec`` :72, ``partition_balanced`` :83, ``PipelineModule``
:129), the reference's ``runtime/pipe/module.py`` (``LayerSpec`` :30,
``TiedLayerSpec`` :77, ``PipelineModule`` :86, ``_partition_layers`` :370
with the ``parameters | uniform | type:regex`` methods). A user describes
the model as an ordered list of layers; the module partitions them into
pp contiguous stages and trains them through the 1F1B schedule
(``pipeline.pipeline_1f1b``) over the pipe group.

Layer protocol (functional, as the engine's model protocol):
  layer.init(generator) -> dict of tensors
  layer.apply(params, x) -> x          # may run collectives (TP, seq)
  layer.partition_spec(topo) -> {leaf: tuple of axis names per dim}
                                       # optional, e.g. (None, "model")

A partition spec is JAX's ``P`` without jax, so a layer moves between the
packages with its body changed only. Storage follows the JAX plan: a run
of identical LayerSpecs that the balanced partition splits into an equal
count k per stage is stored stacked (``stack_NNN``, ``[pp * k, ...]``
whole; each stage holds its ``[k, ...]``), every other layer as
``layer_NNN`` and each tied key once under ``tied/<key>``, replicated over
the pipe axis (their gradients summed over it, which also adds a tied
layer's uses). The engine cuts the stacked leaves along dim 0
(:attr:`PipelineModule.pipe_shard_dims`) and the TP / seq leaves along
their spec's dims; a checkpoint holds them whole, each stacked leaf as
canonical per-layer fragments.
"""

import re
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ...comm import comm
from ...comm.quantized import all_gather_leaf
from ...parallel.topology import PIPE_AXIS
from .pipeline import pipeline_1f1b

__all__ = ["LayerSpec", "TiedLayerSpec", "PipelineModule",
           "partition_balanced"]


class _GatherStack(torch.autograd.Function):
    """A stacked leaf's ``[k, ...]`` slices all-gathered over the pipe
    group on dim 0; the backward keeps this stage's slice of the whole
    leaf's gradient, which every stage computes alike."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.lo, ctx.k = comm.get_rank(group) * t.shape[0], t.shape[0]
        return all_gather_leaf(t.detach().contiguous(), 0, group)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(0, ctx.lo, ctx.k), None


class LayerSpec:
    """Deferred layer construction (reference pipe/module.py:30): holds the
    layer class and ctor args so the module can build, count and partition
    layers before any parameters exist."""

    def __init__(self, typename, *args, **kwargs):
        self.typename = typename
        self.args = args
        self.kwargs = kwargs

    def build(self):
        return self.typename(*self.args, **self.kwargs)

    @property
    def type_name(self) -> str:
        return getattr(self.typename, "__name__", str(self.typename))


class TiedLayerSpec(LayerSpec):
    """LayerSpec whose parameters are shared with every other TiedLayerSpec
    of the same ``key`` (reference pipe/module.py:77): the tied
    embedding / LM-head pattern. ``forward_fn(params, x)`` replaces the
    layer's ``apply`` for this use."""

    def __init__(self, key, typename, *args, forward_fn=None, **kwargs):
        super().__init__(typename, *args, **kwargs)
        self.key = key
        self.forward_fn = forward_fn


def partition_balanced(weights: Sequence[float], parts: int) -> List[int]:
    """Optimal contiguous partition minimizing the max part weight
    (reference runtime/utils.py partition_balanced): part boundaries,
    ``parts + 1`` of them; empty parts only at the tail."""
    n = len(weights)
    if n and not any(w > 0 for w in weights):
        raise ValueError(
            "partition weights are all zero (e.g. a type:regex that matches "
            "no layer) — cannot balance stages")
    prefix = np.concatenate([[0.0], np.cumsum(weights)])
    # binary search on capacity + greedy packing (optimal for contiguous)
    lo = max(weights) if weights else 0.0
    hi = float(prefix[-1])
    best = None
    for _ in range(64):
        cap = (lo + hi) / 2.0
        bounds, start, used = [0], 0, 1
        ok = True
        for i in range(n):
            if prefix[i + 1] - prefix[start] > cap + 1e-9:
                if i == start:  # single item exceeds cap
                    ok = False
                    break
                bounds.append(i)
                start = i
                used += 1
                if used > parts:
                    ok = False
                    break
        if ok and used <= parts:
            bounds = bounds + [n]
            while len(bounds) < parts + 1:
                bounds.append(n)
            best = bounds
            hi = cap
        else:
            lo = cap
    if best is None:
        best = list(np.linspace(0, n, parts + 1).astype(int))
    return [int(b) for b in best]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


class PipelineModule:
    """Layer-list model trained through the 1F1B schedule.

    Parameters
    ----------
    layers : list of LayerSpec / TiedLayerSpec or built layer objects.
    loss_fn : (last_stage_output, batch_without_x) -> scalar micro-batch
        loss.
    partition_method : "parameters" (balance by element count, the
        reference default), "uniform" (equal layer counts) or
        "type:REGEX" (balance the count of layers whose class name
        matches).
    activation_spec : ``(shape, dtype)`` of the inter-stage activation of
        one micro-batch; None: stage 0's first output, broadcast over the
        pipe group.
    input_ndim : rank of one micro-batch's ``x``, so :meth:`apply` takes
        ``[M, b, ...]`` and one micro-batch ``[b, ...]`` alike.
    """

    supports_pp_tp = True  # the engine may compose pipe with the model axis
    # axes whose collectives the layers own (the engine composes them with
    # pipe; a layer list with no seq-axis ops under sp > 1 replicates work)
    pp_manual_axes = ("model", "seq")

    def __init__(self, layers, loss_fn: Callable,
                 partition_method: str = "parameters",
                 activation_spec=None, input_ndim: Optional[int] = None):
        self.input_ndim = input_ndim
        self.specs = list(layers)
        self.layers = [s.build() if isinstance(s, LayerSpec) else s
                       for s in self.specs]
        self.loss_fn = loss_fn
        self.partition_method = partition_method
        self.activation_spec = activation_spec
        self.topology = None
        self._bounds = None
        # tied-parameter wiring: layer index -> tied key
        self.tied_keys: Dict[int, str] = {
            i: s.key for i, s in enumerate(self.specs)
            if isinstance(s, TiedLayerSpec)}

    # -- engine protocol ---------------------------------------------------
    def set_topology(self, topo):
        self.topology = topo
        self._bounds = None

    def _param_key(self, i: int) -> str:
        return f"layer_{i:03d}"

    def _stack_key(self, a: int) -> str:
        return f"stack_{a:03d}"

    def _pp(self) -> int:
        if self.topology is None:
            return 1
        return self.topology.axis_size(PIPE_AXIS)

    def _spec_identity(self, i: int):
        """Comparable identity of layer i for stacking, or None if it can
        never stack (tied, or a built object)."""
        s = self.specs[i]
        if not isinstance(s, LayerSpec) or isinstance(s, TiedLayerSpec):
            return None
        return (s.typename, s.args, s.kwargs)

    def _stack_plan(self, pp: int) -> Dict[int, tuple]:
        """{run start a: (a, b, k)} for every maximal run of identical
        LayerSpecs [a, b) that the balanced partition splits into an equal
        count k per stage: stored stacked, cut over the pipe axis."""
        if pp <= 1:
            return {}
        bounds = self.stage_bounds(pp)
        n = len(self.specs)
        plan: Dict[int, tuple] = {}
        i = 0
        while i < n:
            ident = self._spec_identity(i)
            if ident is None:
                i += 1
                continue
            j = i + 1
            while j < n:
                try:
                    same = self._spec_identity(j) == ident
                except Exception:
                    same = False
                if not same:
                    break
                j += 1
            counts = [max(0, min(j, bounds[s + 1]) - max(i, bounds[s]))
                      for s in range(pp)]
            k = counts[0]
            if k > 0 and all(c == k for c in counts):
                plan[i] = (i, j, k)
            i = j
        return plan

    def _run_of(self, plan: Dict[int, tuple], i: int):
        for a, (a0, b, k) in plan.items():
            if a0 <= i < b:
                return (a0, k)
        return None

    def init_params(self, generator: Optional[torch.Generator] = None,
                    dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
        """The whole parameter tree (stacked runs ``[pp * k, ...]``), each
        layer's ``init(generator)`` in layer order, cast to ``dtype``."""
        plan = self._stack_plan(self._pp())
        params: Dict[str, Any] = {}
        tied: Dict[str, Any] = {}
        members: Dict[int, list] = {a: [] for a in plan}
        for i, layer in enumerate(self.layers):
            if i in self.tied_keys:
                key = self.tied_keys[i]
                if key not in tied:  # the first occurrence owns the params
                    tied[key] = layer.init(generator)
                continue
            run = self._run_of(plan, i)
            if run is not None:
                members[run[0]].append(layer.init(generator))
            else:
                params[self._param_key(i)] = layer.init(generator)
        for a, ms in members.items():
            params[self._stack_key(a)] = {
                k: torch.stack([m[k] for m in ms]) for k in ms[0]}
        if tied:
            params["tied"] = tied
        return _map(lambda v: v.to(dtype), params)

    def _layer_spec_for(self, i: int, topo) -> Dict[str, tuple]:
        layer = self.layers[i]
        if hasattr(layer, "partition_spec"):
            return layer.partition_spec(topo)
        with torch.device("meta"):
            tpl = layer.init(torch.Generator())
        return _map(lambda v: (), tpl)

    def param_partition_specs(self, topo) -> Dict[str, Any]:
        """Each leaf's axis names per dim: the layers' own specs (TP or
        seq), replicated where a layer gives none; stacked runs with the
        pipe axis on their leading (layer) dim."""
        plan = self._stack_plan(self._pp())
        specs: Dict[str, Any] = {}
        tied: Dict[str, Any] = {}
        for i in range(len(self.layers)):
            if i in self.tied_keys:
                key = self.tied_keys[i]
                if key not in tied:
                    tied[key] = self._layer_spec_for(i, topo)
                continue
            run = self._run_of(plan, i)
            if run is not None:
                if i == run[0]:  # the first member carries the spec
                    specs[self._stack_key(i)] = _map(
                        lambda sp: (PIPE_AXIS,) + tuple(sp),
                        self._layer_spec_for(i, topo))
            else:
                specs[self._param_key(i)] = self._layer_spec_for(i, topo)
        if tied:
            specs["tied"] = tied
        return specs

    def _axis_dims(self, axis: str) -> Dict[str, int]:
        """{leaf path: the whole leaf's dim cut over ``axis``}."""
        if self.topology is None:
            return {}
        return {k: tuple(sp).index(axis)
                for k, sp in _leaves(self.param_partition_specs(
                    self.topology)) if axis in tuple(sp)}

    @property
    def pipe_shard_dims(self) -> Dict[str, int]:
        """The stacked leaves, cut over the pipe axis on dim 0."""
        return self._axis_dims(PIPE_AXIS)

    @property
    def tp_shard_dims(self) -> Dict[str, int]:
        return self._axis_dims("model")

    @property
    def seq_shard_dims(self) -> Dict[str, int]:
        return self._axis_dims("seq")

    def pipe_grad_reduce_mask(self, params):
        """False for the pipe-cut (stacked) leaves, whose local gradient is
        complete; True (summed over the pipe group) for every other."""
        return {k: _map(lambda _: not k.startswith("stack_"), v)
                for k, v in params.items()}

    # -- partitioning (reference _partition_layers, pipe/module.py:370) ----
    def _layer_weights(self) -> List[float]:
        method = self.partition_method.lower()
        if method == "uniform":
            return [1.0] * len(self.layers)
        if method == "parameters":
            weights = []
            for layer in self.layers:
                # the counterpart of jax.eval_shape: allocates nothing
                with torch.device("meta"):
                    tpl = layer.init(torch.Generator())
                weights.append(float(sum(v.numel()
                                         for _, v in _leaves(tpl))))
            return weights
        if method.startswith("type:"):
            pat = re.compile(self.partition_method[len("type:"):],
                             re.IGNORECASE)
            return [1.0 if pat.search(
                        s.type_name if isinstance(s, LayerSpec)
                        else type(s).__name__) else 0.0
                    for s in self.specs]
        raise ValueError(
            f"unknown partition_method {self.partition_method!r} "
            f"(expected parameters|uniform|type:regex)")

    def stage_bounds(self, pp: int) -> List[int]:
        if self._bounds is None or len(self._bounds) != pp + 1:
            self._bounds = partition_balanced(self._layer_weights(), pp)
        return self._bounds

    def _layer_params(self, params, i, plan=None, local_base=None):
        """Params of layer i; a stacked member indexes its leaf: at
        ``i - local_base`` in this stage's ``[k, ...]`` slice, else at
        ``i - a`` in the whole ``[pp * k, ...]`` leaf."""
        if i in self.tied_keys:
            return params["tied"][self.tied_keys[i]]
        run = self._run_of(plan, i) if plan else None
        if run is not None:
            a, _k = run
            j = i - (local_base if local_base is not None else a)
            return {k: v[j] for k, v in params[self._stack_key(a)].items()}
        return params[self._param_key(i)]

    def _apply_layer(self, params, i, x, plan=None, local_base=None):
        spec = self.specs[i]
        p = self._layer_params(params, i, plan, local_base)
        if isinstance(spec, TiedLayerSpec) and spec.forward_fn is not None:
            return spec.forward_fn(p, x)
        return self.layers[i].apply(p, x)

    def _stage_branches(self, pp: int):
        """The pp stage functions ``(params, x_raw, h) -> h``; stage s
        runs layers ``[bounds[s], bounds[s + 1])`` on its local params.
        The plan follows the storage (the topology at init), not ``pp``."""
        bounds = self.stage_bounds(pp)
        plan = self._stack_plan(self._pp())

        def make_branch(s, lo, hi, is_first):
            def branch(params, x_raw, h):
                x = x_raw if is_first else h
                for i in range(lo, hi):
                    run = self._run_of(plan, i)
                    # this stage's slice of run (a, b, k) holds members
                    # [a + s * k, a + (s + 1) * k)
                    base = (run[0] + s * run[1]) if run is not None else None
                    x = self._apply_layer(params, i, x, plan, base)
                return x
            return branch

        return [make_branch(s, bounds[s], bounds[s + 1], s == 0)
                for s in range(pp)]

    # -- execution ---------------------------------------------------------
    def _split_batch(self, batch):
        x = batch["x"]
        rest_keys = sorted(k for k in batch if k != "x")
        return x, rest_keys, tuple(batch[k] for k in rest_keys)

    def loss_and_grads(self, params, batch, rng=None, scale=None,
                       grad_acc=None):
        """(loss, grads) through the 1F1B schedule, the engine's call in
        pipeline mode; ``batch`` leaves ``[M, micro, ...]`` (this rank's
        rows). The gradients are summed over the pipe group (not over the
        data ranks: the engine reduces those), into the caller's f32
        ``grad_acc`` buffers where given (``pipeline_1f1b``)."""
        pp = self._pp()
        x, rest_keys, rest = self._split_batch(batch)

        def loss_fn(_p, out, *largs):
            # the user loss takes no params: loss-side weights (a tied
            # head) are layers of the list
            return self.loss_fn(out, dict(zip(rest_keys, largs)))

        return pipeline_1f1b(self._stage_branches(pp), loss_fn, params, x,
                             pp, h_spec=self.activation_spec,
                             loss_args=rest,
                             pipe_reduce_mask=self.pipe_grad_reduce_mask(
                                 params), grad_acc=grad_acc)

    def apply(self, params, batch, train: bool = True, rng=None):
        """The mean micro-batch loss without the schedule (eval, the
        engine's path at pp 1 and its fp16 fallback): every rank runs the
        whole layer list with its TP / seq collectives, the stacked leaves
        all-gathered over the pipe group first (eval is not the
        memory-critical path). The stages of a pipe group hold the same
        rows, so each computes the whole gradient: a stacked leaf's is its
        slice of the gathered leaf's, and a replicated leaf's needs no sum
        over the pipe group."""
        x, rest_keys, rest = self._split_batch(batch)
        if self.input_ndim is not None and x.dim() == self.input_ndim:
            # one micro-batch (the engine's GAS loop): add M = 1
            x = x[None]
            rest = tuple(r[None] for r in rest)
        plan = self._stack_plan(self._pp())
        if plan and self._pp() > 1:
            group = self.topology.group(PIPE_AXIS)
            params = {k: (_map(lambda t: _GatherStack.apply(t, group), v)
                          if k.startswith("stack_") else v)
                      for k, v in params.items()}

        def one(m):
            h = x[m]
            for i in range(len(self.layers)):
                h = self._apply_layer(params, i, h, plan)
            return self.loss_fn(h, dict(zip(rest_keys,
                                            (r[m] for r in rest))))

        return torch.mean(torch.stack([one(m) for m in range(x.shape[0])]))
