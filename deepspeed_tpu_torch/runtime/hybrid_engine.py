"""Hybrid Engine: the training engine and a colocated serving engine.

Port of ``deepspeed_tpu/runtime/hybrid_engine.py`` (the reference's
DeepSpeedHybridEngine, RLHF): one process owns both halves of an RLHF
actor — the ZeRO train step (``runtime/engine.py``) and the paged serving
engine (``inference/v2``) — and the seam between them is explicit:

* :class:`WeightPublisher` snapshots the training engine's live compute
  params (gathered leaf by leaf through
  ``engine.consolidated_param_buckets``, read-only) into a **versioned,
  chunked, CRC-checked payload** (``inference/v2/serve/weights.py``, the
  wire the JAX package writes and reads).
* The colocated serving engine is a fresh tp 1 / ep 1
  :class:`~..inference.v2.engine_v2.InferenceEngineV2` with device tensors
  of its own, built from the first payload; each later publication is
  copied into its leaves in place (``serve/weights.apply_payload``), so
  its streams equal those of a fresh engine built from the payload.
* :meth:`DeepSpeedHybridEngine.rollout` generates through the serving
  engine's ``put()`` and the scheduler's host sampler
  (``sampling.host_sample`` under a per-prompt ``np.random.default_rng``)
  and feeds ``(prompt, tokens, per-token logprobs)`` into a bounded
  :class:`RolloutQueue`; ``rl/`` is the learner that drains it.
* :meth:`~DeepSpeedHybridEngine.publish_delta` ships the int8 block delta
  against the fleet's reconstruction of the last tracked publication
  (``serve/weights.chunk_weight_deltas``: on the card one quantizer-kernel
  launch a leaf) beside the full payload, and
  :meth:`~DeepSpeedHybridEngine.publish_adapter` a LoRA adapter payload for
  the serving bank; ``router.push_weights`` takes either.

LoRA (reference ``_fuse_lora`` / ``_unfuse_lora``): a subtree shaped
``{"w": [in, out], "lora_a": [in, r], "lora_b": [r, out]}`` fuses to
``w' = w + scale * (a @ b)`` in host fp32 (:func:`_fused_w`, the one
definition every fuse path shares). ``fuse_lora`` keeps the pre-fuse base
beside the fused weight, so ``unfuse_lora`` restores it bit for bit;
publication fuses on the gathered host leaves, never on the live params.
"""

import collections
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.logging import log_dist
from .engine import DeepSpeedTpuEngine

# the pre-fuse base kept inside a fused group: what makes unfuse a bit-exact
# restore instead of a lossy float subtraction
_PRE_FUSE_KEY = "lora_w_prefuse"


def _is_lora_group(node) -> bool:
    return (isinstance(node, dict) and "w" in node and "lora_a" in node
            and "lora_b" in node)


def _host32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, np.float32)


def _fused_w(w, a, b, scale: float):
    """THE fused-weight definition, host fp32 math (JAX :64): every fuse
    path goes through it. A tensor ``w`` gives a tensor of its dtype on
    its device, an array an array of its dtype."""
    out = _host32(w) + float(scale) * (_host32(a) @ _host32(b))
    if isinstance(w, torch.Tensor):
        return torch.from_numpy(out).to(w.device, w.dtype)
    return out.astype(np.asarray(w).dtype, copy=False)


def fuse_lora(params, scale: float = 1.0):
    """Fuse every LoRA group's adapters into its base weight (a pure tree
    transform). The fused group keeps the pre-fuse base under a private
    key so :func:`unfuse_lora` restores it bit for bit; fusing an already
    fused group is a no-op."""
    def walk(node):
        if _is_lora_group(node):
            new = dict(node)
            if _PRE_FUSE_KEY not in node:
                new[_PRE_FUSE_KEY] = node["w"]
                new["w"] = _fused_w(node["w"], node["lora_a"],
                                    node["lora_b"], scale)
            return new
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(params)


def unfuse_lora(params, scale: float = 1.0):
    """Restore every fused group's base weight: the kept pre-fuse base, or
    for a group fused without it the reference's float subtraction."""
    def walk(node):
        if _is_lora_group(node):
            new = dict(node)
            if _PRE_FUSE_KEY in new:
                new["w"] = new.pop(_PRE_FUSE_KEY)
            else:
                new["w"] = _fused_w(node["w"], node["lora_a"],
                                    node["lora_b"], -scale)
            return new
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(params)


def _lora_groups_flat(names: Iterable[str]) -> Dict[str, Dict[str, str]]:
    """LoRA groups in flat leaf-path space: ``{prefix: {"w": path, "a":
    path, "b": path}}`` for every complete ``prefix/{w,lora_a,lora_b}``."""
    groups: Dict[str, Dict[str, str]] = {}
    for n in names:
        head, _, tail = n.rpartition("/")
        key = {"w": "w", "lora_a": "a", "lora_b": "b"}.get(tail)
        if key is not None:
            groups.setdefault(head, {})[key] = n
    return {p: g for p, g in groups.items() if set(g) == {"w", "a", "b"}}


def fuse_flat_leaves(flat: Dict[str, np.ndarray], scale: float = 1.0,
                     adapters: Optional[Dict[str, Tuple[np.ndarray,
                                                        np.ndarray]]] = None
                     ) -> Dict[str, np.ndarray]:
    """Host-side fusion over published flat leaves: each in-tree LoRA
    group's ``w`` becomes its fused form (the adapter leaves stay, so the
    serving tree matches the training tree), and each external adapter
    (``{leaf_path: (a, b)}``, not part of the param tree) fuses into its
    named leaf."""
    out = dict(flat)
    for g in _lora_groups_flat(flat).values():
        out[g["w"]] = _fused_w(flat[g["w"]], flat[g["a"]], flat[g["b"]],
                               scale)
    for name, (a, b) in (adapters or {}).items():
        if name not in out:
            raise ValueError(
                f"external LoRA adapter targets unknown leaf {name!r}")
        out[name] = _fused_w(out[name], a, b, scale)
    return out


# ---------------------------------------------------------------------------
# Weight publication (the training side of serve/weights.py)
# ---------------------------------------------------------------------------
class WeightPublication:
    """One publication's payloads: ``full`` (fp32, chunked: every ingest
    path takes it) and ``delta`` (when the publisher tracked a base: the
    int8 block delta against ``base_version``, about 4x fewer bytes).
    ``router.push_weights`` takes this object and picks per replica."""

    __slots__ = ("full", "delta", "version", "base_version")

    def __init__(self, full: List[bytes], delta: Optional[List[bytes]],
                 version: int, base_version: Optional[int]):
        self.full = full
        self.delta = delta
        self.version = int(version)
        self.base_version = (None if base_version is None
                             else int(base_version))

    @property
    def full_bytes(self) -> int:
        return sum(len(p) for p in self.full)

    @property
    def delta_bytes(self) -> Optional[int]:
        return (None if self.delta is None
                else sum(len(p) for p in self.delta))

    @property
    def wire_ratio(self) -> Optional[float]:
        """Full fp32 bytes over delta bytes: the delta's wire win."""
        if self.delta is None:
            return None
        return self.full_bytes / max(self.delta_bytes, 1)


class WeightPublisher:
    """Versioned snapshots of a training engine's live params.

    ``source`` is a :class:`~.engine.DeepSpeedTpuEngine` (gathered through
    ``consolidated_param_buckets``) or any params tree of tensors or arrays.
    Each :meth:`snapshot` bumps the version and returns the chunked payload
    (``[header, chunk...]``) that ``ServingEngine.apply_weights`` /
    ``router.push_weights`` ingest. ``device`` is where a delta's int8
    quantization runs (``None``: the card)."""

    def __init__(self, source, bucket_bytes: int = 16 << 20,
                 lora_scale: float = 1.0, track_deltas: bool = True,
                 delta_quant: str = "int8", delta_block: int = 2048,
                 device=None):
        self.source = source
        self.bucket_bytes = max(int(bucket_bytes), 1)
        self.lora_scale = float(lora_scale)
        self.version = 0
        # the error-feedback reference: the receivers' bit-exact
        # reconstruction of the last tracked publication, so delta k+1 =
        # current - ref_k folds the k-th quantization's residual back onto
        # the wire (one fp32 host copy of the model while tracking)
        self.track_deltas = bool(track_deltas)
        self.delta_quant = str(delta_quant)
        self.delta_block = int(delta_block)
        self.device = device
        self._delta_ref: Optional[Dict[str, np.ndarray]] = None
        self._delta_ref_version: Optional[int] = None
        from ..telemetry import get_registry
        reg = get_registry()
        self._m_publishes = reg.counter(
            "training_weight_publishes_total",
            "weight snapshots published by the training engine")
        self._m_publish_time = reg.histogram(
            "training_weight_publish_seconds",
            "gather + serialize time of one weight publication",
            unit="s", buckets=(1e-2, 0.1, 1.0, 10.0, 60.0, 600.0))
        self._m_publish_bytes = reg.counter(
            "training_weight_publish_bytes_total",
            "serialized weight-payload bytes published", unit="bytes")
        self._m_version = reg.gauge(
            "training_weight_version",
            "version of the newest published weight snapshot")
        self._m_delta_publishes = reg.counter(
            "weight_delta_publishes_total",
            "publications that emitted a quantized delta payload")
        self._m_delta_bytes = reg.counter(
            "weight_delta_bytes_total",
            "serialized delta-payload bytes published", unit="bytes")
        self._m_delta_ratio = reg.gauge(
            "weight_delta_wire_ratio",
            "full fp32 payload bytes / delta payload bytes of the "
            "newest delta publication (the wire win)")
        self._m_delta_residual = reg.gauge(
            "weight_delta_residual_norm",
            "l2 norm of the publisher-side error-feedback residual "
            "(live params minus the receivers' reconstruction) after "
            "the newest delta publication")

    @property
    def delta_ref_version(self) -> Optional[int]:
        """Version of the error-feedback reference: the ``delta_base`` the
        next :meth:`publish` can delta against (None until a tracked
        publication)."""
        return self._delta_ref_version

    def _iter_buckets(self) -> Iterable[Dict[str, np.ndarray]]:
        src = self.source
        if hasattr(src, "consolidated_param_buckets"):
            yield from src.consolidated_param_buckets(self.bucket_bytes)
            return
        from ..inference.v2.serve import weights as serve_weights
        items = serve_weights.flatten_params(src)
        leaves = dict(items)
        for names in serve_weights.plan_buckets(items, self.bucket_bytes):
            yield {n: serve_weights.fetch_leaf(leaves[n]) for n in names}

    def _gather(self, fuse_lora: bool, scale: float, adapters
                ) -> Dict[str, np.ndarray]:
        flat: Dict[str, np.ndarray] = {}
        for group in self._iter_buckets():
            flat.update(group)
        if fuse_lora or adapters:
            flat = fuse_flat_leaves(flat, scale, adapters)
        return flat

    def _observe(self, t0: float, nbytes: int) -> float:
        dt = time.perf_counter() - t0
        self._m_publishes.inc()
        self._m_publish_time.observe(dt)
        self._m_publish_bytes.inc(nbytes)
        self._m_version.set(self.version)
        return dt

    def snapshot(self, fuse_lora: bool = False,
                 lora_scale: Optional[float] = None,
                 adapters: Optional[Dict[str, Tuple[np.ndarray,
                                                    np.ndarray]]] = None
                 ) -> List[bytes]:
        """Gather and serialize one publication; returns the payload.

        ``fuse_lora=True`` (or external ``adapters``) fuses adapters into
        their base weights on the gathered host leaves (the live params are
        never modified). An unfused snapshot streams bucket by bucket, so it
        keeps no delta reference: it INVALIDATES the current one (the next
        :meth:`publish` re-anchors with a full tracked publication)."""
        from ..inference.v2.serve import weights as serve_weights
        from ..telemetry import recorder as flight
        t0 = time.perf_counter()
        self.version += 1
        self._delta_ref = None
        self._delta_ref_version = None
        scale = self.lora_scale if lora_scale is None else float(lora_scale)
        if fuse_lora or adapters:
            # fusion needs whole groups (and external adapters their
            # target leaf): stage the full flat map before chunking
            fused = self._gather(True, scale, adapters)
            buckets = serve_weights.plan_buckets(list(fused.items()),
                                                 self.bucket_bytes)
            payloads = serve_weights.chunk_weight_leaves(
                ({n: fused[n] for n in names} for names in buckets),
                self.version)
        else:
            payloads = serve_weights.chunk_weight_leaves(
                self._iter_buckets(), self.version)
        nbytes = serve_weights.payload_bytes(payloads)
        dt = self._observe(t0, nbytes)
        flight.record("weight_publish", version=self.version, bytes=nbytes,
                      chunks=len(payloads) - 1,
                      fused=bool(fuse_lora or adapters),
                      dur_s=round(dt, 4))
        return payloads

    def publish(self, delta_base: Optional[int] = None,
                quant: Optional[str] = None, block: Optional[int] = None,
                fuse_lora: bool = False,
                lora_scale: Optional[float] = None,
                adapters: Optional[Dict[str, Tuple[np.ndarray,
                                                   np.ndarray]]] = None
                ) -> WeightPublication:
        """Delta-aware publication: one gather gives the full fp32 payload
        and, when ``delta_base`` names the error-feedback reference's
        version, the block-quantized delta against it. The reference tracks
        the receivers' reconstruction, so successive deltas cannot drift. A
        ``delta_base`` that is not the reference's raises ``ValueError``
        (publish full, ``delta_base=None``, to re-anchor). With
        ``track_deltas`` off this is a plain full publication."""
        from ..inference.v2.serve import weights as serve_weights
        from ..telemetry import recorder as flight
        t0 = time.perf_counter()
        scale = self.lora_scale if lora_scale is None else float(lora_scale)
        quant = self.delta_quant if quant is None else str(quant)
        block = self.delta_block if block is None else int(block)
        if delta_base is not None:
            if not self.track_deltas:
                raise ValueError("delta_base given but this publisher has "
                                 "track_deltas disabled")
            if self._delta_ref is None \
                    or int(delta_base) != self._delta_ref_version:
                raise ValueError(
                    f"delta_base={int(delta_base)} does not match the "
                    f"publisher's error-feedback reference version "
                    f"{self._delta_ref_version}; publish full "
                    f"(delta_base=None) to re-anchor")
        flat = {n: np.ascontiguousarray(np.asarray(v, np.float32))
                for n, v in self._gather(fuse_lora, scale,
                                         adapters).items()}
        self.version += 1
        buckets = serve_weights.plan_buckets(list(flat.items()),
                                             self.bucket_bytes)
        full = serve_weights.chunk_weight_leaves(
            ({n: flat[n] for n in names} for names in buckets),
            self.version)
        delta = residual = None
        if delta_base is not None:
            delta, recon = serve_weights.chunk_weight_deltas(
                flat, self._delta_ref, self.version, int(delta_base),
                quant=quant, block=block, bucket_bytes=self.bucket_bytes,
                device=self.device)
            self._delta_ref = recon
            self._delta_ref_version = self.version
            residual = float(np.sqrt(sum(
                float(np.sum((flat[n] - recon[n]).astype(np.float64) ** 2))
                for n in flat)))
            self._m_delta_publishes.inc()
        elif self.track_deltas:
            # a full tracked publish: receivers applying it hold exactly
            # these bits, the next delta's base. The reference owns its
            # bytes (a gathered leaf can share a live fp32 CPU param's)
            self._delta_ref = {n: np.array(v, np.float32)
                               for n, v in flat.items()}
            self._delta_ref_version = self.version
        pub = WeightPublication(full, delta, self.version,
                                None if delta is None else int(delta_base))
        dt = self._observe(t0, pub.full_bytes)
        if delta is not None:
            self._m_delta_bytes.inc(pub.delta_bytes)
            self._m_delta_ratio.set(pub.wire_ratio)
            self._m_delta_residual.set(residual)
        flight.record("weight_publish", version=self.version,
                      bytes=pub.full_bytes, chunks=len(full) - 1,
                      fused=bool(fuse_lora or adapters),
                      delta_bytes=pub.delta_bytes,
                      delta_base=pub.base_version, dur_s=round(dt, 4))
        return pub


# ---------------------------------------------------------------------------
# Rollouts (the serving -> training direction of the seam)
# ---------------------------------------------------------------------------
class RolloutSample:
    """One generated rollout, the RLHF actor loop's unit. ``reward`` is set
    by the loop's reward hook after generation (a scalar sequence reward, or
    one per generated token); ``done`` marks the episode finished at the
    sequence end. Queue and loop share the object, so a hook's write is
    what the learner pops."""

    __slots__ = ("prompt", "tokens", "logprobs", "weight_version", "seed",
                 "reward", "done")

    def __init__(self, prompt: List[int], tokens: List[int],
                 logprobs: List[float], weight_version: int,
                 seed: Optional[int], reward=None, done: bool = True):
        self.prompt = prompt
        self.tokens = tokens
        self.logprobs = logprobs
        self.weight_version = weight_version
        self.seed = seed
        self.reward = reward
        self.done = bool(done)


class RolloutQueue:
    """Bounded rollout -> training queue: the oldest samples drop (counted)
    when the learner falls behind, so host memory never grows behind a
    slow train step."""

    def __init__(self, maxlen: int = 64):
        self.maxlen = max(int(maxlen), 1)
        self._q: "collections.deque" = collections.deque()
        self._lock = threading.Lock()
        self._depth = 0
        from ..telemetry import get_registry
        reg = get_registry()
        self._m_depth = reg.gauge(
            "hybrid_rollout_queue_depth",
            "rollouts waiting in the bounded training queue")
        self._m_dropped = reg.counter(
            "hybrid_rollout_queue_dropped_total",
            "rollouts dropped oldest-first because the bounded queue "
            "was full (the learner fell behind the actor)")

    def _set_depth(self, n: int) -> None:
        self._depth = n
        self._m_depth.set(n)

    @property
    def depth(self) -> int:
        """Lock-free depth (the last value the gauge path published), for
        the learner's backpressure check; ``len(queue)`` is the locked
        exact read."""
        return self._depth

    def push(self, sample: RolloutSample) -> None:
        with self._lock:
            self._q.append(sample)
            while len(self._q) > self.maxlen:
                self._q.popleft()
                self._m_dropped.inc()
            self._set_depth(len(self._q))

    def pop(self, n: int = 1) -> List[RolloutSample]:
        """Up to ``n`` oldest samples (the next training micro-batch)."""
        out: List[RolloutSample] = []
        with self._lock:
            while self._q and len(out) < n:
                out.append(self._q.popleft())
            self._set_depth(len(self._q))
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)


def _host_logprob(logits: np.ndarray, token: int) -> float:
    """log softmax(logits)[token] in stable host math: the per-token policy
    logprob a rollout records."""
    x = np.asarray(logits, np.float32)
    m = float(x.max())
    return float(x[token] - (m + np.log(np.exp(x - m).sum())))


# ---------------------------------------------------------------------------
# The hybrid engine
# ---------------------------------------------------------------------------
class DeepSpeedHybridEngine(DeepSpeedTpuEngine):
    """Training engine plus a colocated paged serving engine on published
    weights (module docstring). ``deepspeed_tpu_torch.initialize`` returns
    it when the config has ``hybrid_engine.enabled``; at N data-parallel
    ranks every rank publishes (the gather is collective) and serves its
    own copy."""

    def __init__(self, *args, lora_scale: float = 1.0, serving_model=None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        hy = self.config.hybrid_engine
        self.lora_scale = float(lora_scale)
        # external adapters ({flat leaf path: (lora_a, lora_b)} host
        # arrays), fused into the named leaves at publish time
        self.lora_adapters: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        self.publisher = WeightPublisher(
            self, bucket_bytes=hy.publish_bucket_bytes,
            lora_scale=lora_scale, track_deltas=hy.delta_publish,
            delta_quant=hy.delta_quant, delta_block=hy.delta_block,
            device=self.device)
        self.rollout_queue = RolloutQueue(hy.rollout_queue_size)
        self._serving_model = serving_model
        self._serving = None
        self._published_at: Optional[Tuple[int, int]] = None
        self._rollout_uid = 1 << 20   # clear of serving-runtime uids
        self.latency_stats = {"generate_calls": 0, "generate_seconds": 0.0,
                              "generated_tokens": 0}
        from ..telemetry import get_registry
        reg = get_registry()
        self._m_rollouts = reg.counter(
            "hybrid_rollouts_total",
            "rollouts generated by the hybrid engine's serving half")
        self._m_rollout_tokens = reg.counter(
            "hybrid_rollout_tokens_total",
            "tokens generated across hybrid rollouts")
        log_dist("hybrid engine ready (train step + paged serving on "
                 "published weights)", ranks=[0])

    # -- the colocated serving engine -----------------------------------
    @property
    def weight_version(self) -> int:
        return self.publisher.version

    @property
    def serving_engine(self):
        """The colocated :class:`InferenceEngineV2` (built on first use,
        always serving the newest publication)."""
        self._ensure_current()
        return self._serving

    def _serving_spec(self) -> Dict[str, Dict[str, Any]]:
        cfg = getattr(self.model, "cfg", None)
        assert cfg is not None, \
            "hybrid engine needs an inference/v2-capable model (a " \
            "TransformerLM-style .cfg); pass serving_model= for custom " \
            "models"
        overrides = dict(self.config.hybrid_engine.serving or {})
        sm = {"max_tracked_sequences": 8,
              "max_seq_len": int(cfg.max_seq_len), "block_size": 16}
        sm["num_blocks"] = (sm["max_tracked_sequences"]
                            * -(-sm["max_seq_len"] // sm["block_size"]) + 1)
        sm.update(overrides.get("state_manager", {}))
        eng = {"dtype": self.ds_config.precision_dtype, "prefill_bucket": 16}
        eng.update(overrides.get("engine", {}))
        return {"state_manager": sm, "engine": eng}

    def _build_serving(self, payloads: List[bytes]):
        from ..inference.v2 import (InferenceEngineV2,
                                    RaggedInferenceEngineConfig)
        from ..inference.v2.config_v2 import DSStateManagerConfig
        from ..inference.v2.serve import weights as serve_weights
        spec = self._serving_spec()
        model = self._serving_model
        if model is None:
            # a fresh model instance: the serving engine is tp 1 / ep 1,
            # and the training model carries the train topology
            model = type(self.model)(self.model.cfg)
        stager = serve_weights.stage_payload(payloads)
        host_tree = serve_weights.flat_to_tree(self.params, stager.leaves)
        engine = InferenceEngineV2(
            model, RaggedInferenceEngineConfig(
                state_manager=DSStateManagerConfig(**spec["state_manager"]),
                **spec["engine"]),
            params=host_tree, device=self.device)
        engine.weight_version = stager.version
        # the fresh engine keeps its payload's fp32 leaves as the delta
        # base, as a swap would
        serve_weights.set_delta_base(engine, stager.leaves)
        return engine

    def _ensure_current(self) -> None:
        """Publish on demand: the serving engine always generates with the
        current training weights (the reference generate() contract)."""
        stamp = (self.global_steps, self.micro_steps)
        if self._published_at != stamp or self._serving is None:
            self.publish()

    # -- publication -----------------------------------------------------
    def has_lora(self) -> bool:
        def walk(node) -> bool:
            if _is_lora_group(node):
                return True
            return isinstance(node, dict) and any(
                walk(v) for v in node.values())

        return walk(self.params if isinstance(self.params, dict) else {}) \
            or bool(self.lora_adapters)

    def _adapters_for(self, fuse_lora: bool):
        return (self.lora_adapters or None) if fuse_lora else None

    def publish(self, fuse_lora: Optional[bool] = None) -> List[bytes]:
        """Snapshot the live training params into a versioned payload,
        install it in the colocated serving engine and return it for fleet
        distribution (``router.push_weights``). ``fuse_lora`` defaults to
        fused whenever the params carry LoRA groups or external adapters
        are attached."""
        from ..inference.v2.serve import weights as serve_weights
        if fuse_lora is None:
            fuse_lora = self.has_lora()
        payloads = self.publisher.snapshot(
            fuse_lora=fuse_lora, adapters=self._adapters_for(fuse_lora))
        self._published_at = (self.global_steps, self.micro_steps)
        # the payload is not kept here (an fp32 copy of the model): the
        # serving engine holds the installed weights, the caller the payload
        if self._serving is None:
            self._serving = self._build_serving(payloads)
        else:
            serve_weights.apply_payload(self._serving, payloads)
        return payloads

    def publish_delta(self, fuse_lora: Optional[bool] = None,
                      quant: Optional[str] = None,
                      block: Optional[int] = None) -> WeightPublication:
        """Delta-aware publication (the RLHF publish-every-N path): one
        gather gives the full payload and, once a tracked base exists, the
        int8 block delta against it. The colocated serving engine ingests
        the delta when there is one, so its weights stay those of every
        replica following the delta chain."""
        from ..inference.v2.serve import weights as serve_weights
        if fuse_lora is None:
            fuse_lora = self.has_lora()
        pub = self.publisher.publish(
            delta_base=self.publisher.delta_ref_version, quant=quant,
            block=block, fuse_lora=fuse_lora,
            adapters=self._adapters_for(fuse_lora))
        self._published_at = (self.global_steps, self.micro_steps)
        if self._serving is None:
            self._serving = self._build_serving(pub.full)
        else:
            serve_weights.apply_payload(
                self._serving,
                pub.delta if pub.delta is not None else pub.full)
        return pub

    def publish_adapter(self, name: str, adapters=None,
                        scale: Optional[float] = None) -> List[bytes]:
        """Package a trained LoRA adapter as a versioned ADAPTER payload
        (``serve/weights.chunk_adapter_payload``), install it in the
        colocated serving engine's bank when it has one, and return it for
        the fleet (``router.push_weights`` routes it to ``push_adapter``).
        ``adapters`` defaults to the attached external adapters
        (``{path: (lora_a, lora_b)}``), ``scale`` to ``lora_scale``. The
        adapter is not fused: it stays a bank slot's delta."""
        from ..inference.v2.serve import weights as serve_weights
        if adapters is None:
            adapters = dict(self.lora_adapters)
        if not adapters:
            raise ValueError(
                "no adapter leaves to publish: pass adapters= or attach "
                "external adapters first")
        if scale is None:
            scale = self.lora_scale
        self.publisher.version += 1
        payloads = serve_weights.chunk_adapter_payload(
            name, adapters, self.publisher.version, scale=float(scale))
        if (self._serving is not None
                and getattr(self._serving, "lora_bank", None) is not None):
            serve_weights.apply_payload(self._serving, payloads)
        return payloads

    # -- generation (reference hybrid_engine.generate) -------------------
    def generate(self, input_ids, max_new_tokens: int = 32,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 0.0, eos_token_id: Optional[int] = None,
                 seed: int = 0, **_kw) -> np.ndarray:
        """Generate with the current training weights through the paged
        serving engine, returning ``[B, prompt + new]`` ids (padded with
        ``eos_token_id`` or 0). Republishes after training steps."""
        self._ensure_current()
        ids = np.asarray(input_ids)
        if ids.ndim == 1:
            ids = ids[None]
        t0 = time.perf_counter()
        outs = self._serving.generate(
            [list(map(int, row)) for row in ids],
            max_new_tokens=int(max_new_tokens), eos_token_id=eos_token_id,
            temperature=float(temperature),
            top_p=float(top_p) if top_p > 0 else 1.0, top_k=int(top_k),
            seed=int(seed))
        dt = time.perf_counter() - t0
        width = ids.shape[1] + int(max_new_tokens)
        pad = eos_token_id if eos_token_id is not None else 0
        full = np.full((len(outs), width), pad, ids.dtype)
        generated = 0
        for i, row in enumerate(outs):
            row = np.asarray(row)[:width]
            full[i, :len(row)] = row
            generated += len(row) - ids.shape[1]
        self.latency_stats["generate_calls"] += 1
        self.latency_stats["generate_seconds"] += dt
        self.latency_stats["generated_tokens"] += int(generated)
        return full

    # -- rollouts (serving -> training) ----------------------------------
    def rollout(self, prompts: Sequence[Sequence[int]],
                max_new_tokens: int = 32, temperature: float = 0.0,
                top_p: float = 1.0, top_k: int = 0,
                seed: Optional[int] = 0, eos_token_id: Optional[int] = None,
                enqueue: bool = True,
                allow_stale: bool = False) -> List[RolloutSample]:
        """Generate rollouts and feed the bounded training queue.

        Tokens come from the serving engine's ``put()`` logits, sampled by
        ``sampling.host_sample`` under a per-prompt
        ``np.random.default_rng(seed + row)``: the serving scheduler's draw,
        so a rollout's stream equals the same request served by the serving
        runtime (and the JAX package's rollout). Each logprob is the policy
        log-softmax of the sampled token, from the logits that sampled it.
        ``allow_stale`` skips the publish-on-demand and acts on the last
        published weights (the actor-learner loop's publish-every-N
        cadence; samples carry ``weight_version``)."""
        from ..inference.v2.sampling import host_sample
        if not (allow_stale and self._serving is not None):
            self._ensure_current()
        eng = self._serving
        samples: List[RolloutSample] = []
        for row_i, prompt in enumerate(prompts):
            prompt = list(map(int, prompt))
            row_seed = None if seed is None else int(seed) + row_i
            rng = np.random.default_rng(row_seed)
            uid = self._rollout_uid
            self._rollout_uid += 1
            toks: List[int] = []
            lps: List[float] = []
            logits = np.asarray(
                eng.put([uid], [np.asarray(prompt, np.int64)])[0],
                np.float32)
            try:
                for i in range(int(max_new_tokens)):
                    tok = int(host_sample(logits, rng, temperature, top_p,
                                          top_k))
                    toks.append(tok)
                    lps.append(_host_logprob(logits, tok))
                    if eos_token_id is not None and tok == eos_token_id:
                        break
                    if i + 1 < int(max_new_tokens):
                        logits = np.asarray(eng.put([uid], [[tok]])[0],
                                            np.float32)
            finally:
                eng.flush(uid)
            sample = RolloutSample(prompt, toks, lps, self.weight_version,
                                   row_seed)
            samples.append(sample)
            if enqueue:
                self.rollout_queue.push(sample)
            self._m_rollouts.inc()
            self._m_rollout_tokens.inc(len(toks))
        return samples

    # -- misc ------------------------------------------------------------
    def attach_lora_adapter(self, leaf_path: str, lora_a, lora_b) -> None:
        """Register an external adapter for ``leaf_path`` (a flat param
        path, ``serve/weights.flatten_params``): publication fuses it into
        that leaf. The next generate() republishes."""
        self.lora_adapters[str(leaf_path)] = (
            np.asarray(lora_a, np.float32), np.asarray(lora_b, np.float32))
        self._published_at = None

    def eval(self):
        return self

    def train(self, mode: bool = True):
        return self
