"""Versioned weight payloads and the in-place param hot-swap.

A publisher (a training engine, or any holder of a params tree) ships its
weights as a **versioned, chunked, CRC-checked** payload, the frame
discipline of the KV handoff (serve/handoff.py), and a serving engine
ingests it between scheduler steps.

Payload layout (``chunk_weight_leaves``): one header chunk carrying the
version, the leaf manifest (names / shapes) and per-chunk CRC32s, then N
leaf-group chunks. Leaves are packed into size-capped buckets
(``bucket_bytes``) so the publisher gathers and serializes one bucket at a
time. Each chunk is an independent ``.npz`` buffer (handoff's
``_npz_chunk``), so a resend is idempotent and a corrupt chunk fails
typed at its CRC without touching the serving params. Leaves travel as
fp32 numpy under the checkpoint layer's path names
(``checkpoint/state_checkpoint.leaf_paths``).

The swap (:func:`swap_engine_params`) validates the whole payload (leaf
set, every shape) before any leaf changes, then casts each new leaf to the
old leaf's dtype and writes it into the old tensor with an in-place
``copy_``: every leaf keeps its address, so anything that captured it (a
CUDA graph) stays valid. The cast is the one a fresh engine applies at
init, so post-swap streams equal those of a fresh engine built from the
payload. An engine built from a caller's tensors shares them
(``engine_v2._cast_tree`` reuses a tensor already on the device in the
dtype): its first swap gives each such leaf storage of its own, so a swap
never changes another engine's weights.

DELTA payloads (``chunk_weight_deltas``) ship ``current - base``
block-quantized to int8 with fp32 per-block scales
(``comm/quantized._quantize_wire``; on the card the quantizer kernel)
instead of full fp32 leaves, about 4x fewer bytes. The header grows
``payload_kind="delta"``, ``base_version`` and a per-chunk manifest; each
chunk carries the concatenated int8 values and scales of its leaf bucket.
Ingest rebuilds ``base + dequant(delta)`` on the host in numpy fp32
against the fp32 base kept from the last applied payload, then runs the
same swap. A stale base, a version mismatch or a CRC failure raises typed
before any live param is touched (the router then falls back to a full
push). Reconstruction is deterministic numpy, so every replica following
the delta chain holds the same bits as the publisher's ``recon``.
``quant="off"`` ships changed leaves at full fp32 (bitwise-unchanged
leaves are skipped), so reconstruction equals a full push exactly.

ADAPTER payloads (``chunk_adapter_payload``) carry one LoRA adapter on the
same wire: ``payload_kind="adapter"``, the adapter name (the identity the
router and the prefix cache key on) and its scale in the header, each
low-rank pair as two leaves ``path + "::a"`` / ``path + "::b"``. Ingest
installs it in the engine's bank (``engine.load_adapter``, a slot write)
instead of swapping params: ``weight_version`` and the delta base stay.

Port note: ``deepspeed_tpu/inference/v2/serve/weights.py``'s API, function
by function, on the same wire: header keys, leaf names, fp32 leaves and
CRC32 ``.npz`` chunks, so a payload written by either package applies in
the other. JAX swaps by donated buffer replacement (new arrays on the old
shardings); the port copies into the old tensors. Refused here: engines
whose weights rest quantized (``quant_bits``, as in JAX), and a swap into
an SPMD engine (tensor or expert parallel; its followers would have to
mirror it, ROADMAP A15).
"""

import time
import warnings
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch

from .handoff import _chunk_crc, _npz_chunk, parse_chunk, parse_chunk_arrays

_HEADER_KIND = "weights_header"
_CHUNK_KIND = "weights"

# default leaf-group bucket: bounds how much of the model the publisher
# holds gathered at once (and the per-frame wire unit of a remote push)
DEFAULT_BUCKET_BYTES = 16 << 20

SPMD_REFUSAL = (
    "a weight push into an SPMD engine (tensor or expert parallel) is not "
    "ported to deepspeed_tpu_torch yet: the engine group's followers "
    "would have to mirror the swap (ROADMAP A15)")


def _metrics():
    from ....telemetry import get_registry
    reg = get_registry()
    return (
        reg.counter("serving_weight_update_chunks_total",
                    "weight-payload chunks staged by serving runtimes"),
        reg.counter("serving_weight_update_bytes_total",
                    "serialized weight-payload bytes staged",
                    unit="bytes"),
    )


def _wire(kv: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """numpy leaves -> the CPU tensors handoff's chunk codec takes (shared
    memory, no copy)."""
    return {k: torch.from_numpy(v) for k, v in kv.items()}


def flatten_params(tree) -> List[Tuple[str, object]]:
    """``[(path, leaf)]`` of a params tree in the checkpoint layer's
    stable path naming: the one key space the publisher, the payload and
    every ingesting engine share. (The JAX function also returns the
    treedef; a nested dict needs none: :func:`flat_to_tree` rebuilds it
    from the paths.)"""
    from ....checkpoint.state_checkpoint import leaf_paths
    return leaf_paths(tree)


def fetch_leaf(leaf) -> np.ndarray:
    """One leaf as host fp32 numpy, the lossless wire form (16-bit floats
    upcast)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", torch.float32).numpy()
    return np.asarray(leaf, np.float32)


def plan_buckets(items: Sequence[Tuple[str, object]],
                 bucket_bytes: int = DEFAULT_BUCKET_BYTES
                 ) -> List[List[str]]:
    """Group leaf names into size-capped publication buckets (fp32 host
    bytes), preserving tree order: the gather / serialize granularity."""
    bucket_bytes = max(int(bucket_bytes), 1)
    buckets: List[List[str]] = []
    cur: List[str] = []
    cur_bytes = 0
    for name, leaf in items:
        nbytes = int(np.prod(tuple(getattr(leaf, "shape", ())) or (1,))) * 4
        if cur and cur_bytes + nbytes > bucket_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(name)
        cur_bytes += nbytes
    if cur:
        buckets.append(cur)
    return buckets


def chunk_weight_leaves(groups: Iterable[Dict[str, np.ndarray]],
                        version: int) -> List[bytes]:
    """Serialize host leaf groups into the wire payload ``[header,
    chunk...]``. ``groups`` yields ``{name: fp32 array}`` dicts (one per
    publication bucket; tensors are fetched to host fp32)."""
    chunks: List[bytes] = []
    crcs: List[int] = []
    chunk_leaves: List[List[str]] = []
    leaf_meta: Dict[str, dict] = {}
    param_count = 0
    for seq, group in enumerate(groups):
        group = _wire({k: np.ascontiguousarray(fetch_leaf(v))
                       for k, v in group.items()})
        crc = _chunk_crc(group)
        crcs.append(crc)
        chunk_leaves.append(sorted(group))
        for name, t in group.items():
            leaf_meta[name] = {"shape": list(t.shape)}
            param_count += int(t.numel())
        chunks.append(_npz_chunk(
            {"kind": _CHUNK_KIND, "seq": seq, "crc32": crc,
             "version": int(version)}, group))
    header = _npz_chunk(
        {"kind": _HEADER_KIND, "version": int(version),
         "n_chunks": len(chunks), "chunk_crcs": crcs,
         "chunk_leaves": chunk_leaves, "leaf_meta": leaf_meta,
         "param_count": param_count}, {})
    return [header] + chunks


# ---------------------------------------------------------------------------
# Delta payloads (quantized weight-delta publication)
# ---------------------------------------------------------------------------
# delta quant modes: "int8" (block-quantized values + fp32 block scales,
# the comm/quantized wire form) or "off" (changed leaves at full fp32 —
# reconstruction is bitwise-exact)
DELTA_QUANT_MODES = ("int8", "off")
DEFAULT_DELTA_BLOCK = 2048


def _delta_keys(seq: int) -> Tuple[str, str]:
    """The two kv entries of one int8 delta chunk: concatenated quantized
    values and concatenated fp32 block scales. Seq-suffixed so a stager's
    flat leaf map never collides across chunks."""
    return f"__dq{seq}__", f"__ds{seq}__"


def _add_dequant(ref: np.ndarray, q_flat: np.ndarray, s_flat: np.ndarray,
                 numel: int) -> np.ndarray:
    """``ref + dequant(int8 [nb*block], f32 [nb])`` as fp32 of ``ref``'s
    shape: JAX's ``ref + _dequant_leaf(...)``, computed in one buffer (the
    same operations, so the same bits). Plain numpy, so the publisher's
    reference and every ingesting replica reconstruct the same values."""
    nb = int(s_flat.shape[0])
    d = q_flat.reshape(nb, -1).astype(np.float32)
    d *= s_flat.reshape(nb, 1).astype(np.float32, copy=False)
    out = d.reshape(-1)[:numel]
    out += ref.reshape(-1)
    return out.reshape(ref.shape)


def chunk_weight_deltas(flat: Dict[str, np.ndarray],
                        base: Dict[str, np.ndarray], version: int,
                        base_version: int, quant: str = "int8",
                        block: int = DEFAULT_DELTA_BLOCK,
                        bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                        device=None
                        ) -> Tuple[List[bytes], Dict[str, np.ndarray]]:
    """Serialize ``flat - base`` into a DELTA payload ``[header,
    chunk...]``.

    ``base`` is the receivers' reconstruction of ``base_version`` (the
    publisher's error-feedback reference: it tracks the fleet exactly, so
    the residual the quantizer introduced at version k folds into the k+1
    delta). Returns ``(payloads, recon)``, ``recon`` being the fleet's
    exact state after this payload applies: the caller's next reference.
    Each leaf's delta is quantized on ``device`` (``None``: the card, one
    quantizer-kernel launch a leaf; ``"cpu"``: the kernel's plain
    version); the difference and the reconstruction are host numpy."""
    from ....comm.quantized import _quantize_wire
    from ....utils.device import resolve_device

    if quant not in DELTA_QUANT_MODES:
        raise ValueError(
            f"delta quant mode must be one of {DELTA_QUANT_MODES} "
            f"(got {quant!r})")
    if set(flat) != set(base):
        raise ValueError(
            "delta publication leaf set changed vs the base version; "
            "publisher and base must share one model structure")
    dev = resolve_device(device) if quant == "int8" else None
    chunks: List[bytes] = []
    crcs: List[int] = []
    chunk_leaves: List[List[str]] = []
    delta_manifest: List[list] = []
    leaf_meta: Dict[str, dict] = {}
    recon: Dict[str, np.ndarray] = {}
    param_count = 0
    items = list(flat.items())
    for seq, names in enumerate(plan_buckets(items, bucket_bytes)):
        manifest: list = []
        if quant == "off":
            kv: Dict[str, np.ndarray] = {}
            for n in names:
                cur = np.ascontiguousarray(fetch_leaf(flat[n]))
                leaf_meta[n] = {"shape": list(cur.shape)}
                param_count += int(cur.size)
                ref = fetch_leaf(base[n])
                if cur.shape != ref.shape:
                    raise ValueError(
                        f"delta leaf {n!r} shape {cur.shape} != base "
                        f"shape {ref.shape}")
                if np.array_equal(cur, ref):
                    recon[n] = ref     # unchanged: the receiver keeps base
                else:
                    kv[n] = cur
                    # recon must not alias the caller's live array (it
                    # becomes the next error-feedback base)
                    recon[n] = np.array(cur, np.float32)
                    manifest.append(n)
        else:
            qk, sk = _delta_keys(seq)
            qs: List[np.ndarray] = []
            ss: List[np.ndarray] = []
            for n in names:
                cur = fetch_leaf(flat[n])
                ref = fetch_leaf(base[n])
                if cur.shape != ref.shape:
                    raise ValueError(
                        f"delta leaf {n!r} shape {cur.shape} != base "
                        f"shape {ref.shape}")
                leaf_meta[n] = {"shape": list(cur.shape)}
                numel = int(cur.size)
                param_count += numel
                d = np.ascontiguousarray(cur - ref).reshape(-1)
                q, s = _quantize_wire(torch.from_numpy(d).to(dev),
                                      max(1, min(int(block), max(numel, 1))),
                                      "int8")
                q = q.cpu().numpy()
                s = s.cpu().numpy().astype(np.float32)
                manifest.append({"name": n, "numel": numel,
                                 "nb": int(q.shape[0]),
                                 "block": int(q.shape[1])})
                recon[n] = _add_dequant(ref, q.reshape(-1), s.reshape(-1),
                                        numel)
                qs.append(q.reshape(-1))
                ss.append(s.reshape(-1))
            kv = {qk: (np.concatenate(qs) if qs else np.zeros(0, np.int8)),
                  sk: (np.concatenate(ss) if ss
                       else np.zeros(0, np.float32))}
        kv = _wire(kv)
        crc = _chunk_crc(kv)
        crcs.append(crc)
        chunk_leaves.append(sorted(kv))
        delta_manifest.append(manifest)
        chunks.append(_npz_chunk(
            {"kind": _CHUNK_KIND, "seq": seq, "crc32": crc,
             "version": int(version)}, kv))
    header = _npz_chunk(
        {"kind": _HEADER_KIND, "version": int(version),
         "payload_kind": "delta", "base_version": int(base_version),
         "quant": quant, "n_chunks": len(chunks), "chunk_crcs": crcs,
         "chunk_leaves": chunk_leaves,
         "delta_manifest": delta_manifest, "leaf_meta": leaf_meta,
         "param_count": param_count}, {})
    return [header] + chunks, recon


def is_delta_header(header: Dict) -> bool:
    return header.get("payload_kind") == "delta"


def is_delta_payload(payloads: Sequence[bytes]) -> bool:
    return is_delta_header(parse_weights_header(payloads[0]))


def delta_base_version(payloads: Sequence[bytes]) -> int:
    header = parse_weights_header(payloads[0])
    if not is_delta_header(header):
        raise ValueError("not a delta payload (no base_version)")
    return int(header["base_version"])


def reconstruct_delta(header: Dict, staged: Dict[str, np.ndarray],
                      base: Dict[str, np.ndarray]
                      ) -> Dict[str, np.ndarray]:
    """Rebuild the full ``{name: fp32 ndarray}`` map from a staged delta
    payload and the receiver's retained base (``base_version``'s fp32
    leaves). Host numpy, deterministic: every replica applying this
    payload over the same base holds the same bits."""
    quant = header.get("quant", "int8")
    out = dict(base)
    missing = [n for n in header["leaf_meta"] if n not in base]
    if missing:
        raise ValueError(
            f"delta payload names {len(missing)} leaves absent from the "
            f"retained base (first: {missing[:3]})")
    for seq, manifest in enumerate(header["delta_manifest"]):
        if quant == "off":
            for n in manifest:
                out[n] = np.asarray(staged[n], np.float32)
            continue
        qk, sk = _delta_keys(seq)
        q_flat = np.asarray(staged[qk])
        s_flat = np.asarray(staged[sk], np.float32)
        q_off = s_off = 0
        for ent in manifest:
            n, numel = ent["name"], int(ent["numel"])
            nb, blk = int(ent["nb"]), int(ent["block"])
            ref = np.asarray(base[n], np.float32)
            if int(ref.size) != numel:
                raise ValueError(
                    f"delta leaf {n!r} numel {numel} != base "
                    f"{int(ref.size)}")
            q_seg = q_flat[q_off:q_off + nb * blk]
            s_seg = s_flat[s_off:s_off + nb]
            if q_seg.size != nb * blk or s_seg.size != nb:
                raise ValueError(
                    f"delta chunk {seq} truncated at leaf {n!r}")
            out[n] = _add_dequant(ref, q_seg, s_seg, numel)
            q_off += nb * blk
            s_off += nb
    return out


_ADAPTER_A = "::a"
_ADAPTER_B = "::b"


def chunk_adapter_payload(name: str, adapters: Dict[str, tuple],
                          version: int, scale: float = 1.0) -> List[bytes]:
    """Serialize one LoRA adapter (``{"layers/wq": (a, b), ...}``, the
    hybrid engine's external-adapter convention; arrays or tensors) into
    the weights wire ``[header, chunk]`` (JAX :359). Adapters are small
    beside the model: one chunk always holds one."""
    if not str(name):
        raise ValueError("adapter payload requires a non-empty name")
    flat: Dict[str, np.ndarray] = {}
    for path in sorted(adapters):
        a, b = adapters[path]
        flat[path + _ADAPTER_A] = np.ascontiguousarray(fetch_leaf(a))
        flat[path + _ADAPTER_B] = np.ascontiguousarray(fetch_leaf(b))
    kv = _wire(flat)
    crc = _chunk_crc(kv)
    leaf_meta = {n: {"shape": list(v.shape)} for n, v in flat.items()}
    chunk = _npz_chunk(
        {"kind": _CHUNK_KIND, "seq": 0, "crc32": crc,
         "version": int(version)}, kv)
    header = _npz_chunk(
        {"kind": _HEADER_KIND, "version": int(version),
         "payload_kind": "adapter", "adapter_name": str(name),
         "adapter_scale": float(scale), "n_chunks": 1,
         "chunk_crcs": [crc], "chunk_leaves": [sorted(flat)],
         "leaf_meta": leaf_meta,
         "param_count": sum(int(v.size) for v in flat.values())}, {})
    return [header, chunk]


def is_adapter_header(header: Dict) -> bool:
    return header.get("payload_kind") == "adapter"


def is_adapter_payload(payloads: Sequence[bytes]) -> bool:
    return is_adapter_header(parse_weights_header(payloads[0]))


def adapters_from_flat(flat: Dict[str, np.ndarray]) -> Dict[str, tuple]:
    """Regroup staged ``path::a`` / ``path::b`` leaves into the
    ``{path: (a, b)}`` map ``engine.load_adapter`` takes; an unpaired or
    unrecognized leaf raises ``ValueError``."""
    adapters: Dict[str, tuple] = {}
    for n in sorted(flat):
        if n.endswith(_ADAPTER_A):
            path = n[:-len(_ADAPTER_A)]
            bk = path + _ADAPTER_B
            if bk not in flat:
                raise ValueError(
                    f"adapter payload leaf {n!r} has no matching {bk!r} "
                    f"(a/b pairs must travel together)")
            adapters[path] = (flat[n], flat[bk])
        elif not n.endswith(_ADAPTER_B):
            raise ValueError(
                f"adapter payload leaf {n!r} is neither '{_ADAPTER_A}' nor "
                f"'{_ADAPTER_B}' suffixed")
    for n in flat:
        if n.endswith(_ADAPTER_B) and n[:-len(_ADAPTER_B)] not in adapters:
            raise ValueError(
                f"adapter payload leaf {n!r} has no matching "
                f"'{_ADAPTER_A}' half")
    return adapters


def parse_weights_header(buf: bytes) -> Dict:
    d = parse_chunk(buf)["descriptor"]
    if d.get("kind") != _HEADER_KIND:
        raise ValueError(
            f"weight payload must start with the header chunk "
            f"(got kind={d.get('kind')!r})")
    return d


def payload_version(payloads: Sequence[bytes]) -> int:
    return int(parse_weights_header(payloads[0])["version"])


def payload_bytes(payloads: Sequence[bytes]) -> int:
    return sum(len(p) for p in payloads)


class WeightStager:
    """Host-side state machine for one incoming weight payload: feed each
    chunk (CRC-checked, idempotent on a resend), then ``commit_check``;
    ``leaves`` is the complete ``{name: ndarray}`` map for the swap.
    Staging never touches the engine: the swap is the only loop-thread
    moment. Leaves stay read-only views of their chunk buffers."""

    def __init__(self, header: Dict):
        self.header = header
        self.version = int(header["version"])
        self.leaves: Dict[str, np.ndarray] = {}
        self.received: set = set()
        self._m_chunks, self._m_bytes = _metrics()

    def feed(self, chunk_buf: bytes) -> None:
        try:
            chunk = parse_chunk_arrays(chunk_buf)
        except Exception as e:
            # a corrupt buffer can die inside np.load (BadZipFile &c.)
            # before the CRC ever runs: the same typed integrity failure
            raise ValueError(
                f"weights chunk failed to parse (corrupted in transfer): "
                f"{type(e).__name__}: {e}") from e
        d = chunk["descriptor"]
        if d.get("kind") != _CHUNK_KIND:
            raise ValueError(
                f"expected a weights chunk, got {d.get('kind')!r}")
        seq = int(d["seq"])
        if not 0 <= seq < int(self.header["n_chunks"]):
            raise ValueError(
                f"weights chunk seq {seq} outside the header's "
                f"{self.header['n_chunks']} chunks")
        crc = _chunk_crc(chunk["kv"])
        if crc != int(d["crc32"]) \
                or crc != int(self.header["chunk_crcs"][seq]):
            raise ValueError(
                f"weights chunk {seq} failed its crc32 integrity check "
                f"(corrupted in transfer)")
        if sorted(chunk["kv"]) != list(self.header["chunk_leaves"][seq]):
            raise ValueError(
                f"weights chunk {seq} leaf set disagrees with the header "
                f"manifest")
        if any(d not in ("float32", "int8") for d in chunk["dtypes"].values()):
            raise ValueError(f"weights chunk {seq} carries leaves that are "
                             f"neither fp32 nor int8: {chunk['dtypes']}")
        # read-only views of the chunk buffer: nothing is copied until the
        # swap moves each leaf to the engine
        self.leaves.update(chunk["kv"])
        self.received.add(seq)
        self._m_chunks.inc()
        self._m_bytes.inc(len(chunk_buf))

    def missing(self) -> List[int]:
        return [s for s in range(int(self.header["n_chunks"]))
                if s not in self.received]

    def commit_check(self) -> None:
        gaps = self.missing()
        if gaps:
            raise ValueError(
                f"weight payload incomplete: missing chunks {gaps} of "
                f"{self.header['n_chunks']}")


def stage_payload(payloads: Sequence[bytes]) -> WeightStager:
    """Parse and CRC-check a complete payload into a ready stager."""
    stager = WeightStager(parse_weights_header(payloads[0]))
    for chunk in payloads[1:]:
        stager.feed(chunk)
    stager.commit_check()
    return stager


def flat_to_tree(template_tree, flat: Dict[str, np.ndarray]):
    """A host params tree (fp32 numpy leaves) shaped like
    ``template_tree`` from a flat ``{path: ndarray}`` map: a fresh engine
    built from a published payload, the hot-swap's reference."""
    from ....checkpoint.state_checkpoint import tree_from_paths
    items = []
    for name, _ in flatten_params(template_tree):
        if name not in flat:
            raise ValueError(f"weight payload missing leaf {name!r}")
        items.append((name, np.array(flat[name], np.float32)))
    return tree_from_paths(items)


def _set_leaf(tree: dict, name: str, leaf) -> None:
    *parents, last = name.split("/")
    for p in parents:
        tree = tree[p]
    tree[last] = leaf


def swap_engine_params(engine, flat: Dict[str, np.ndarray],
                       version: int) -> None:
    """Write the published leaves into ``engine.params`` (an
    :class:`InferenceEngineV2`) in place: each new leaf is cast to the old
    leaf's dtype and copied into the old tensor, so every leaf keeps its
    address. A leaf the engine borrowed from its caller gets storage of
    its own instead (once). Validation happens before any leaf changes: a
    bad payload leaves the engine serving its current version."""
    if getattr(engine, "_qmeta", None) is not None:
        raise NotImplementedError(
            "weight hot-swap over quant_bits (WOQ) params is not "
            "supported: the quantized leaf layout does not match the "
            "published dense tree")
    if getattr(engine, "topology", None) is not None:
        raise NotImplementedError(SPMD_REFUSAL)
    items = flatten_params(engine.params)
    names = [name for name, _ in items]
    missing = [n for n in names if n not in flat]
    if missing:
        raise ValueError(
            f"weight payload missing {len(missing)} leaves (first: "
            f"{missing[:3]}); publisher and serving engine must share one "
            f"model structure")
    extra = sorted(set(flat) - set(names))
    if extra:
        raise ValueError(
            f"weight payload has {len(extra)} unknown leaves (first: "
            f"{extra[:3]})")
    for name, old in items:
        if tuple(np.shape(flat[name])) != tuple(old.shape):
            raise ValueError(
                f"weight leaf {name!r} shape {tuple(np.shape(flat[name]))} "
                f"!= engine shape {tuple(old.shape)}")
    t0 = time.perf_counter()
    borrowed = getattr(engine, "_borrowed_leaves", set())
    with torch.no_grad(), warnings.catch_warnings():
        # a staged leaf is a read-only view of its chunk buffer; the swap
        # only reads it (torch warns about any non-writable array)
        warnings.filterwarnings("ignore", message=".*not writable")
        for name, old in items:
            new = torch.from_numpy(np.asarray(flat[name], np.float32))
            if name in borrowed:
                _set_leaf(engine.params, name,
                          new.to(device=old.device, dtype=old.dtype,
                                 copy=True))
            else:
                old.copy_(new.to(device=old.device, dtype=old.dtype))
    engine._borrowed_leaves = set()
    engine.weight_version = int(version)
    # the fp32 leaves are the DELTA BASE of the next push: a delta payload
    # reconstructs against exactly these bits (one fp32 host copy of the
    # model per serving engine)
    set_delta_base(engine, flat)
    engine.note_weight_swap(time.perf_counter() - t0)


def set_delta_base(engine, flat: Dict[str, np.ndarray]) -> None:
    """Record ``flat`` (fp32 host leaves) as the engine's delta base: what
    the next delta payload reconstructs against. Called by every ingest
    path (a swap, and the caller of a fresh build from a payload)."""
    engine._weight_flat_base = {
        n: np.asarray(a, np.float32) for n, a in flat.items()}


def delta_base_of(engine):
    """The engine's retained ``{name: fp32 ndarray}`` delta base, or None
    when it never ingested a payload (boot engines cannot take deltas: the
    router falls back to a full push)."""
    return getattr(engine, "_weight_flat_base", None)


def prepare_stager(engine, stager: WeightStager) -> Dict[str, np.ndarray]:
    """The host-side half of ingest: validate and (for deltas) reconstruct
    the full flat leaf map, touching nothing live. A delta validates its
    base version and the retained base before any reconstruction, so a
    stale base fails typed with the live params untouched. Runs off the
    serving loop thread; the returned map goes to
    :func:`swap_engine_params` between scheduler steps."""
    header = stager.header
    if is_adapter_header(header):
        # the pairing is checked here, off the loop thread, so a malformed
        # payload fails before the install; install_stager regroups again
        adapters_from_flat(stager.leaves)
        return stager.leaves
    if not is_delta_header(header):
        return stager.leaves
    base_version = int(header["base_version"])
    live = int(getattr(engine, "weight_version", 0) or 0)
    base = delta_base_of(engine)
    if live != base_version:
        raise ValueError(
            f"delta payload base_version={base_version} does not match the "
            f"live weight_version={live}; a full push is required")
    if base is None:
        raise ValueError(
            "delta payload cannot apply: this engine retains no delta base "
            "(it never ingested a weight payload); a full push is required")
    return reconstruct_delta(header, stager.leaves, base)


def install_stager(engine, stager: WeightStager,
                   flat: Dict[str, np.ndarray]) -> int:
    """The loop-thread half of ingest: swap the prepared leaves into the
    engine, or for an adapter payload install it in the engine's bank
    (``engine.load_adapter``; ``weight_version`` and the delta base stay,
    the base model did not change). The colocated :func:`commit_stager`
    and the serving loop's ``WeightUpdate.commit`` both land here."""
    header = stager.header
    if is_adapter_header(header):
        engine.load_adapter(
            str(header["adapter_name"]), adapters_from_flat(flat),
            scale=float(header.get("adapter_scale", 1.0)))
        return int(stager.version)
    swap_engine_params(engine, flat, stager.version)
    return int(stager.version)


def commit_stager(engine, stager: WeightStager) -> int:
    """The ingest choke point: every path that turns a complete stager
    into live params (colocated :func:`apply_payload`, the serving loop's
    ``WeightUpdate.commit``, the worker's ``/weights`` handler above it)
    lands here, so full, delta and adapter payloads behave alike
    everywhere."""
    flat = prepare_stager(engine, stager)
    return install_stager(engine, stager, flat)


def apply_payload(engine, payloads: Sequence[bytes]) -> int:
    """Stage and swap a complete payload (full or delta) into ``engine``
    synchronously (serving runtimes go through
    :meth:`~.frontend.ServingEngine.begin_weight_update`, so the swap
    lands between scheduler steps). Returns the installed version."""
    return commit_stager(engine, stage_payload(payloads))
