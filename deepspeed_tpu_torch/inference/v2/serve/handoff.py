"""Paged-KV export and restore: the wire format the KV spill tier rides.

Port of ``deepspeed_tpu/inference/v2/serve/handoff.py``. A sequence's KV
blocks leave an engine as a self-describing ``.npz`` buffer (a JSON
descriptor plus one array per pool leaf, ``[num_layers, n_blocks, ...]``,
the blocks gathered along the pool's block axis) and enter another pool
under freshly allocated block ids. The int8 pool (``kv_quant``) moves its
per-(block, kv head) scale leaves the same way, so its pages pair with
their exact scales. Content is copied bit for bit.

Chunked form (:func:`export_chunks`): one header chunk (descriptor and
manifest: ranges and per-chunk CRC32s over the leaves' raw bytes) and one
chunk per block range; :class:`ChunkedRestore` adopts the blocks, applies
chunks one at a time (CRC-checked, idempotent on a resend) and frees the
blocks without indexing them if the transfer is aborted.

The buffers are the JAX package's: the same descriptor keys, leaf names,
dtype names, and 16-bit float leaves shipped as their raw bytes (uint8)
and viewed back on the far side, so a buffer written by either package
restores into the other. The block gather is an index select and the
scatter an in-place ``index_copy_`` into the pool; scatter shapes are
padded to a power of two of the block count with rows aimed at the null
block carrying zeros, as in JAX (the null block is never read unmasked).

The serving frontend's and loop's entry points into it (``resume``,
``begin_handoff``, ``begin_restore``) belong to the fleet (ROADMAP A7)
and still raise there; the spill tier (``ragged/spill.py``) uses the
chunk codec and the block copies.
"""

import io
import json
import zlib
from typing import Dict, List

import numpy as np
import torch

from ....utils.bucketing import pow2_bucket
from ..ragged.blocked_allocator import NULL_BLOCK

_DESCRIPTOR_KEY = "__descriptor__"

_DTYPE_NAMES = {torch.float32: "float32", torch.float16: "float16",
                torch.bfloat16: "bfloat16", torch.int8: "int8",
                torch.uint8: "uint8", torch.int32: "int32"}
_DTYPES = {v: k for k, v in _DTYPE_NAMES.items()}


def _gather_blocks(leaf: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``leaf[:, idx]``: the blocks' rows of every layer."""
    return leaf.index_select(1, idx)


def _scatter_blocks(leaf: torch.Tensor, idx: torch.Tensor,
                    data: torch.Tensor) -> torch.Tensor:
    """``leaf[:, idx] = data`` in place. Pad rows all target the null block
    with the same (zero) data, so a repeated index writes one value."""
    leaf.index_copy_(1, idx, data)
    return leaf


def _wire_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown KV wire dtype {name!r}") from None


def _to_wire(t: torch.Tensor) -> np.ndarray:
    """A leaf as the array that goes into the buffer: its values, or, for
    a 16-bit float that numpy cannot hold, its raw bytes."""
    t = t.detach().to("cpu").contiguous()
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.view(torch.uint8).numpy()
    return t.numpy()


def _from_wire(arr: np.ndarray, want: str) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr, copy=True))
    dtype = _wire_dtype(want)
    if t.dtype != dtype:
        t = t.view(dtype)
    return t


def export_sequence(engine, uid: int, trace_ctx=None) -> Dict:
    """Snapshot ``uid``'s KV blocks and descriptor into a host pack (CPU
    tensors and ints). The sequence stays live on ``engine``."""
    sm = engine.state_manager
    seq = sm.seqs.get(uid)
    if seq is None:
        raise ValueError(f"cannot export uid {uid}: unknown sequence")
    blocks = [int(b) for b in seq.blocks]
    nb = len(blocks)
    idx = torch.tensor(blocks, dtype=torch.long, device=engine.device)
    kv = {key: _gather_blocks(leaf, idx).to("cpu")
          for key, leaf in engine.kv_cache.items()}
    pack = {
        "uid": int(uid),
        "seen_tokens": int(seq.seen_tokens),
        "n_blocks": nb,
        "block_size": int(sm.block_size),
        "token_log": [int(t) for t in seq.token_log],
        "kv": kv,
    }
    if trace_ctx is not None:
        pack["trace"] = trace_ctx.to_wire()
    return pack


def _npz(descriptor: Dict, kv: Dict[str, torch.Tensor]) -> bytes:
    kv_wire, kv_dtypes = {}, {}
    for key, t in kv.items():
        kv_dtypes[key] = _DTYPE_NAMES[t.dtype]
        kv_wire[f"kv_{key}"] = _to_wire(t)
    descriptor = dict(descriptor, kv_dtypes=kv_dtypes)
    bio = io.BytesIO()
    np.savez(bio,
             **{_DESCRIPTOR_KEY: np.frombuffer(
                 json.dumps(descriptor).encode(), np.uint8)},
             **kv_wire)
    return bio.getvalue()


def serialize(pack: Dict) -> bytes:
    """Pack -> one self-describing ``.npz`` buffer (the wire format)."""
    descriptor = {k: pack[k] for k in
                  ("uid", "seen_tokens", "n_blocks", "block_size",
                   "token_log", "trace") if k in pack}
    return _npz(descriptor, pack["kv"])


def _load(buf: bytes):
    with np.load(io.BytesIO(buf)) as z:
        descriptor = json.loads(bytes(z[_DESCRIPTOR_KEY]).decode())
        dtypes = descriptor.pop("kv_dtypes", {})
        kv = {}
        for name in z.files:
            if name.startswith("kv_"):
                key = name[3:]
                kv[key] = _from_wire(z[name],
                                     dtypes.get(key, z[name].dtype.name))
    return descriptor, kv


def deserialize(buf: bytes) -> Dict:
    pack, kv = _load(buf)
    pack["kv"] = kv
    return pack


# ---------------------------------------------------------------------------
# chunked form
# ---------------------------------------------------------------------------
def _leaf_wire_bytes(t: torch.Tensor) -> bytes:
    return _to_wire(t).tobytes()


def _chunk_crc(kv: Dict[str, torch.Tensor]) -> int:
    crc = 0
    for key in sorted(kv):
        crc = zlib.crc32(_leaf_wire_bytes(kv[key]), crc)
    return crc


def _npz_chunk(descriptor: Dict, kv: Dict[str, torch.Tensor]) -> bytes:
    """One self-describing chunk buffer."""
    return _npz(descriptor, kv)


def parse_chunk(buf: bytes) -> Dict:
    """Chunk buffer -> ``{"descriptor": ..., "kv": {...}}`` with the wire
    dtypes restored."""
    descriptor, kv = _load(buf)
    return {"descriptor": descriptor, "kv": kv}


def chunk_pack(pack: Dict, chunk_blocks: int) -> List[bytes]:
    """Split one exported pack into ``[header, kv-chunk...]`` buffers."""
    chunk_blocks = max(1, int(chunk_blocks))
    nb = int(pack["n_blocks"])
    ranges = [(i, min(i + chunk_blocks, nb))
              for i in range(0, nb, chunk_blocks)]
    chunks: List[bytes] = []
    crcs: List[int] = []
    for seq, (i, j) in enumerate(ranges):
        kv = {key: t[:, i:j].contiguous() for key, t in pack["kv"].items()}
        crc = _chunk_crc(kv)
        crcs.append(crc)
        chunks.append(_npz_chunk(
            {"kind": "kv", "uid": int(pack["uid"]), "seq": seq,
             "block_start": i, "block_end": j, "crc32": crc}, kv))
    header = {k: pack[k] for k in
              ("uid", "seen_tokens", "n_blocks", "block_size",
               "token_log", "trace") if k in pack}
    header.update({
        "kind": "header", "chunk_blocks": chunk_blocks,
        "n_chunks": len(ranges),
        "chunk_ranges": [[i, j] for i, j in ranges],
        "chunk_crcs": crcs,
        "leaves": sorted(pack["kv"]),
        "leaf_dtypes": {k: _DTYPE_NAMES[v.dtype]
                        for k, v in pack["kv"].items()},
    })
    return [_npz_chunk(header, {})] + chunks


def export_chunks(engine, uid: int, chunk_blocks: int = 4,
                  trace_ctx=None) -> List[bytes]:
    """``uid``'s KV in the chunked wire form (``[header, kv-chunk...]``)."""
    return chunk_pack(export_sequence(engine, uid, trace_ctx=trace_ctx),
                      chunk_blocks)


def parse_header(buf: bytes) -> Dict:
    d = parse_chunk(buf)["descriptor"]
    if d.get("kind") != "header":
        raise ValueError(
            f"chunked handoff must start with the header chunk "
            f"(got kind={d.get('kind')!r})")
    return d


def _scatter_padded(engine, blocks: List[int], kv: Dict[str, torch.Tensor]):
    """Scatter ``kv`` (``[L, len(blocks), ...]`` per leaf) into ``blocks``
    of the pool, padded to a power of two with null-block rows of zeros."""
    nb = len(blocks)
    bucket = pow2_bucket(max(nb, 1),
                         engine.state_manager.max_blocks_per_seq)
    idx = torch.full((bucket,), NULL_BLOCK, dtype=torch.long)
    idx[:nb] = torch.tensor(blocks, dtype=torch.long)
    idx = idx.to(engine.device)
    for key, leaf in engine.kv_cache.items():
        data = torch.zeros((leaf.shape[0], bucket) + tuple(leaf.shape[2:]),
                           dtype=leaf.dtype)
        data[:, :nb] = kv[key].to(leaf.dtype)
        _scatter_blocks(leaf, idx, data.to(engine.device))


def _check_layout(engine, block_size: int, leaves) -> None:
    sm = engine.state_manager
    if sm.block_size != block_size:
        raise ValueError(
            f"handoff block-size mismatch: payload has {block_size}, "
            f"target pool has {sm.block_size} (disaggregated replicas must "
            f"share the KV layout)")
    if set(leaves) != set(engine.kv_cache):
        raise ValueError(
            f"handoff pool-leaf mismatch: payload has {sorted(leaves)}, "
            f"target pool has {sorted(engine.kv_cache)} (kv_quant must "
            f"match)")


class ChunkedRestore:
    """Receiving side of one chunked handoff. ``apply`` is idempotent per
    chunk number (a resent chunk scatters the same content)."""

    def __init__(self, engine, uid: int, header: Dict):
        self.engine = engine
        self.uid = int(uid)
        self.header = header
        self.received: set = set()
        self._begun = False
        self._done = False

    def begin(self) -> None:
        """Validate the layout and adopt the destination blocks."""
        h = self.header
        _check_layout(self.engine, h["block_size"], h["leaves"])
        self.seq = self.engine.state_manager.adopt_sequence(
            self.uid, int(h["n_blocks"]), h["seen_tokens"], h["token_log"])
        self._begun = True

    def apply(self, chunk: Dict) -> None:
        """Integrity-check and scatter one block-range chunk."""
        d = chunk["descriptor"]
        if d.get("kind") != "kv":
            raise ValueError(f"expected a kv chunk, got {d.get('kind')!r}")
        seq_no = int(d["seq"])
        if not 0 <= seq_no < self.header["n_chunks"]:
            raise ValueError(f"chunk seq {seq_no} outside the header's "
                             f"{self.header['n_chunks']} chunks")
        i, j = int(d["block_start"]), int(d["block_end"])
        if [i, j] != list(self.header["chunk_ranges"][seq_no]):
            raise ValueError(
                f"chunk {seq_no} range [{i},{j}) disagrees with the header "
                f"manifest {self.header['chunk_ranges'][seq_no]}")
        crc = _chunk_crc(chunk["kv"])
        if crc != int(d["crc32"]) \
                or crc != int(self.header["chunk_crcs"][seq_no]):
            raise ValueError(f"chunk {seq_no} failed its crc32 integrity "
                             f"check (corrupted in transfer)")
        if set(chunk["kv"]) != set(self.engine.kv_cache):
            raise ValueError("chunk leaf set disagrees with the pool")
        _scatter_padded(self.engine, self.seq.blocks[i:j], chunk["kv"])
        self.received.add(seq_no)

    def missing(self) -> List[int]:
        return [s for s in range(int(self.header["n_chunks"]))
                if s not in self.received]

    def commit_check(self) -> None:
        gaps = self.missing()
        if gaps:
            raise ValueError(f"handoff incomplete: missing chunks {gaps} "
                             f"of {self.header['n_chunks']}")
        self._done = True

    def abort(self) -> None:
        """Free the adopted blocks; the token log is cleared first so the
        flush indexes no partially filled block as a cached prefix."""
        if self._begun and not self._done:
            sm = self.engine.state_manager
            seq = sm.seqs.get(self.uid)
            if seq is not None:
                seq.token_log = []
                sm.flush_sequence(self.uid)
        self._done = True


def restore_sequence(engine, pack: Dict, uid: int) -> None:
    """Install a handed-off sequence into ``engine`` as ``uid``: fresh
    blocks, the KV content scattered into them, the descriptor in the
    state the decode paths expect."""
    _check_layout(engine, pack["block_size"], pack["kv"])
    sm = engine.state_manager
    seq = sm.adopt_sequence(uid, int(pack["n_blocks"]), pack["seen_tokens"],
                            pack["token_log"])
    try:
        _scatter_padded(engine, seq.blocks, pack["kv"])
    except Exception:
        sm.flush_sequence(uid)   # do not leak the adopted blocks
        raise
