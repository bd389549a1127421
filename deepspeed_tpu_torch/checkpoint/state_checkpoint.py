"""Checkpoint save/load with atomic per-tensor fragments.

Port of ``deepspeed_tpu/checkpoint/state_checkpoint.py`` (``save_state``
:84, ``read_latest`` :147, ``load_params_for_inference`` :155,
``load_state`` :184), in the same format, so either package reads the
other's checkpoints: a directory ``<save_dir>/<tag>/`` holding one full
(unsharded) ``.npy`` fragment per leaf and ``manifest.json``
(``{"tensors": {name: {key: {"file", "shape", "dtype"}} or "__none__"},
"meta": {...}}``), and ``<save_dir>/latest`` naming the tag.

Trees are nested dicts; a leaf's key is its path joined by ``/`` (the JAX
package's ``keystr`` of a dict path), its file
``<name>__<key with / as __>.npy``. As there, 16-bit floats are written as
float32 fragments (lossless; ``.npy`` has no portable bfloat16), and a
pipeline-stacked ``stack_NNN`` component is saved as per-layer
``layer_NNN`` fragments and re-stacked on load. A fragment whose bytes are
an opaque 2-byte type (a bfloat16 array written by numpy with
``ml_dtypes`` has the descr ``'<V2'``) is read through the manifest's
dtype, never through ``ml_dtypes``.

Under data parallelism the fragments stay whole: every rank gathers its
sharded leaves (:func:`gather_shards`, JAX :74-87 ``process_allgather``)
and rank 0 writes; on load each rank reads the whole leaves and keeps its
shards (:func:`take_shards`), so a checkpoint saved at one data-parallel
world loads at another.
"""

import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

SENTINEL_NONE = "__none__"

_STACK_COMPONENT = re.compile(r"stack_(\d+)")

_TORCH_DTYPES = {"float32": torch.float32, "float16": torch.float16,
                 "bfloat16": torch.bfloat16, "float64": torch.float64,
                 "int32": torch.int32, "int64": torch.int64,
                 "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool}


def stacked_component(key: str):
    """(component_index, first_layer) if the '/'-path contains a
    PipelineModule stacked-storage component, else None."""
    for idx, part in enumerate(key.split("/")):
        m = _STACK_COMPONENT.fullmatch(part)
        if m:
            return idx, int(m.group(1))
    return None


def per_layer_key(key: str, comp_idx: int, layer: int) -> str:
    parts = key.split("/")
    parts[comp_idx] = f"layer_{layer:03d}"
    return "/".join(parts)


def leaf_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key, leaf) of a nested-dict tree in the JAX flatten order (sorted
    keys); a bare leaf has the key ``""``."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(leaf_paths(tree[k], f"{prefix}{k}/"))
        return out
    return [(prefix[:-1], tree)]


def tree_from_paths(items) -> Any:
    """Inverse of :func:`leaf_paths`."""
    items = list(items)
    if len(items) == 1 and items[0][0] == "":
        return items[0][1]
    tree: Dict[str, Any] = {}
    for key, leaf in items:
        node = tree
        *parents, last = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


def gather_shards(leaves, dims, group=None) -> List[torch.Tensor]:
    """Whole leaves from this rank's ZeRO shards (``dims[i]``: the dimension
    leaf ``i`` is cut along, None if whole). A collective on every rank of
    the group."""
    from ..comm import comm
    from ..comm.quantized import all_gather_leaf

    if comm.get_world_size(group) == 1:
        return list(leaves)
    return [v if d is None else all_gather_leaf(v.detach(), d, group)
            for v, d in zip(leaves, dims)]


def take_shards(leaves, dims, rank: int, world: int) -> List[torch.Tensor]:
    """This rank's shards (views) of whole leaves read from a checkpoint."""
    from ..comm.quantized import shard_of

    return [v if d is None else shard_of(v, d, rank, world)
            for v, d in zip(leaves, dims)]


def to_numpy(leaf) -> np.ndarray:
    """A leaf on the host as numpy; floats narrower than 32 bits upcast to
    float32 (lossless)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.is_floating_point() and t.element_size() < 4:
            t = t.float()
        return t.cpu().numpy()
    arr = np.asarray(leaf)
    if arr.dtype.kind == "f" and arr.dtype.itemsize < 4:
        arr = arr.astype(np.float32)
    return arr


def save_state(save_dir: str, tag: str, state: Dict[str, Any],
               meta: Dict[str, Any], save_latest: bool = True) -> None:
    """Write ``state`` (whole leaves) under ``save_dir/tag``; in a process
    group only rank 0 writes."""
    from ..comm import comm

    if comm.get_rank() != 0:
        return
    ckpt_dir = os.path.join(save_dir, tag)
    os.makedirs(ckpt_dir, exist_ok=True)
    manifest = {"tensors": {}, "meta": meta}
    for name, subtree in state.items():
        if subtree is None:
            manifest["tensors"][name] = SENTINEL_NONE
            continue
        entries = {}

        def emit(key, arr):
            stacked = stacked_component(key) if key else None
            if stacked is not None:
                comp_idx, first = stacked
                for j in range(arr.shape[0]):
                    emit(per_layer_key(key, comp_idx, first + j), arr[j])
                return
            fname = (f"{name}__{key.replace('/', '__')}.npy" if key
                     else f"{name}.npy")
            np.save(os.path.join(ckpt_dir, fname), arr)
            entries[key] = {"file": fname, "shape": list(arr.shape),
                            "dtype": str(arr.dtype)}

        for key, leaf in leaf_paths(subtree):
            emit(key, to_numpy(leaf))
        manifest["tensors"][name] = entries
    with open(os.path.join(ckpt_dir, "manifest.json"), "w") as fh:
        json.dump(manifest, fh, indent=2, default=str)
    if save_latest:
        with open(os.path.join(save_dir, "latest"), "w") as fh:
            fh.write(tag)


def read_fragment(ckpt_dir: str, info: Dict[str, Any]) -> torch.Tensor:
    """One fragment as a CPU tensor, its type taken from the manifest where
    the file's own descr is opaque (``'<V2'`` for bfloat16)."""
    arr = np.load(os.path.join(ckpt_dir, info["file"]))
    if arr.dtype.kind == "V":
        want = _TORCH_DTYPES.get(info["dtype"])
        if want is None or arr.dtype.itemsize != torch.empty(
                0, dtype=want).element_size():
            raise ValueError(f"fragment {info['file']}: opaque dtype "
                             f"{arr.dtype} with manifest dtype "
                             f"{info['dtype']!r}")
        int_view = {1: np.uint8, 2: np.int16, 4: np.int32, 8: np.int64}
        t = torch.from_numpy(np.ascontiguousarray(arr).view(
            int_view[arr.dtype.itemsize]))
        return t.view(want)
    return torch.from_numpy(np.ascontiguousarray(arr))


def _load_fragment(entry: Dict[str, Any], ckpt_dir: str, key: str,
                   shape=None) -> torch.Tensor:
    """One leaf from its fragment(s): direct hit, or, for a pipe-stacked
    template key, the canonical per-layer fragments re-stacked."""
    info = entry.get(key)
    if info is not None:
        return read_fragment(ckpt_dir, info)
    stacked = stacked_component(key)
    if stacked is not None and shape is not None:
        comp_idx, first = stacked
        members = []
        for j in range(shape[0]):
            lk = per_layer_key(key, comp_idx, first + j)
            li = entry.get(lk)
            if li is None:
                raise KeyError(f"checkpoint missing tensor {lk} "
                               f"(for stacked {key})")
            members.append(read_fragment(ckpt_dir, li))
        return torch.stack(members)
    raise KeyError(f"checkpoint missing tensor {key}")


def read_latest(load_dir: str) -> Optional[str]:
    path = os.path.join(load_dir, "latest")
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        return fh.read().strip()


def resolve_ckpt_dir(path: str, tag: Optional[str] = None) -> str:
    """``path`` itself if it holds a manifest, else ``path/<tag or
    latest>``."""
    if os.path.exists(os.path.join(path, "manifest.json")):
        return path
    tag = tag or read_latest(path)
    if tag is None:
        raise FileNotFoundError(
            f"no 'latest' file or manifest under {path}")
    return os.path.join(path, tag)


def read_manifest(ckpt_dir: str) -> Dict[str, Any]:
    with open(os.path.join(ckpt_dir, "manifest.json")) as fh:
        return json.load(fh)


def weights_entry(manifest: Dict[str, Any]) -> Dict[str, Any]:
    """The fp32 master weights' entries, or the params' where the
    checkpoint holds no master."""
    entry = manifest["tensors"].get("master_params")
    if entry in (None, SENTINEL_NONE):
        entry = manifest["tensors"].get("params")
    if entry in (None, SENTINEL_NONE):
        raise ValueError("checkpoint holds no parameters")
    return entry


def load_params_for_inference(path: str, dtype: torch.dtype,
                              device=None) -> Dict[str, Any]:
    """Just the model weights of a training checkpoint, for inference
    (reference InferenceEngine checkpoint loading, inference/engine.py:324):
    the master weights where present, else the params, cast to ``dtype``
    on ``device``. ``path`` is the run directory (its ``latest`` tag) or a
    tag directory. The tree is the manifest's keys (the port's models keep
    no pipeline-stacked storage)."""
    ckpt_dir = resolve_ckpt_dir(path)
    entry = weights_entry(read_manifest(ckpt_dir))
    return tree_from_paths(
        (key, read_fragment(ckpt_dir, info).to(device=device, dtype=dtype))
        for key, info in sorted(entry.items()))


def load_state(load_dir: str, tag: str, template: Dict[str, Any]
               ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Load into the structure of ``template``: each leaf read as a
    tensor of the template leaf's dtype on its device, or on the host for
    a ``meta`` template leaf. A ``None`` subtree, or one the checkpoint
    does not hold, loads as ``None``."""
    ckpt_dir = os.path.join(load_dir, tag)
    manifest = read_manifest(ckpt_dir)
    state: Dict[str, Any] = {}
    for name, subtree in template.items():
        entry = manifest["tensors"].get(name, SENTINEL_NONE)
        if entry == SENTINEL_NONE or subtree is None:
            state[name] = None
            continue
        items = []
        for key, leaf in leaf_paths(subtree):
            arr = _load_fragment(entry, ckpt_dir, key, tuple(leaf.shape))
            dev = "cpu" if leaf.device.type == "meta" else leaf.device
            items.append((key, arr.to(device=dev, dtype=leaf.dtype)))
        state[name] = tree_from_paths(items)
    return state, manifest["meta"]
