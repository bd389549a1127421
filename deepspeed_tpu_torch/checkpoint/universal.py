"""Universal checkpoint tooling.

Port of ``deepspeed_tpu/checkpoint/universal.py`` (reference
``deepspeed/checkpoint/ds_to_universal.py:254``: a (tp, pp, dp)-sharded
checkpoint -> atomic per-parameter fragments, plus
``universal_checkpoint.py:12 load_hp_checkpoint_state``). The directory
layout, the manifest and the fragment names are the JAX package's byte
for byte, so a universal directory written by either package loads into
the other:

  * ``ds_to_universal(in_dir, out_dir)``: a native checkpoint (either
    package's fragment format; the weights upcast to fp32, the optimizer
    moments in their own dtype, with the step counter, the meta block and
    the fp16 scale state) or a flat ``.npz`` state dict (e.g. from
    ``utils/zero_to_fp32.py``) -> ``param__<key>.npy`` /
    ``opt__<key>.npy`` fragments and ``universal_manifest.json``;
  * ``load_universal_into_tree(dir, template)``: the fragments by tree
    path into a nested-dict template (``state_checkpoint.leaf_paths`` /
    ``tree_from_paths`` in place of ``jax.tree_util``); a pipe-stacked
    template key re-stacks the per-layer fragments.

CLI: ``python -m deepspeed_tpu_torch.checkpoint.universal IN OUT
[--tag TAG]``.
"""

import json
import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

# stacked-storage split/re-stack (PipelineModule pipe-sharded params) is
# shared with the native format: both stores are canonical per-layer
from .state_checkpoint import (SENTINEL_NONE, leaf_paths, read_fragment,
                               read_latest, tree_from_paths,
                               per_layer_key as _per_layer_key,
                               stacked_component as _stacked_component)

UNIVERSAL_SUBDIR = "zero_universal"
MANIFEST = "universal_manifest.json"


def _native_ckpt_dir(path: str, tag: Optional[str] = None) -> Optional[str]:
    if os.path.exists(os.path.join(path, "manifest.json")):
        return path
    if not os.path.isdir(path):
        return None
    tag = tag or read_latest(path)
    if tag and os.path.exists(os.path.join(path, tag, "manifest.json")):
        return os.path.join(path, tag)
    return None


def ds_to_universal(input_dir: str, output_dir: str,
                    tag: Optional[str] = None) -> str:
    """Offline conversion (reference ds_to_universal.py main): produce a
    directory of atomic per-param fp32 fragments + manifest."""
    os.makedirs(output_dir, exist_ok=True)
    native = _native_ckpt_dir(input_dir, tag)
    if native is not None:
        return _from_native(native, output_dir)
    if input_dir.endswith(".npz") or os.path.isfile(input_dir):
        return _from_flat_archive(input_dir, output_dir)
    raise ValueError(f"unrecognized checkpoint layout at {input_dir}")


def _fragment(ckpt_dir: str, info: Dict[str, Any]) -> np.ndarray:
    """A native fragment as numpy (a bfloat16 fragment, written by numpy
    with ``ml_dtypes``, as float32)."""
    t = read_fragment(ckpt_dir, info)
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _from_native(ckpt_dir: str, output_dir: str) -> str:
    with open(os.path.join(ckpt_dir, "manifest.json")) as fh:
        manifest = json.load(fh)
    entry = manifest["tensors"].get("master_params")
    if entry in (None, SENTINEL_NONE):
        entry = manifest["tensors"]["params"]

    def emit(key, arr, prefix, out):
        """One fragment — splitting PipelineModule stacked storage into
        canonical per-layer fragments so the universal dir is
        pp-independent (the format's core promise)."""
        stacked = _stacked_component(key)
        if stacked is not None:
            comp_idx, first = stacked
            for j in range(arr.shape[0]):
                emit(_per_layer_key(key, comp_idx, first + j), arr[j],
                     prefix, out)
            return
        fname = f"{prefix}__{key.replace('/', '__')}.npy"
        np.save(os.path.join(output_dir, fname), arr)
        out[key] = {"file": fname, "shape": list(arr.shape),
                    "dtype": str(arr.dtype)}

    out_entry: Dict[str, Any] = {}
    for key, info in entry.items():
        emit(key, _fragment(ckpt_dir, info).astype(np.float32), "param",
             out_entry)
    # optimizer moments ride along (reference ds_to_universal emits
    # exp_avg/exp_avg_sq fragments) so a universal restore resumes
    # optimization, not just weights; their dtypes are kept
    opt_entry: Dict[str, Any] = {}
    opt = manifest["tensors"].get("opt_state")
    if opt not in (None, SENTINEL_NONE):
        for key, info in opt.items():
            emit(key, _fragment(ckpt_dir, info), "opt", opt_entry)
    # the step counter travels with the moments (Adam's bias correction);
    # meta carries global_steps / the lr schedule; scale_state the fp16
    # dynamic loss scale
    extras: Dict[str, Any] = {"meta": manifest.get("meta", {})}
    step = manifest["tensors"].get("step")
    if opt not in (None, SENTINEL_NONE) and isinstance(step, dict):
        info = step.get("") or next(iter(step.values()))
        extras["step"] = int(_fragment(ckpt_dir, info).reshape(()))
    scale = manifest["tensors"].get("scale_state")
    if isinstance(scale, dict):
        extras["scale_state"] = {
            key: _fragment(ckpt_dir, info).tolist()
            for key, info in scale.items()}
    _write_universal_manifest(output_dir, out_entry,
                              source=os.path.abspath(ckpt_dir),
                              opt_entry=opt_entry, extras=extras)
    return output_dir


def _from_flat_archive(path: str, output_dir: str) -> str:
    data = np.load(path)
    keys = data.files if hasattr(data, "files") else None
    if keys is None:
        raise ValueError(f"{path} is not a .npz archive")
    out_entry: Dict[str, Any] = {}
    for key in keys:
        arr = np.asarray(data[key]).astype(np.float32)
        fname = f"param__{key.replace('/', '__')}.npy"
        np.save(os.path.join(output_dir, fname), arr)
        out_entry[key] = {"file": fname, "shape": list(arr.shape),
                          "dtype": "float32"}
    _write_universal_manifest(output_dir, out_entry,
                              source=os.path.abspath(path))
    return output_dir


def _write_universal_manifest(output_dir, entry, source, opt_entry=None,
                              extras=None):
    doc = {"format": "deepspeed_tpu_universal/1", "source": source,
           "params": entry, "opt_state": opt_entry or {}}
    doc.update(extras or {})
    with open(os.path.join(output_dir, MANIFEST), "w") as fh:
        json.dump(doc, fh, indent=2)


def _manifest(universal_dir: str) -> Dict[str, Any]:
    with open(os.path.join(universal_dir, MANIFEST)) as fh:
        return json.load(fh)


def load_universal_extras(universal_dir: str) -> Dict[str, Any]:
    """step counter + meta (global_steps, lr_scheduler state) + fp16
    scale_state, if present."""
    m = _manifest(universal_dir)
    return {"step": m.get("step"), "meta": m.get("meta", {}),
            "scale_state": m.get("scale_state")}


def load_universal_params(universal_dir: str,
                          section: str = "params") -> Dict[str, np.ndarray]:
    return {k: np.load(os.path.join(universal_dir, v["file"]))
            for k, v in _manifest(universal_dir).get(section, {}).items()}


def has_universal_opt_state(universal_dir: str) -> bool:
    try:
        return bool(_manifest(universal_dir).get("opt_state"))
    except OSError:
        return False


def _cast_like(arr: np.ndarray, leaf):
    """``arr`` in the template leaf's dtype: a CPU tensor for a torch
    leaf (numpy holds no bfloat16), an array for a numpy leaf."""
    if isinstance(leaf, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(leaf.dtype)
    if hasattr(leaf, "dtype"):
        return arr.astype(leaf.dtype)
    return arr


def load_universal_into_tree(universal_dir: str, template,
                             section: str = "params"):
    """Fill ``template`` (a nested dict whose leaves are tensors, arrays
    or anything with a shape) with fragments matched by tree path."""
    flat = load_universal_params(universal_dir, section=section)
    items = []
    for key, leaf in leaf_paths(template):
        if key not in flat:
            # a pipe-stacked template key: re-stack the canonical
            # per-layer fragments (the converse of _from_native's split)
            stacked = _stacked_component(key)
            if stacked is not None and hasattr(leaf, "shape"):
                comp_idx, first = stacked
                members = []
                for j in range(leaf.shape[0]):
                    lk = _per_layer_key(key, comp_idx, first + j)
                    if lk not in flat:
                        raise KeyError(
                            f"universal checkpoint missing {lk} (for "
                            f"stacked {key}); has {sorted(flat)[:8]}...")
                    members.append(flat[lk])
                arr = np.stack(members)
            else:
                raise KeyError(f"universal checkpoint missing {key}; has "
                               f"{sorted(flat)[:8]}...")
        else:
            arr = flat[key]
        items.append((key, _cast_like(arr, leaf)))
    return tree_from_paths(items)


def copy_aux_files(input_dir: str, output_dir: str):
    """Carry over non-tensor files (latest tag, client state)."""
    for name in ("latest",):
        src = os.path.join(input_dir, name)
        if os.path.exists(src):
            shutil.copy(src, os.path.join(output_dir, name))


def main(argv=None):
    """Console entry (reference checkpoint/ds_to_universal.py:254 main):
    convert a saved checkpoint into atomic per-param fp32 fragments that
    load under ANY (dp, tp, pp, zero-stage) topology."""
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("input_dir", help="checkpoint dir (or flat .npz archive)")
    p.add_argument("output_dir", help="where to write universal fragments")
    p.add_argument("--tag", default=None,
                   help="checkpoint tag (default: read 'latest' file)")
    args = p.parse_args(argv)
    out = ds_to_universal(args.input_dir, args.output_dir, tag=args.tag)
    copy_aux_files(args.input_dir, args.output_dir)
    print(f"universal checkpoint written to {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
