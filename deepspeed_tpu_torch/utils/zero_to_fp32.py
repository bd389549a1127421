"""Reconstruct consolidated fp32 weights from a training checkpoint.

Adapted copy of ``deepspeed_tpu/utils/zero_to_fp32.py`` over the port's
``checkpoint/state_checkpoint.py`` (the same format). The reference must
stitch fp32 fragments out of per-rank ZeRO shard files; the native layout
already stores one full fp32 fragment per tensor, so consolidation reads
the manifest.

Usable as a module (``get_fp32_state_dict_from_zero_checkpoint``) or CLI::

    python -m deepspeed_tpu_torch.utils.zero_to_fp32 <checkpoint_dir> <output.npz>
"""

import argparse
from typing import Dict, Optional

import numpy as np

from ..checkpoint.state_checkpoint import (read_fragment, read_manifest,
                                           resolve_ckpt_dir, weights_entry)


def get_fp32_state_dict_from_zero_checkpoint(
        checkpoint_dir: str, tag: Optional[str] = None) -> Dict[str, np.ndarray]:
    """Reference zero_to_fp32.get_fp32_state_dict_from_zero_checkpoint:
    ``{param path: fp32 ndarray}`` for the full unsharded model."""
    ckpt_dir = resolve_ckpt_dir(checkpoint_dir, tag)
    entry = weights_entry(read_manifest(ckpt_dir))
    return {key: read_fragment(ckpt_dir, info).float().numpy()
            for key, info in entry.items()}


def convert_zero_checkpoint_to_fp32_state_dict(
        checkpoint_dir: str, output_file: str, tag: Optional[str] = None):
    """Reference convert_zero_checkpoint_to_fp32_state_dict: writes one
    consolidated file (an .npz archive keyed by parameter path)."""
    state = get_fp32_state_dict_from_zero_checkpoint(checkpoint_dir, tag)
    np.savez(output_file, **state)
    total = sum(v.size for v in state.values())
    print(f"saved {len(state)} tensors / {total:,} params -> {output_file}")
    return output_file


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("checkpoint_dir")
    p.add_argument("output_file")
    p.add_argument("--tag", default=None)
    args = p.parse_args()
    convert_zero_checkpoint_to_fp32_state_dict(args.checkpoint_dir,
                                               args.output_file, tag=args.tag)


if __name__ == "__main__":
    main()
