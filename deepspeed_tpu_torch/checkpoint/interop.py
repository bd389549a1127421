"""Weight bridge from the JAX package's parameter trees.

Both packages name and lay out parameters identically (stacked
``[L, ...]`` layer leaves, ``[in, out]`` matrices), so a tree moves by
name with no transposes. The caller hands over numpy arrays
(``np.asarray`` on the JAX side); this module never sees a jax array.
"""

from typing import Any, Dict, Optional

import numpy as np
import torch


def params_from_numpy(tree: Dict[str, Any], device="cpu",
                      dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Nested dict of numpy arrays -> the same dict of tensors on
    ``device`` (cast to ``dtype`` when given)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype)
                for k, v in tree.items()}
    t = torch.from_numpy(np.array(tree, copy=True))
    return t.to(device=device, dtype=dtype or t.dtype)


def params_to_numpy(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The reverse: a tree of tensors -> the same dict of f32 numpy arrays
    on the host (what the JAX package's ``jnp.asarray`` takes)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return tree.detach().to("cpu", torch.float32).numpy()
