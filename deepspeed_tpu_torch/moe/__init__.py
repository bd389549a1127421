from .layer import MoE  # noqa: F401
from .sharded_moe import (moe_layer, moe_layer_dropless,  # noqa: F401
                          residual_moe_combine, top1gating, top2gating)
