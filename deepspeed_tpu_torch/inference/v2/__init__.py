from .config_v2 import (DSStateManagerConfig,  # noqa: F401
                        RaggedInferenceEngineConfig)
from .engine_v2 import InferenceEngineV2  # noqa: F401
from .scheduler import DynamicSplitFuseScheduler  # noqa: F401
