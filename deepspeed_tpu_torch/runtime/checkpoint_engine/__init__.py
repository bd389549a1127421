from .checkpoint_engine import (AsyncCheckpointEngine,  # noqa: F401
                                CheckpointEngine, NativeCheckpointEngine)
