from .abstract_accelerator import DeepSpeedAccelerator  # noqa: F401
from .real_accelerator import (get_accelerator, set_accelerator,  # noqa: F401
                               is_current_accelerator_supported)
