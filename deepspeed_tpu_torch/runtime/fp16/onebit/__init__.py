"""The 1-bit optimizer family (port of
``deepspeed_tpu/runtime/fp16/onebit/__init__.py``): OnebitAdam, OnebitLamb
and ZeroOneAdam over the compressed allreduce (``comm/compressed.py``)."""

from .adam import OnebitAdam, build_onebit_train_step  # noqa: F401
from .lamb import OnebitLamb, build_onebit_lamb_train_step  # noqa: F401
from .zoadam import ZeroOneAdam, build_zeroone_adam_train_step  # noqa: F401

# the normalized optimizer.type name -> the function that makes its
# step (the names the reference accepts, engine.py
# _configure_basic_optimizer)
ONEBIT_OPTIMIZERS = {
    "onebitadam": build_onebit_train_step,
    "1bitadam": build_onebit_train_step,
    "onebitlamb": build_onebit_lamb_train_step,
    "1bitlamb": build_onebit_lamb_train_step,
    "zerooneadam": build_zeroone_adam_train_step,
    "01adam": build_zeroone_adam_train_step,
    "zoadam": build_zeroone_adam_train_step,
}


def normalize_opt_name(name: str) -> str:
    return name.lower().replace("_", "").replace("-", "")


def is_onebit_optimizer(name: str) -> bool:
    return normalize_opt_name(name) in ONEBIT_OPTIMIZERS


def build_train_step_for(engine):
    """The engine's 1-bit step, by its optimizer.type."""
    key = normalize_opt_name(engine.config.optimizer.type)
    return ONEBIT_OPTIMIZERS[key](engine)
