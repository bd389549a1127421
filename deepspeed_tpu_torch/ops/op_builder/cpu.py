"""Host (C++) op builders: the vectorized CPU optimizers of ZeRO-Offload
and the async file IO of the NVMe tier.

Port of ``deepspeed_tpu/ops/op_builder/cpu/__init__.py``; the sources are
the port's copies in ``csrc/host/``.
"""

from .builder import NativeOpBuilder


class CPUAdamBuilder(NativeOpBuilder):
    NAME = "cpu_adam"

    def sources(self):
        return ["cpu_adam.cpp"]


class CPUAdagradBuilder(NativeOpBuilder):
    NAME = "cpu_adagrad"

    def sources(self):
        return ["cpu_adagrad.cpp"]


class CPULionBuilder(NativeOpBuilder):
    NAME = "cpu_lion"

    def sources(self):
        return ["cpu_lion.cpp"]


class AsyncIOBuilder(NativeOpBuilder):
    NAME = "async_io"

    def sources(self):
        return ["async_io.cpp"]

    def extra_ldflags(self):
        return ["-lpthread"]


ALL_OPS = {b.NAME: b for b in
           (CPUAdamBuilder, CPUAdagradBuilder, CPULionBuilder, AsyncIOBuilder)}
