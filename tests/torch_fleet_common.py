"""Shared setup of the ``tests/test_torch_fleet_*.py`` files.

One tiny serving model (vocab 128, hidden 64, 2 layers, 4 / 2 heads,
max_seq_len 256: the worker's ``TINY_SPEC``), its weights drawn by the
JAX package from ``PRNGKey(0)`` and moved into the port by name
(``checkpoint.interop.params_from_numpy``), fp32 engines of both packages
on the CPU, and the serving settings of the JAX package's fleet tests.
"""

import dataclasses

import numpy as np

import jax
import jax.numpy as jnp
import torch

from deepspeed_tpu.inference.v2 import InferenceEngineV2 as JEngine
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineConfig as JConfig
from deepspeed_tpu.inference.v2 import serve as jserve
from deepspeed_tpu.inference.v2.config_v2 import DSStateManagerConfig as JSM
from deepspeed_tpu.models import TransformerConfig as JTConfig
from deepspeed_tpu.models import TransformerLM as JModel

from deepspeed_tpu_torch.checkpoint.interop import params_from_numpy
from deepspeed_tpu_torch.inference.v2 import (InferenceEngineV2,
                                              RaggedInferenceEngineConfig)
from deepspeed_tpu_torch.inference.v2 import serve as tserve
from deepspeed_tpu_torch.inference.v2.config_v2 import DSStateManagerConfig
from deepspeed_tpu_torch.models import TransformerConfig, TransformerLM

# the suite runs in several worker processes that share the CPUs
torch.set_num_threads(2)

SERVE = {"jax": jserve, "torch": tserve}
SM = dict(max_tracked_sequences=8, max_seq_len=256, num_blocks=65,
          block_size=16, max_ragged_batch_size=512)
# the mixed request shapes of the JAX package's router tests: greedy and
# fixed-seed sampled requests in one traffic
REQ_KW = [dict(temperature=0.0), dict(temperature=0.0),
          dict(temperature=0.8, top_p=0.9, seed=11),
          dict(temperature=0.7, top_k=20, seed=5)]


class Models:
    """The tiny model in both packages and its weights: ``np_params`` (the
    JAX draw as fp32 numpy) and ``tparams`` (the same, as tensors)."""

    def __init__(self, seed: int = 0):
        self.jcfg = JTConfig(vocab_size=128, hidden_size=64,
                             intermediate_size=128, num_layers=2,
                             num_heads=4, num_kv_heads=2, max_seq_len=256,
                             remat=False, use_flash=False)
        self.jmodel = JModel(self.jcfg)
        self.np_params = jax.tree.map(
            lambda x: np.asarray(x.astype(jnp.float32)),
            self.jmodel.init_params(jax.random.PRNGKey(seed)))
        self.tcfg = TransformerConfig(**dataclasses.asdict(self.jcfg))
        self.tmodel = TransformerLM(self.tcfg)
        self.tparams = params_from_numpy(self.np_params)

    def jax_engine(self, np_params=None, **sm_kw):
        return JEngine(self.jmodel, JConfig(
            state_manager=JSM(**dict(SM, **sm_kw)), dtype="float32",
            prefill_bucket=16),
            params=self.np_params if np_params is None else np_params)

    def torch_engine(self, params=None, dtype="float32", kv_quant=False,
                     **sm_kw):
        return InferenceEngineV2(self.tmodel, RaggedInferenceEngineConfig(
            state_manager=DSStateManagerConfig(**dict(SM, **sm_kw)),
            dtype=dtype, prefill_bucket=16, kv_quant=kv_quant),
            params=self.tparams if params is None else params,
            device="cpu")

    def engine(self, pkg, **kw):
        return (self.jax_engine if pkg == "jax" else self.torch_engine)(**kw)


def serving_config(pkg, **kw):
    kw.setdefault("token_budget", 64)
    kw.setdefault("chunk", 16)
    return SERVE[pkg].ServingConfig(**kw)


def prompts(ns, seed=0):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(1, 127, n))) for n in ns]


async def drive_single(engine, pkg, ps, kws, max_new=12):
    """Streams of one ServingEngine over ``engine`` (all submitted, then
    drained)."""
    serving = SERVE[pkg].ServingEngine(engine, serving_config(pkg))
    await serving.start()
    streams = [await serving.submit(p, max_new, **kw)
               for p, kw in zip(ps, kws)]
    outs = [await s.drain() for s in streams]
    await serving.stop()
    return outs


async def colocated(engine, pkg, prompt, max_new, **kw):
    return (await drive_single(engine, pkg, [prompt], [kw], max_new))[0]


def clean(engine) -> bool:
    """No sequence holds KV blocks."""
    return engine.state_manager.tracked_sequences() == 0
