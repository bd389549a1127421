"""MII-style one-call serving pipeline.

Port of ``deepspeed_tpu/pipeline.py``: ``pipeline()`` builds the ragged v2
engine and returns a callable that runs a batch of prompts through one
Dynamic SplitFuse schedule::

    pipe = deepspeed_tpu_torch.pipeline(mistral_7b())
    outs = pipe([[1, 2, 3], [4, 5]], max_new_tokens=64)

It serves native models (a ``TransformerConfig`` or ``TransformerLM``,
weights from ``params`` or seeded). HF modules and hub names wait for the
``module_inject`` port.
"""

from typing import Optional

import numpy as np

from .models.transformer import TransformerConfig, TransformerLM


class ServePipeline:
    def __init__(self, engine, tokenizer=None,
                 token_budget: Optional[int] = None,
                 chunk: Optional[int] = None):
        self.engine = engine
        self.tokenizer = tokenizer
        self.token_budget = token_budget
        self.chunk = chunk
        self._uid = 0

    def __call__(self, prompts, max_new_tokens: int = 64,
                 eos_token_id: Optional[int] = None,
                 return_full_text: bool = False,
                 temperature: float = 0.0, top_p: float = 1.0,
                 top_k: int = 0, seed: Optional[int] = None):
        """prompts: str | Sequence[str] (tokenizer required) or
        Sequence[Sequence[int]]. Returns decoded strings when a tokenizer
        is present, else token-id arrays; generated-only by default."""
        from .inference.v2.scheduler import DynamicSplitFuseScheduler

        single = isinstance(prompts, str)
        if single:
            prompts = [prompts]
        if prompts and isinstance(prompts[0], str):
            assert self.tokenizer is not None, \
                "string prompts need a tokenizer; pass token-id lists " \
                "or pipeline(..., tokenizer=...)"
            ids = [self._encode(p) for p in prompts]
        else:
            ids = [list(map(int, p)) for p in prompts]
        if eos_token_id is None and self.tokenizer is not None:
            eos_token_id = getattr(self.tokenizer, "eos_token_id", None)

        sched = DynamicSplitFuseScheduler(self.engine,
                                          token_budget=self.token_budget,
                                          chunk=self.chunk)
        uids = []
        for i, p in enumerate(ids):
            uid = self._uid = self._uid + 1
            sched.submit(uid, p, max_new_tokens=max_new_tokens,
                         eos_token_id=eos_token_id,
                         temperature=temperature, top_p=top_p,
                         top_k=top_k,
                         seed=None if seed is None else seed + i)
            uids.append(uid)
        sched.run()
        res = sched.results()
        outs = []
        for uid, p in zip(uids, ids):
            toks = res[uid] if return_full_text else res[uid][len(p):]
            outs.append(self._decode(toks) if self.tokenizer is not None
                        else np.asarray(toks))
        return outs[0] if single else outs

    # -- tokenizer adapters (HF tokenizers and anything encode/decode) --
    def _encode(self, text: str):
        tk = self.tokenizer
        if hasattr(tk, "encode"):
            return list(map(int, tk.encode(text)))
        return list(map(int, tk(text)["input_ids"]))

    def _decode(self, toks):
        return self.tokenizer.decode(list(map(int, toks)))


def pipeline(model=None, tokenizer=None, config=None, params=None,
             token_budget: Optional[int] = None,
             chunk: Optional[int] = None, device=None,
             **kwargs) -> ServePipeline:
    """Build a ServePipeline over a native model: a ``TransformerConfig``
    or a ``TransformerLM`` (trained weights via ``params``, else seeded).
    ``device=None`` serves on the card and raises without one."""
    from . import init_inference

    if isinstance(model, TransformerConfig):
        model = TransformerLM(model)
    if not isinstance(model, TransformerLM):
        raise NotImplementedError(
            "pipeline() serves native models (TransformerConfig / "
            "TransformerLM); HF modules and hub names wait for the "
            "module_inject port")
    cfg = dict(config or {})
    cfg["use_ragged"] = True
    engine = init_inference(model=model, config=cfg, params=params,
                            device=device, **kwargs)
    return ServePipeline(engine, tokenizer=tokenizer,
                         token_budget=token_budget, chunk=chunk)
