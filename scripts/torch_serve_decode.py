"""Decode tokens/s and TTFT of the PyTorch port's serve path on one card.

Builds Mistral-7B (``mistral_7b()``: 32 layers, seeded random bf16
weights) as ``chip_smoke.py``'s serve phase does, then runs
``generate()`` over the same 8 prompts (128-1024 tokens, 64 new tokens,
greedy, decode window 8) on the bf16 KV pool and on the int8 pool over
the same weight tensors, ``--reps`` times each, and prints one JSON line
with every reading beside the card's name and power limit.

``--tree DIR`` imports ``deepspeed_tpu_torch`` from DIR, so two versions
of the package (for instance a parent commit unpacked with ``git
archive``) compare within one call on one card; run them as parent,
change, change, parent:

    python3 scripts/torch_serve_decode.py --tree build/parent
    python3 scripts/torch_serve_decode.py --tree .

TTFT is the 8-prompt put() (``engine.last_ttft_s``); decode tokens/s is
8 x 63 tokens over the rest of the call, as ``chip_smoke.py`` logs them.
"""

import argparse
import json
import os
import subprocess
import sys
import time


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=".",
                    help="directory holding the deepspeed_tpu_torch to run")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_serve_decode.py needs a CUDA device")
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import TransformerLM, mistral_7b
    if not deepspeed_tpu_torch.__file__.startswith(tree):
        raise SystemExit(f"imported {deepspeed_tpu_torch.__file__}, not "
                         f"the package under {tree}")

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cfg = mistral_7b()
    rng = np.random.default_rng(1)
    prompts = [list(map(int, rng.integers(1, cfg.vocab_size, n)))
               for n in (128, 256, 384, 512, 640, 768, 896, 1024)]
    new = 64
    ragged = {"decode_window": 8,
              "state_manager": {"max_ragged_batch_size": 8192}}
    pipe = deepspeed_tpu_torch.pipeline(
        cfg, device=dev,
        config={"dtype": "bfloat16", "ragged": dict(ragged, seed=0)})
    engines = {"bf16": pipe.engine}
    engines["int8"] = deepspeed_tpu_torch.init_inference(
        TransformerLM(cfg), params=pipe.engine.params, device=dev,
        config={"dtype": "bfloat16", "use_ragged": True,
                "ragged": dict(ragged, kv_quant=True)})

    out = {"tree": args.tree, "card": card, "reps": args.reps}
    for name, eng in engines.items():
        eng.generate([prompts[0][:64]], max_new_tokens=4)      # warm-up
        tok_s, ttft_ms = [], []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gen = eng.generate(prompts, max_new_tokens=new)
            torch.cuda.synchronize()
            gen_s = time.perf_counter() - t0
            if any(len(g) != len(p) + new for g, p in zip(gen, prompts)):
                raise AssertionError(f"{name}: a stream is short")
            ttft = eng.last_ttft_s
            tok_s.append(len(prompts) * (new - 1) / (gen_s - ttft))
            ttft_ms.append(ttft * 1e3)
        out[name] = {"decode_tokens_per_s": tok_s, "ttft_ms": ttft_ms,
                     "decode_tokens_per_s_median": float(np.median(tok_s)),
                     "ttft_ms_median": float(np.median(ttft_ms))}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
