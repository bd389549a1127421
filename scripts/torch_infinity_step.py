"""ZeRO-Infinity's step on one card: step ms, read waits and bytes read.

Trains Mistral-7B width (``mistral_7b()``, seeded random bf16 weights) at
``--layers`` layers (6, the depth ``chip_smoke.py`` phase 8e runs) under
``offload_param {device: nvme}`` with the optimizer state in host RAM,
phase 8's settings (bf16, AdamW lr 3e-4, clip 1.0, micro 2 x gas 2 x S
2048, remat, ZeRO 3), ``--steps`` steps on one fixed batch, its layer
files under ``build/nvme_infinity_step`` (removed at the end), and prints
one JSON line: each step's seconds, the last step's forward / backward /
optimizer sweep seconds, the share of each sweep that waited on a file
read, the bytes read and their rate over the two sweeps, the peak device
GiB, the card's name and power limit.

``--tree DIR`` imports ``deepspeed_tpu_torch`` from DIR, so two versions
of the package (for instance a parent commit unpacked with ``git
archive``) compare within one call on one card; run them as parent,
change, change, parent:

    python3 scripts/torch_infinity_step.py --tree build/parent
    python3 scripts/torch_infinity_step.py --tree .
"""

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=".",
                    help="directory holding the deepspeed_tpu_torch to run")
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_infinity_step.py needs a CUDA device")
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import TransformerLM, mistral_7b
    if not deepspeed_tpu_torch.__file__.startswith(tree):
        raise SystemExit(f"imported {deepspeed_tpu_torch.__file__}, not "
                         f"the package under {tree}")

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cfg = dataclasses.replace(mistral_7b(), num_layers=args.layers)
    rng = np.random.default_rng(4)
    batch = {"input_ids": rng.integers(0, cfg.vocab_size, (2, 2, 2048))}
    root = os.path.join(tree, "build", "nvme_infinity_step")
    os.makedirs(root, exist_ok=True)
    config = {"train_micro_batch_size_per_gpu": 2,
              "gradient_accumulation_steps": 2,
              "optimizer": {"type": "adamw", "params": {"lr": 3e-4}},
              "gradient_clipping": 1.0, "bf16": {"enabled": True},
              "steps_per_print": 10 ** 9, "aio": {"thread_count": 8},
              "zero_optimization": {
                  "stage": 3, "stage3_param_persistence_threshold": 0,
                  "offload_param": {"device": "nvme", "nvme_path": root}}}
    try:
        t0 = time.perf_counter()
        eng, *_ = deepspeed_tpu_torch.initialize(model=TransformerLM(cfg),
                                                 config=config)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        steps, losses = [], []
        for _ in range(args.steps):
            t0 = time.perf_counter()
            losses.append(eng.train_batch(batch=batch))
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
        t = dict(eng._infinity.timings)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        eng.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    sweeps = t["forward_s"] + t["backward_s"]
    print(json.dumps({
        "tree": tree, "card": card, "layers": args.layers,
        "losses": losses, "step_s": steps, "init_s": init_s,
        "forward_s": t["forward_s"], "backward_s": t["backward_s"],
        "optimizer_s": t["optimizer_s"],
        "forward_read_wait_share": t["forward_read_wait_s"] / t["forward_s"],
        "backward_read_wait_share": t["backward_read_wait_s"]
        / t["backward_s"],
        "read_bytes": t["read_bytes"], "read_gb_s": t["read_bytes"]
        / sweeps / 1e9, "peak_gib": peak}), flush=True)


if __name__ == "__main__":
    main()
