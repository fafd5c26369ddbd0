#!/usr/bin/env python3
"""Phase 27 of chip_smoke.py on a machine of two or more cards.

    python3 dp_cards.py            # from the repository root, >= 2 GPUs

Data-parallel training of the shipped SC09 SaShiMi (d_model 128, n_layers
6, L 16000) at a global B4: phase 8b, the shipped bf16 training command at
one card, then phase 27 with its gates: two ranks over gloo on one card,
NCCL at one rank against phase 8b's losses, and (27c, which chip_smoke.py
on a one-card machine reports as not run) two ranks over NCCL across two
cards, their step against one rank's at f32 and bf16, then the trainer at
two ranks.  Prints each card's name and power limit, then one JSON line of
the readings; exits non-zero, printing no readings, when a gate fails or
the machine has fewer than two cards.
"""

import json
import os
import subprocess
import sys
import tempfile

import chip_smoke as smoke


def main():
    import torch
    from diffwave_sashimi_torch.ops import cuda_lib
    cuda_lib.library()
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < smoke.DP_RANKS:
        raise RuntimeError(f"{cards} card(s): this check needs "
                           f"{smoke.DP_RANKS}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    smoke.log(f"cards: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    model = smoke.build_model(torch).to(dev)
    launches = {}
    cwd = os.getcwd()
    root = tempfile.TemporaryDirectory(prefix="dwst_dp_cards_")
    os.chdir(root.name)
    try:
        plain = smoke.run_training_bf16(torch, root.name, launches)["losses"]
    finally:
        os.chdir(cwd)
        root.cleanup()
    out = smoke.check_data_parallel(torch, model, dev, launches, plain)
    print(json.dumps({"cards": smi.splitlines(), "data_parallel": out}),
          flush=True)


if __name__ == "__main__":
    try:
        main()
    except Exception as e:  # any failed gate: non-zero exit, no readings
        import traceback
        traceback.print_exc()
        print(f"dp_cards FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        sys.exit(1)
