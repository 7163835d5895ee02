#!/usr/bin/env python3
"""The port's distributed layer across the cards of one host, on NCCL.

Run from the root of a checkout on a machine with several NVIDIA GPUs:

    python3 chip_scaling.py

A one-off measurement beside ``chip_smoke.py`` (which runs the same phases
on one card, its ranks on gloo): one rank a card, every process group on
NCCL, the production backend.

- the scaling protocol (``benchmarks/scaling.py``'s, through
  ``entry.bench_mesh``: B=32, N=20k, 128², the uncached train step) at
  world 1, 2, 4, ... up to the card count, frames/s and the efficiency
  frames/s ÷ (world × world 1's), every world's losses and gradients held
  to world 1's;
- the prim-sharded render of the bench scene (100k sh3, 256²) on 2 and on
  every card, held to the single-device render and its gradient, with the
  exchange's and the render's ms and K1f/K1b at the owned rows against
  their plain versions;
- ``dryrun_multichip`` on every card (up to 4).

Prints the card's name and power limit, the phase reports and last one
JSON line {"scaling": {world: frames/s}, "cards": n}.  Needs two cards or
more; exits non-zero without.
"""

from __future__ import annotations

import json
import sys
import time

import chip_smoke as cs


def main() -> int:
    import torch
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        print(f"chip_scaling: needs two CUDA devices or more, found {n}",
              file=sys.stderr)
        return 2
    from sim_a_splat_torch import entry
    from sim_a_splat_torch.ops import _kernels

    t_start = time.perf_counter()
    smi = cs.run(["nvidia-smi", "--query-gpu=name,power.limit",
                  "--format=csv,noheader"])
    cs.log(f"cards: {smi}")
    t0 = time.perf_counter()
    _kernels.build_all()
    cs.log(f"kernels built in {time.perf_counter() - t0:.2f} s")
    dev = torch.device("cuda", 0)
    worlds = [w for w in (1, 2, 4, 8) if w <= n]
    fps = cs.scaling_phase(entry, [(w, "nccl") for w in worlds])
    rows = []
    for ranks in sorted({2, n}):
        rows += cs.sharded_render_phase(entry, dev, ranks, "nccl")
    cs.dryrun_phase(entry, min(n, 4), "nccl")
    cs.log(json.dumps({"kernels": rows}))
    cs.log(f"total {time.perf_counter() - t_start:.1f} s")
    cs.log(smi)
    cs.log(json.dumps({"scaling": {str(w): f for w, f in fps.items()},
                       "cards": n}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
