"""The readings that the arm cells' correctness limits are set from, on the
card: ``control.py``'s protocol for a system that brings its own witness.

    python3 perfbench/control_arm.py --workload <cell> --seeds <n> [<n> ...]

For each seed, in one process: the cell's program at the cell's own size
runs the steps its check samples (``check.before`` steps and one more), and
three readings are taken on the same samples:

- ``program``: the program against the plain reference (the sound runs;
  the limits' lower readings);
- ``control``: the reference in the nearest precision below the
  configuration's (bfloat16 for float32) in the program's place, against
  the reference (the upper readings: it has to fail);
- ``witness``: the system's second implementation of the same float32
  arithmetic (``System.witness``: for the arm, the reference's physics on
  the host CPU from the program's own input states).

One JSON line a seed goes to standard output.  The benchmark's own runs do
not run this.
"""

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
LOW_PRECISION = {"float32": "bfloat16"}


def readings(system_mod, cfg: dict, mix: dict, seed: int, device) -> dict:
    """One seed's row: the program's, the control's and the witness's
    readings, and the severe count of the steps run."""
    import torch
    low = getattr(torch, LOW_PRECISION[cfg["precision"]])
    system = system_mod.System(cfg, mix, seed, device)
    for _ in range(int(mix["check"]["before"]) + 1):
        system.step()
    severe = system.counters()[1]
    system.release()
    return {"seed": seed, "severe": severe, "program": system.check(),
            "control": system.control(low), "witness": system.witness()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench.harness import bench as harness
    from perfbench.harness import guard
    from perfbench.harness import traffic as traffic_gen

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.find_cell(bench, args.workload)
    cfg = harness.load_config(cell["config"])
    mix = traffic_gen.load(cell["traffic"])
    system_mod = importlib.import_module(f"perfbench.systems.{mix['system']}")
    for seed in args.seeds:
        t0 = time.perf_counter()
        row = readings(system_mod, cfg, mix, seed, "cuda")
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    if guard.forbidden_loaded():
        print(f"loaded {guard.forbidden_loaded()}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
