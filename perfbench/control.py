"""The readings that the correctness limits are set from, on the card.

    python3 perfbench/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed, in one process: the cell's program at the cell's own size
runs the steps its check samples (a short window: ``check.before`` steps),
and three readings are taken on the same samples:

- ``program``: the program against the plain reference (the sound runs;
  the limits' lower readings);
- ``control``: the reference in the nearest precision below the
  configuration's (bfloat16 for float32) in the program's place, against
  the reference (the upper readings: it has to fail);
- ``witness``: the reference's physics on the host CPU against the program
  on the card from the same input states, a second implementation of the
  same float32 arithmetic (how far a sound rewrite of the physics reads).

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
    from perfbench.reference import pusht_physics as phys

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.find_cell(bench, args.workload)
    cfg = harness.load_config(cell["config"])
    mix = traffic_gen.load(cell["traffic"])
    system_mod = importlib.import_module(f"perfbench.systems.{mix['system']}")
    low = getattr(torch, LOW_PRECISION[cfg["precision"]])
    for seed in args.seeds:
        t0 = time.perf_counter()
        system = system_mod.System(cfg, mix, seed, "cuda")
        for _ in range(int(mix["check"]["before"]) + 1):
            system.step()
        torch.cuda.synchronize()
        severe = system.counters()[1]
        system.release()
        row = {"seed": seed, "severe": severe,
               "program": system.check(),
               "control": system.control(low)}
        # the host's float32 physics from the program's own input states
        witness = 0.0
        for s0, a, new, _, _ in system.kept.values():
            cpu = phys.control_step(
                phys.Params(), phys.State(*(f.cpu() for f in s0)), a.cpu())
            witness = max(witness, system_mod.state_gap(new, cpu))
        row["witness"] = {"state_gap": witness}
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        del system
        torch.cuda.empty_cache()
    if guard.forbidden_loaded():
        print(f"loaded {guard.forbidden_loaded()}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
