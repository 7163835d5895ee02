"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout, on a machine with as many CUDA devices as the
cell asks for.  The cell's set-up (the scene from the seed, the kernels'
build, one warm step) is timed as ``setup_s``; then the cell's loop runs for
``--seconds``, ending at a step boundary, each step under a profiler of the
device's activity where an end-to-end metric of the cell is taken from the
device; with ``--trace 1`` a few more steps run under the profiler and the
cell's per-layer metrics are read instead of its end-to-end ones.  Once the
window has closed the outputs the run sampled are held to the plain
reference.  The last line of standard output is the result, a JSON object;
the numbers compared, each beside its limit, are the last lines of standard
error and the result's last key.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # one intra-op thread: the steps are bound by the host's kernel
    # dispatch from the main thread
    os.environ["OMP_NUM_THREADS"] = "1"
    # every build and kernel cache at a fixed path inside the checkout
    cache = ROOT / ".perfbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.path.insert(0, str(ROOT))

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        log(f"perfbench: no workload {args.workload!r}")
        return 2
    import torch
    torch.set_num_threads(1)
    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"perfbench: needs {chips} CUDA device(s); "
            f"cuda available {torch.cuda.is_available()}, "
            f"{torch.cuda.device_count()} device(s)")
        return 2
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi: {e}"
    log(f"card: {smi}; torch {torch.__version__}, cuda {torch.version.cuda}")

    from perfbench.harness import bench as harness
    from perfbench.harness import guard
    line = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                            bool(args.trace), device="cuda",
                            t_start=T_START, log=log)
    loaded = guard.forbidden_loaded()
    if loaded:
        log(f"perfbench: the run loaded {loaded}")
        return 3
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
