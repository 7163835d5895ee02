"""A cell's configuration and traffic cut to a size the CPU runs in
seconds, written to a directory of their own (the tests' copies: the
benchmark's files are not touched)."""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "BENCHMARK.json"
CELLS = ("pusht_fixed-datagen_b128", "pusht_fixed-train_b128")
SMALL_CONFIG = dict(n_gaussians=3000, n_block=300, n_agent=100, resolution=64,
                    tile_capacity=256, sel_tiles=16)
SMALL_TRAFFIC = dict(batch=4, check={"steps": 2, "before": 4, "envs": 3},
                     trace_steps=1)


def bench() -> dict:
    return json.loads(BENCH.read_text())


def write_small(tmp: Path) -> tuple:
    """(config dir, traffic dir) under ``tmp`` holding the benchmark's
    configurations and mixes at the small size."""
    cdir, tdir = tmp / "configs", tmp / "traffic"
    cdir.mkdir(exist_ok=True)
    tdir.mkdir(exist_ok=True)
    for p in (ROOT / "perfbench" / "configs").glob("*.json"):
        cfg = json.loads(p.read_text())
        cfg.update(SMALL_CONFIG)
        (cdir / p.name).write_text(json.dumps(cfg))
    for p in (ROOT / "perfbench" / "traffic").glob("*.json"):
        mix = json.loads(p.read_text())
        mix.update(SMALL_TRAFFIC)
        mix["walk"] = dict(mix["walk"], steps=20)
        (tdir / p.name).write_text(json.dumps(mix))
    return cdir, tdir


def run_small(tmp: Path, cell: str, seed: int = 12345678901, trace=False,
              device="cpu", bench_json=None, seconds=0.5):
    """The cell's result line from a small run on ``device``."""
    from perfbench.harness import bench as harness
    cdir, tdir = write_small(tmp)
    return harness.run_cell(bench_json or bench(), cell, seed, seconds, trace,
                            device=device, config_dir=cdir, traffic_dir=tdir,
                            log=lambda m: print(m, file=sys.stderr))
