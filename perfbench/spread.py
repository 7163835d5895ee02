"""Spreads of a set of runs, the numbers a bound is set from.

    python3 perfbench/spread.py RESULT_FILE [RESULT_FILE ...]

Each file holds a run's standard output; its last line is the result.  For
each metric the script prints the median, the quartiles and the spread
(their distance as a share of the median, ``statistics.quantiles`` with
``n=4``), and the spread again without the run farthest from the median.
"""

import json
import statistics
import sys


def spreads(values) -> tuple:
    """(median, q1, q3, spread, spread without the farthest run)."""
    med = statistics.median(values)
    q1, _, q3 = statistics.quantiles(values, n=4)
    far = max(values, key=lambda v: abs(v - med))
    rest = list(values)
    rest.remove(far)
    r1, _, r3 = statistics.quantiles(rest, n=4)
    return med, q1, q3, (q3 - q1) / med, (r3 - r1) / statistics.median(rest)


def main(paths) -> int:
    by_metric = {}
    for p in paths:
        with open(p) as f:
            lines = f.read().strip().splitlines()
        line = json.loads(lines[-1])
        for k, v in line["metrics"].items():
            by_metric.setdefault(k, []).append(v["value"])
    for k, vals in sorted(by_metric.items()):
        if len(vals) < 3:
            print(f"{k}: {len(vals)} runs, too few")
            continue
        med, q1, q3, s, s_trim = spreads(vals)
        print(f"{k}: {len(vals)} runs, median {med!r}, quartiles {q1!r} "
              f"{q3!r}, spread {s:.4f}, without the farthest {s_trim:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
