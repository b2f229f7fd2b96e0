"""Where `chip_smoke.py`'s time goes: run its `main()` with every
module-level function of the script wrapped to sum its inclusive wall
seconds and its calls, then print them, largest first, and write them to a
JSON file. Nested functions count in each caller, so the rows overlap.

    python3 scripts/smoke_profile.py [--out smoke_profile.json]

Run it from the root of a checkout on a machine with a GPU, as
`chip_smoke.py` runs (its last line and exit code are the script's). The
wrappers cost about a microsecond a call. The functions that the script's
worker processes start by name (`_spatial_rank`, `_parallel_rank`,
`_count_saved_calls`) run unwrapped, so their time shows in their
callers only.
"""
import argparse
import functools
import json
import pathlib
import sys
import time
import types

ROOT = pathlib.Path(__file__).resolve().parent.parent
UNWRAPPED = {"main", "_spatial_rank", "_parallel_rank", "_count_saved_calls"}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="smoke_profile.json")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    stats = {}

    def wrap(name, fn):
        @functools.wraps(fn)
        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                s = stats.setdefault(name, [0, 0.0])
                s[0] += 1
                s[1] += time.perf_counter() - t0
        return timed
    for name, obj in list(vars(chip_smoke).items()):
        if isinstance(obj, types.FunctionType) and name not in UNWRAPPED \
                and obj.__module__ == chip_smoke.__name__:
            setattr(chip_smoke, name, wrap(name, obj))
    t0 = time.perf_counter()
    rc = 1
    try:
        rc = chip_smoke.main()
    finally:
        total = time.perf_counter() - t0
        rows = sorted(stats.items(), key=lambda kv: -kv[1][1])
        with open(args.out, "w") as f:
            json.dump({"total_s": total, "rows": rows}, f, indent=0)
        print("profile: main() %.1f s" % total, file=sys.stderr)
        for name, (n, s) in rows[:60]:
            print("profile: %-40s %6d calls %8.1f s" % (name, n, s),
                  file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
