"""Compare two trees of the repository on the benchmark's cells, in turns,
on one card.

    python scripts/bench_ab.py --base DIR [--cells A,B] [--rounds 1]
        [--seed S] [--traced]

DIR is a copy of another commit (for example the parent, unpacked with
`git archive`).  Each round runs, for every cell, the benchmark's own
command (`python -m benchmark.run --cell C --seed S`) as a fresh process
four times: in DIR, in this tree, in this tree, in DIR.  With `--traced`
one traced run of each cell follows in each tree.  Every run's result line
goes to `ab.json` beside `benchmark.spread`'s output; the last line printed
is one JSON object with, for each cell and metric, the readings of both
sides, their medians, the ratio of the medians (this tree over DIR) and
whether every run of this tree read better than every run of DIR.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from benchmark import spread  # noqa: E402

OUT = os.path.join(os.path.dirname(spread.OUT), "ab.json")
# metrics where a lower reading is the better one
LOWER_IS_BETTER = {"frame_ms_p50", "frame_ms_p90", "frames_lost",
                   "make_frame_ms", "match_ms", "ransac_ms", "pose_ba_ms",
                   "track_local_map_ms", "map_keyframe_ms", "local_ba_ms",
                   "loop_sync_ms", "kernels_per_frame", "host_reads_per_frame",
                   "peak_mem_gib"}


def run_once(tree: str, cell: str, seed: int, traced: bool) -> dict:
    """The benchmark's command in `tree` as a fresh process -> its last
    line, with the tree, wall time and exit code added.  Output echoed."""
    cmd = [sys.executable, "-m", "benchmark.run", "--cell", cell, "--seed",
           str(seed)] + (["--traced"] if traced else [])
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=tree, capture_output=True, text=True,
                          timeout=3000)
    sys.stdout.write(proc.stdout)
    sys.stdout.write(proc.stderr[-4000:])
    sys.stdout.flush()
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    result = json.loads(lines[-1]) if lines else {"correct": False,
                                                  "metrics": {}}
    result.update(tree=tree, wall_s=time.perf_counter() - t0,
                  rc=proc.returncode)
    return result


def summarise(runs: list[dict], base: str) -> dict:
    out = {}
    for cell in sorted({r["cell"] for r in runs if "cell" in r}):
        rows = {}
        for traced in (False, True):
            mine = [r for r in runs if r.get("cell") == cell
                    and r["traced"] == traced and r["tree"] == REPO]
            theirs = [r for r in runs if r.get("cell") == cell
                      and r["traced"] == traced and r["tree"] == base]
            names = sorted({k for r in mine + theirs for k in r["metrics"]})
            for name in names:
                a = [r["metrics"].get(name) for r in theirs]
                b = [r["metrics"].get(name) for r in mine]
                if any(v is None for v in a + b) or not a or not b:
                    continue
                lower = name in LOWER_IS_BETTER
                better = (max(b) < min(a)) if lower else (min(b) > max(a))
                key = name + (" (traced)" if traced and name in (
                    "fps", "frame_ms_p50", "frame_ms_p90", "frames_lost")
                    else "")
                rows[key] = {"base": a, "this": b,
                             "base_median": float(np.median(a)),
                             "this_median": float(np.median(b)),
                             "ratio": (float(np.median(b) / np.median(a))
                                       if np.median(a) else None),
                             "every_run_better": bool(better)}
        correct = {side: [r["correct"] for r in runs if r.get("cell") == cell
                          and r["tree"] == tree]
                   for side, tree in (("base", base), ("this", REPO))}
        out[cell] = {"correct": correct, "metrics": rows}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", required=True)
    ap.add_argument("--cells", default="vo_tum640_stream,"
                                       "slam_loop_tum640_chunk64")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--traced", action="store_true")
    args = ap.parse_args(argv)
    base = os.path.abspath(args.base)
    cells = args.cells.split(",")
    runs = []
    for _ in range(args.rounds):
        for cell in cells:
            for tree in (base, REPO, REPO, base):
                runs.append(run_once(tree, cell, args.seed, False))
    if args.traced:
        for cell in cells:
            for tree in (base, REPO):
                runs.append(run_once(tree, cell, args.seed, True))
    summary = summarise(runs, base)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump({"base": base, "runs": runs, "summary": summary}, f,
                  indent=1)
    print(json.dumps(summary), flush=True)
    ok = all(r.get("correct") for r in runs if r["tree"] == REPO)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
