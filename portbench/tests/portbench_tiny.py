"""A benchmark root at a size the CPU runs in seconds, for the tests.

``tiny_root`` copies BENCHMARK.json and the benchmark's data files and adds
a cell the way a later change would: a configuration, a traffic mix and a
per-layer metric, each a new file, and their entries in BENCHMARK.json.
``run_tiny`` drives a whole run of that cell on the CPU (the port's plain
kernel versions), skipping only the harness's look for a card.
"""

import io
import json
import os
import shutil
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

CELL = "tiny8.tiny"
METRIC = "jobs.per_window"


def tiny_root(tmp_path):
    root = os.path.join(str(tmp_path), "root")
    shutil.copytree(os.path.join(REPO, "portbench"),
                    os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    pb = os.path.join(root, "portbench")
    with open(os.path.join(pb, "configs", "kang8_a2.json")) as fh:
        cfg = json.load(fh)
    cfg.update(name="tiny8", snps=2000, cell_block=32)
    with open(os.path.join(pb, "configs", "tiny8.json"), "w") as fh:
        json.dump(cfg, fh)
    with open(os.path.join(pb, "traffic", "unfiltered.json")) as fh:
        traffic = json.load(fh)
    traffic.update(cells=40, empty=24)
    traffic["cell_coverage"] = dict(median=40, sigma=0.6, clip=[5, 200])
    with open(os.path.join(pb, "traffic", "tiny.json"), "w") as fh:
        json.dump(traffic, fh)
    with open(os.path.join(pb, "metrics", METRIC + ".py"), "w") as fh:
        fh.write('def read(ctx):\n    return float(len(ctx["jobs"]))\n')
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    bench["configs"].append(dict(name="tiny8", source="tests",
                                 file="portbench/configs/tiny8.json",
                                 reduced=["snps"], why="tests"))
    bench["workloads"].append(dict(name=CELL, config="tiny8",
                                   traffic="tiny", chips=1, why="tests"))
    for m in bench["per_layer"]:
        m["workloads"].append(CELL)
    bench["per_layer"].append(dict(
        name=METRIC, unit="jobs", better="higher", source="host_clock",
        layer="tests", moves="barcodes_per_s", workloads=[CELL]))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    return root


def run_tiny(root, seed=2 ** 31 + 11, traced=False, seconds=0.3):
    """(exit code, the result line's object or None, stderr text)."""
    import torch

    from portbench import harness

    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(root, CELL, seed, seconds, traced, time.monotonic(),
                     device=torch.device("cpu"), out=out, err=err)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
