"""Readings that set the comparison's limits, at a cell's own size.

    python3 portbench/control.py --workload <cell> --program-seeds <n>... \
        --control-seeds <n>...

For each program seed: the cell's two libraries, one job of the program on
each, and the comparison's numbers (the lower readings of the limits). For
each control seed: the reference computed in float32, one precision below
the configuration's float64, put in the program's place and compared with
the float64 reference in the same way (the upper reading of ``rows_gap``).
One JSON line per seed on standard output. Needs the CUDA card, as a run
does; the benchmark's own runs never run this.
"""

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_gap(lib, gps, cfg, device):
    """rows_gap of the float32 reference against the float64 one."""
    import numpy as np
    import torch

    from portbench import compare, reference

    ref = reference.decide(reference.llks(lib, gps, cfg, device), cfg)
    low = reference.decide(
        reference.llks(lib, gps, cfg, device, dtype=torch.float32), cfg,
        dtype=np.float32)
    return compare.rows_gap(low, ref, cfg["donors"], len(cfg["grid_alpha"]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--program-seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from demuxlet_tpu_torch.utils.device import resolve_device
    from portbench import generator, harness

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    _, cfg, traffic, _, _ = harness.load_cell(ROOT, args.workload)
    torch.set_num_threads(harness.TORCH_THREADS)
    device = resolve_device("auto")
    harness.log_card(log)
    for kind, seeds in (("program", args.program_seeds),
                        ("control", args.control_seeds)):
        for seed in seeds:
            t0 = time.perf_counter()
            gt, gps = generator.pool_gps(cfg, seed, device)
            libs = [generator.make_library(cfg, traffic, gt, seed, i, device)
                    for i in range(2)]
            del gt
            torch.cuda.empty_cache()
            if kind == "program":
                kept = []
                for lib in libs:
                    _, rows, texts = harness.run_job(
                        lib, gps, cfg, device, harness.Spans(False))
                    kept.append([(rows, texts)])
                torch.cuda.empty_cache()
                values = harness.check(libs, gps, cfg, kept, seed, device,
                                       log)
            else:
                gaps = [control_gap(lib, gps, cfg, device) for lib in libs]
                worst = max(gaps)
                values = dict(rows_gap=worst[0], field=worst[1])
            print(json.dumps(dict(workload=args.workload, kind=kind,
                                  seed=seed, **values,
                                  seconds=time.perf_counter() - t0)),
                  flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
