"""Readings that set a fast-mode configuration's ``rows_gap`` limit, at a
cell's own size.

    python3 portbench/control_fast.py --workload <cell> --seeds <n>...

For each seed, the cell's two libraries and three readings, each the
widest over both libraries: (a) one job of the program on each library
(the configuration's ``--mode fast``: the pair search and the singlet term
in float32), compared with the float64 reference as a run compares them
(``harness.check``), the lower reading of the limit; (b) the same job with
TF32 allowed for float32 matmuls, the lower precision a fast run slips
into if the device set-up (``utils/device.resolve_device``) leaves TF32 on:
the front's LUT contraction is then a TF32 GEMM; (c) the control, the
reference computed in bfloat16 (its tables and sums), one precision below
the configuration's float32, decided in float32 and put in the program's
place, the upper reading. (b) and (c) are compared with the float64
reference as (a) is. One JSON line per seed on standard output. Needs the
CUDA card, as a run does; the benchmark's own runs never run this.
``control.py`` gives the program's and a float32 control's readings for
the float64 configurations.
"""

import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tf32_rows(lib, gps, cfg, device):
    """The rows of one job of the program with TF32 allowed for float32
    matmuls (and switched off again after it)."""
    import torch

    from portbench import harness

    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        _, rows, _ = harness.run_job(lib, gps, cfg, device,
                                     harness.Spans(False))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    return rows


def low_gaps(lib, gps, cfg, device):
    """{"tf32": (rows_gap, field), "control": (rows_gap, field)}: the TF32
    program's rows and the bfloat16 reference's against the float64
    reference."""
    import numpy as np
    import torch

    from portbench import compare, reference

    V, A = cfg["donors"], len(cfg["grid_alpha"])
    tf32 = tf32_rows(lib, gps, cfg, device)
    ref = reference.decide(reference.llks(lib, gps, cfg, device), cfg)
    low = reference.decide(
        reference.llks(lib, gps, cfg, device, dtype=torch.bfloat16), cfg,
        dtype=np.float32)
    return dict(tf32=compare.rows_gap(tf32, ref, V, A),
                control=compare.rows_gap(low, ref, V, A))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
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
    for seed in args.seeds:
        t0 = time.perf_counter()
        gt, gps = generator.pool_gps(cfg, seed, device)
        libs = [generator.make_library(cfg, traffic, gt, seed, i, device)
                for i in range(2)]
        del gt
        torch.cuda.empty_cache()
        kept, routes = [], set()
        for lib in libs:
            rec, rows, texts = harness.run_job(lib, gps, cfg, device,
                                               harness.Spans(False))
            kept.append([(rows, texts)])
            routes.add(rec["route"])
        torch.cuda.empty_cache()
        program = harness.check(libs, gps, cfg, kept, seed, device, log)
        del kept
        torch.cuda.empty_cache()
        gaps = [low_gaps(lib, gps, cfg, device) for lib in libs]
        low = {k: max(g[k] for g in gaps) for k in ("tf32", "control")}
        print(json.dumps(dict(
            workload=args.workload, seed=seed, route=sorted(routes),
            program=program,
            **{k: dict(rows_gap=v[0], field=v[1]) for k, v in low.items()},
            limit=cfg["limits"]["rows_gap"],
            seconds=time.perf_counter() - t0)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
