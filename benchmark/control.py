"""Readings from which a cell's limits are set (not run by the benchmark's
own runs): the program's compared numbers on each of ``--seeds``, and the
control's on each of ``--control-seeds``, where the control is the plain
reference one precision below the cell's (the driver's ``CONTROL``) put
in the program's place. The program decodes the units that a run's check would
compare (``check_units`` of them) at the cell's own sizes; one process,
one JSON line a reading:

    python3 benchmark/control.py --workload <cell> --seeds 1 2 ... --control-seeds 7 8 9
"""

import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402


def main(argv) -> int:
    from benchmark import core

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    spec = core.load_spec()
    cell, cfg, traffic = core.cell_files(spec, args.workload)
    core.set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    module = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    Driver, n = module.Driver, traffic["check_units"]
    for side, seeds in (("program", args.seeds),
                        (module.CONTROL[traffic["dtype"]], args.control_seeds)):
        for seed in seeds:
            driver = Driver(cfg, traffic, seed, dev)
            t0 = time.time()
            if side == "program":
                driver.start()
                for i in range(n):
                    driver.unit(i)
            t1 = time.time()
            driver.release()
            got = driver.readings(n, [side], ["lp_gap", "mismatch", "score_drop"])[side]
            print(json.dumps({"workload": cell["name"], "side": side, "seed": seed,
                              "units": n, "decode_s": t1 - t0,
                              "check_s": time.time() - t1, **got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
