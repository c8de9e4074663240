"""Read a cell's compared number for the program and for its control on
several seeds in one process, to set the cell's limit from (the
benchmark's own runs never run the control).

    python3 bench/controls.py --workload <name> --seconds <s> --seeds 1 2 3

For each seed: set-up as a run, a window of ``--seconds``, then the
number as the run compares it (``program``) and the same number for the
reference in the next lower precision put in the program's place
(``control``).  Prints one JSON line a seed.
"""
import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import harness  # noqa: E402


def readings(cell, seed: int, seconds: float, device) -> dict:
    run = harness.Run(cell, seed=seed, seconds=seconds, trace=False,
                      device=device)
    st = cell.driver.setup(run)
    with run.window():
        cell.driver.measure(run, st)
    program = cell.driver.gap(run, st)
    return {"seed": seed, "program": program,
            "control": cell.driver.gap(run, st, control=True)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("controls: no CUDA card", file=sys.stderr)
        return 3
    cell = harness.resolve(args.workload)
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload,
                          **readings(cell, seed, args.seconds,
                                     torch.device("cuda", 0))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
