"""The controls of the comparison, read on the card at the cells' own
sizes (the benchmark's runs do not run them).

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 \\
        [--seconds 10] [--program-f32] [--fault velocity_altered]

For each seed it runs the cell as the benchmark does and prints one JSON
line with the numbers of the program (the lower readings) and of the
float32 reference put in the program's place on the same episode (the
control), each with its ``correct`` worked out as the benchmark's is,
and the Newton counts of the window.  ``--fault <name>`` runs the
program with a fault of ``faults.py`` planted instead, and
``--program-f32`` adds a run of the program's own float32 path
(``Solvers.precision = "f32"``), the control the program itself offers.
A run that raises prints its error in place of numbers.  It exits with 1
if a control or a fault reads correct.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--program-f32", action="store_true")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from benchmark import core
    from benchmark.faults import FAULTS

    fault = FAULTS[args.fault] if args.fault else None
    passed = []
    for seed in args.seeds:
        lines = []
        r = core.run(args.workload, seed, args.seconds, False,
                     device=args.device, fault=fault,
                     control=None if fault else "reference32",
                     log=lambda *a: lines.append(" ".join(map(str, a))))
        line = dict(workload=args.workload, seed=seed, correct=r["correct"],
                    program={k: v["value"] for k, v in r["checks"].items()},
                    window=[s for s in lines if s.startswith("window:")])
        if fault:
            line["fault"] = args.fault
            passed.append(r["correct"])
        else:
            line["reference32"] = r.get("control")
            line["reference32_correct"] = r.get("control_correct")
            passed.append(bool(r.get("control_correct", True)))
        if args.program_f32:
            try:
                f32 = core.run(args.workload, seed, args.seconds, False,
                               device=args.device,
                               overrides={"precision": "f32"},
                               log=lambda *a: None)
                line["program_f32"] = {k: v["value"]
                                       for k, v in f32["checks"].items()}
                line["program_f32_failed"] = f32["failed"]
            except RuntimeError as e:
                line["program_f32"] = f"raised: {e}"
        print(json.dumps(line), flush=True)
    return 1 if any(passed) else 0


if __name__ == "__main__":
    sys.exit(main())
