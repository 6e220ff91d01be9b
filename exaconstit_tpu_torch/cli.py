"""Command line: ``python -m exaconstit_tpu_torch.cli -opt file.toml``.

The reference binary's interface (``mechanics -opt options.toml``) plus
``--device`` (default: the card, ``cuda``; with no card present the run
stops with an error unless ``--device cpu`` is given).
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="mechanics",
        description="ExaConstit in PyTorch: crystal-plasticity FEM")
    parser.add_argument("-opt", "--options", dest="opt", required=True,
                        help="TOML options file to use")
    parser.add_argument("-q", "--quiet", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs on the "
                             "CPU)")
    args = parser.parse_args(argv)

    from .driver import run_simulation

    start = time.time()
    sim = run_simulation(args.opt, verbose=not args.quiet,
                         device=args.device)
    print(f"The process took {time.time() - start:f} seconds to run")
    # per-step solve times, as the reference's time/time_solve.0.txt
    # (under timing/: a time/ directory on sys.path would shadow the
    # stdlib module)
    os.makedirs("timing", exist_ok=True)
    with open("timing/time_solve.0.txt", "a") as f:
        for dt in sim.step_times:
            f.write(f"{dt:.8g}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
