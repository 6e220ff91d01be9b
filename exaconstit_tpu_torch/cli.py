"""Command line: ``python -m exaconstit_tpu_torch.cli -opt file.toml``.

The reference binary's interface (``mechanics -opt options.toml``) plus
``--device`` (default: the card, ``cuda``; with no card present the run
stops with an error unless ``--device cpu`` is given) and ``--shards``.
With ``EXACONSTIT_TPU_PROFILE_DIR`` set the run is traced by
``torch.profiler`` into that directory (``utils/profiling.maybe_profile``).

Under ``torchrun`` (or with ``EXACONSTIT_TPU_DIST=1`` and its variables)
the run starts a process group first (``parallel.sharding.
init_distributed``: NCCL, one card per rank, or gloo on the CPU) and is
spread over ``--shards`` shards, by default one per rank:

    torchrun --nproc-per-node N -m exaconstit_tpu_torch.cli -opt case.toml

``--shards S`` (a multiple of the ranks) stacks S / N shards on each
rank's device, also in one process without a launcher.  Over shards the
options file's ``Solvers.parallel_mode`` picks the system as the
reference does: the slab domain decomposition ("auto" or "slab", an
ExaCMech material with PCG on a mesh it partitions) or the
replicated-node element sharding ("replicated", "single", and "auto"
on everything else).  Every rank writes its step times to
``timing/time_solve.<rank>.txt``; only rank 0 writes the run's other
outputs.
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
    parser.add_argument("--shards", type=int, default=None,
                        help="shards to spread the run over (the slab or "
                             "the replicated-node system, as "
                             "Solvers.parallel_mode picks), a multiple of "
                             "the ranks (default: one per rank under a "
                             "launcher, none in one process)")
    args = parser.parse_args(argv)

    from .driver import run_simulation
    from .parallel import sharding
    from .utils.profiling import maybe_profile

    start = time.time()
    try:
        device = sharding.init_distributed(args.device)
        rank = sharding.process_rank()
        with maybe_profile(device):
            sim = run_simulation(args.opt, verbose=not args.quiet,
                                 device=device, shards=args.shards)
    finally:
        sharding.shutdown_distributed()
    print(f"The process took {time.time() - start:f} seconds to run")
    # per-step solve times, as the reference's time/time_solve.<rank>.txt
    # (under timing/: a time/ directory on sys.path would shadow the
    # stdlib module)
    os.makedirs("timing", exist_ok=True)
    with open(f"timing/time_solve.{rank}.txt", "a") as f:
        for dt in sim.step_times:
            f.write(f"{dt:.8g}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
