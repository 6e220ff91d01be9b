"""The benchmark's command: one run of one cell on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

It writes the cell's inputs from the seed, builds the port's
``Simulation`` on the card, warms up one episode, measures whole
episodes for ``--seconds`` of step time, checks the sampled episode
against the plain reference, and prints the result as one JSON line,
last on standard output; the numbers compared, each beside its limit,
are the last lines on standard error.  Without a card (or with fewer
than the cell asks for) it prints no result and exits with 2.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# one process with few threads: the host's pools stay out of the way of
# the thread that launches the card's work
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# build and kernel caches at fixed paths inside the checkout
CACHE = os.path.join(REPO, ".bench_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(CACHE, "inductor")
sys.path.insert(0, REPO)


def _finite(x):
    return x if isinstance(x, float) and math.isfinite(x) else None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from benchmark import core

    torch.set_num_threads(1)
    chips = core.resolve(args.workload)[0]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); torch.cuda.is_available() = "
              f"{torch.cuda.is_available()}, {torch.cuda.device_count()} "
              "found", file=sys.stderr)
        return 2
    result = core.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), device="cuda", t_start=T_START)
    for c in result["checks"].values():
        c["value"] = _finite(c["value"])
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
