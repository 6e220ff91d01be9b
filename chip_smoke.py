#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (exaconstit_tpu_torch) on one GPU.

    python3 chip_smoke.py [--only PHASE,...] [--reps N]

With no arguments it runs every phase below; ``--only`` runs the named
phases alone (names in ``PHASES``; the device and build phases always
run) and prints no result line; ``--reps`` times phases 14's and 20's
``make_step`` calls N times after a warm call (to compare two trees).  Phases, each printing a line; any
failed check exits non-zero with no result line:

1. device: the card's name and power limit (nvidia-smi), TF32 off;
2. build: nvcc builds the dogleg kernel from csrc/; registers and spills
   from -Xptxas -v, resident blocks per SM from the occupancy query (no
   spills, and at least 16 resident warps per SM); then the PA apply's
   kernels (csrc/pa_apply.cu) and the EA apply's (csrc/ea_apply.cu):
   registers, local bytes and resident blocks of each, no spills;
3. the kernel against its plain PyTorch version on seeded inputs at
   884,736 points (a 48^3 mesh x 8 quadrature points) and 262,144
   (32^3): converged flags, solutions (atol 2e-5), residuals, inactive
   lanes untouched, median times, iteration histogram, and the bound
   (the larger of the operations the iteration counts need over the f32
   peak and the bytes over the memory rate) with the share reached; and
   the same checks on a BCC Voce model (``bcc12`` slip tables) at 262,144
   points;
4. the f64-polished staggered solve through the kernel against through
   the plain version, 262,144 points, 2 substeps (atol 5e-9); and the
   same solve in pure f64 (the plain trust region, as the MTSDD models
   run it) timed beside the mixed one;
5. the main path: ``run_simulation`` on an in-repo 32^3 FCC Voce case
   (500 Voronoi grains, uniaxial tension, dt 0.1, 0.2, 0.5) on the
   card, with the kernel's launch count and the EA apply's (its
   operator applies and the V-cycle's on the strided map) reset just
   before and read just after; both launched, every step converges,
   stress is finite, and the hardening slope drops below half the
   elastic one.  Region timings on
   (EXACONSTIT_TPU_REGIONS): the seconds and calls of the setups, the
   line-search residuals and the Krylov solves.  Each launch records a CUDA
   event pair around the kernel call alone (not the wrapper's output
   allocations and counter fill) and its lanes' largest and summed
   iteration counts on the
   device; they are read once after the run: device ms per launch
   (median, max), the launches in which some lane hit max_iter, and the
   path's kernel time against its bound;
6. the same case at 4^3 for 2 steps on the card and on the CPU (the
   plain versions there): average stress to rel 1e-6;
7. the MTSDD path: ``run_simulation`` on the in-repo 32^3 copper FCC
   MTSDD case (500 grains, two steps of dt 0.01) on the card, with
   the additional averages, one checkpoint and one VTU/PVD dump
   written.  Its point solve is pure f64 (plain PyTorch; it must
   launch the kernel no time): per step the seconds, Newton and Krylov
   counts, sub-solves, seconds in the f64 trust-region solves and their
   iterations; peak memory; every output file is read back;
8. the MTSDD case at 4^3 for 1 step on the card and on the CPU: average
   stress to rel 1e-6;
9. the mesh-file path: the Voce case of phase 5 written as an MFEM mesh
   file and run through the CLI entry point (``Mesh.type = "other"``,
   PA assembly, PCG with Jacobi, the index gather/scatter, cold point
   solves) on the card, dt 0.1.  First, two calls of the first
   setup give bitwise-equal residuals, PA tensors and diagonals (the
   index scatter uses no atomics); then, with the kernel's launch count
   reset just before the run and read just after, per step the seconds,
   Newton and Krylov counts and sigma_zz, the region timings of the
   setups, line searches and Krylov solves, the PA applies, peak memory;
   and at the first setup, in f32 and f64, the PA apply's kernel pair
   (csrc/pa_apply.cu) against its plain version (max gap over max |y|
   1e-5 and 1e-12, two calls bitwise equal, the node pass bitwise the
   plain scatter), its device time beside its bytes bound, ``apply_k``'s
   time a call and the plain version's;
10. (``--only configs``) CUDA against CPU at 4^3 for 2 steps, average
   stress to rel 1e-6 (f32: rel 1e-4), for each configuration the earlier
   phases do not run: a mesh file with EA, PA, B-bar, GMRES, MINRES, the
   elastic UMAT, and the Voce case in f32;
11. the f32 path: the 32^3 Voce case written with ``precision = "f32"``
   through the CLI on the card (plain f32 PCG with GMG, the plain f32
   trust region: the kernel must launch no time), ten steps of dt 0.01
   (``F32_DTS``).  First, at the first setup of step 1 at 4^3 and at
   32^3, f32 PCG at Krylov tolerances 1e-4 to 1e-8: iterations and the
   true residual it leaves.  Then per step the seconds, Newton and
   Krylov counts, sub-solves, sigma_zz (and its gap to phase 5's f64
   value where the two reach the same time), the seconds and loop trips
   in the f32 trust-region calls, and peak memory;
12. a 4^3 CLI run under EXACONSTIT_TPU_PROFILE_DIR: the Chrome trace holds
   the kernel's events and the three region names;
13. a 4^3 run with EXACONSTIT_CHECK_NUMERICS=1 on the card: it passes and
   writes the averages of the run without it;
14. ``MechSystem.make_step`` (2 Newton iterations) at 32^3 in f64 from
   phase 5's start: one call on its first step (dt 0.1), where the step
   with no line search ends with non-finite points (the f32 stage's
   failed lanes, polished anyway); then at dt 0.01, where it is finite,
   the seconds of one call after one warm call, kernel launches per
   call, point evaluations (3 setups x points) per second;
15. (folded into phase 21 (d), which runs ``workflows.run_loading``
   under the loading sweep's command line);
16. a ``kernels`` JSON line; then the ``ok`` JSON line, last (after
   phases 17 to 21);
17. the slab domain decomposition (``parallel/``): (a) the 32^3 Voce case
   with ``parallel_mode = "slab"`` and Jacobi through the CLI under
   torchrun's variables for a world size of 1 (an NCCL process group),
   ``--shards 4`` (8 z-layers a shard), dt 0.1 (phase 9's step), with
   the kernel's launch count reset just before and read just after: per
   step the seconds, Newton and Krylov counts, sub-solves and sigma_zz,
   held at rel 1e-4 to a one-device run with the same sub-solves (phase
   5's where they match, else one device forced to the slab's sub-solves:
   ``SLAB_SZZ_RTOL``); the wall, peak memory, the
   kernel's ms per launch, the halo exchanges and the bytes each moves, the
   region split (EXACONSTIT_TPU_REGIONS); which setup layers round
   differently when a shard is computed alone rather than in the stack
   (logged); then, in a fresh NCCL group, one f32 matvec, its halo
   exchange and one dot timed alone, beside the dot with no group and the
   single device's matvec and dot; (b) ``SlabMechSystem`` against the
   single-device system at the slab's numerics (Jacobi, the f64 EA build)
   at 8x8x16 over 4 shards on the card, that step with Newton at rel 1e-9
   and Krylov at rel 1e-10: averages rtol 1e-5, stress and state rtol
   1e-6 / atol 1e-9, velocity atol 1e-9; (c) the card against the CPU at
   4^3 over 2 shards (rel 1e-6); (d) with two cards or more, 2 NCCL ranks
   under torchrun, one card each, ``--shards 4``, against (a) on the final
   checkpoint's arrays (rtol 1e-8, atol 1e-14), and with four cards 4
   ranks held as (a) is (see ``slab_cards``); with one card it logs that
   the leg did not run;
18. the replicated-node element sharding (``parallel/replicated.py``):
   (a) the 32^3 Voce case with ``parallel_mode = "replicated"`` through
   the CLI under torchrun's variables for a world size of 1 (an NCCL
   process group), ``--shards 3`` (32,768 elements do not divide by 3: one
   pad element, a copy of element 0), dt 0.1, with the kernel's
   launch count reset just before and read just after (one launch per
   setup over the rank's 262,152 padded points): per step the seconds,
   Newton and Krylov counts, sub-solves, sigma_zz held at rel 1e-4 to a
   one-device run with the same sub-solves (phase 5's, else one device
   forced to them at this path's numerics: Jacobi, the f32 EA build), and
   the all-reduces with the bytes each moves; the wall, peak memory, the
   kernel's ms per launch and the region split; (b) ``MechSystem`` on a
   ``ReplicatedMap`` over 3 shards against the single-device system at
   this path's numerics at 8x8x16, with phase 17 (b)'s steps and bars;
   (c) the card against the CPU at 4^3 over 3 shards (rel 1e-6, f32
   1e-4) for the elastic UMAT, GMRES, MINRES, a mesh file with EA, PA,
   B-bar, "auto" on the brick the slab cannot partition, and the Voce
   case in f32; (d) with two cards or more, 2 NCCL ranks x 2 shards under
   torchrun against one rank's 4 shards on the final checkpoint's arrays
   (rtol 1e-8, atol 1e-14); with one card it logs that the leg did not
   run;
19. the point update's remaining knobs (``--only variants``): (a) the
   32^3 Voce case (phase 5's steps) through ``Simulation`` with
   ``tangent_mode = "coupled"`` on the component-major engine, the
   kernel's launch count reset just before and read just after: per step
   the seconds, Newton and Krylov counts, sub-solves and sigma_zz; the
   launches and their device ms; with phase 5 run, its first two steps
   at phase 5's sub-solves (this run's, or the same model forced to them)
   held to phase 5's sigma_zz at rel 1e-4 (a tangent steers Newton, it
   does not move a converged step); (b) the 32^3 Voce case with
   ``hardness_mode = "coupled"``: the point-major path and the per-point
   engine in f64 (the kernel launched no time), up to five dt 0.01 steps
   while they fit 40 s (at least one): per step the seconds and counts,
   the per-point trust
   region's calls, loop trips and seconds, peak memory; (c) every knob of
   the point update on the 4^3 Voce case, one dt 0.2 step, the card
   against the CPU (rel 1e-6); (d) forward-mode JVPs of a 5-step
   material-point curve at 262,144 points in the Voce h0, gs0 and xm: the
   kernel's stage against the plain one (rel 1e-5 of the largest
   tangent), both against a central difference of the curve's mean
   sigma_zz (rel 1e-4), the values with dual inputs against those without
   (rel 1e-12); and an MTSDD (SplineG) curve with ``ift_tangents`` at
   1,024 points, its c1 tangent on the card against the CPU (rel 1e-6);
20. production-size meshes on one card (``--only large``), the Voce case
   (500 grains, uniaxial tension), under ``torch.inference_mode``: (a) at
   64^3, ``MechSystem.make_step(2)`` from phase 5's start at dt 0.01 with
   the setup whole (``EXACONSTIT_SETUP_CHUNKS=1``) and in "auto"'s 8
   element chunks: the seconds of one call after a warm call,
   kernel launches per call (3 against 24) and points per launch, the
   memory held before the calls and their peak; then one setup's six
   outputs, chunked against whole: bitwise equal, or the largest absolute
   difference of each, held at the reference's bar (rtol 0, atol 1e-12)
   on every output, the f32-built blocks and their diagonal included,
   with the chunk, the layer and the op where they part; (b) one
   ``run_simulation`` step at dt 0.005 (the first dt of bench.py's ramp),
   chunks "auto": Newton and Krylov counts, sub-solves, sigma_zz, wall,
   peak and launches; (c) the storage rule: one setup with the f64 EA
   build, whose "auto" storage takes f32 above 1,500,000 points: blocks
   bitwise the f64 build's cast to f32, the diagonal and every other
   output bitwise the f64 system's, the blocks' bytes and each setup's
   peak; (d) at 96^3, chunks "auto" (27 chunks of 262,144 points; GMG
   down to 6^3 and its dense coarse solve): one ``make_step(1)`` call
   after a warm call, with its seconds, peak memory and launches.  The ``kernels`` line gains the
   64^3 launches per call and ms per launch;
21. the port's entry points (``--only entry``): (a) ``entry.entry()``'s
   first setup at 2^3 on the card against the CPU (rel 1e-9, the
   f32-built EA blocks and their diagonal 1e-6), and
   ``entry.dryrun_multichip(4)`` on one card (the replicated-node
   ``make_step(2)`` on 2x2x4 and the slab's Newton solve on 16x16x8 over
   4 shards): seconds, Newton iterations, kernel launches; (b) the 32^3
   Voce case with and without ``EXACONSTIT_TPU_NO_STRUCT=1``, both with
   the EA apply's plain form (the strided map's kernel pair sums in
   another order than the index map's einsum; phase 22 holds it to the
   plain form): the BC corrector and step 1's first setup and Krylov
   solve bitwise equal, the index map and GMG taken, one scatter-add
   timed for each map; (c)
   ``EXACONSTIT_TPU_PRECISION`` through the CLI at 4^3 on the f32 case
   file and a copy that says ``precision = "f64"`` (the same
   tolerances): "f32" on the copy runs in f32 with 0 kernel launches,
   bitwise the f32 file's run, card against CPU rel 1e-4; "f64" on the
   f32 file runs in f64 with the kernel, bitwise the copy's run, card
   against CPU rel 1e-6; (d) the workflow command lines at 4^3 on the
   card: the loading sweep at ``--n_axial 1`` (4 loads) against the same
   on the CPU (rel 1e-6), and the differential evolution and the
   NSGA-III fit at ``--pop 4 --gens 1`` against a three-step curve from
   a seeded port run with the Voce g0 moved: each finishes with no
   failed candidate, writes its checkpoint and resumes from it without
   running generation 0 again;
22. the EA apply's kernel pair (``--only ea_apply``, csrc/ea_apply.cu)
   at 32^3 on seeded f32 blocks, with an f32 x and with an f64 x:
   ``operators.apply_ea`` launches it once, within ``EA_TOL`` of the
   plain version over the largest |y|, two calls bitwise equal, the node
   pass bitwise the plain scatter of the kernel's element vectors; its
   device time (element and node pass, profiler) beside its bytes bound,
   ``operators.apply_ea`` a call (CUDA events, with the host's part) and
   the plain version's time a call, logged (the times decide nothing).
"""

import argparse
import collections
import contextlib
import dataclasses
import gc
import glob
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

STAGE_SIZES = (884_736, 262_144)
TOL, MAX_ITER = 1e-6, 200
# Three steps against the smoke's time limit (a fourth, dt 1.0, is the
# slowest of all); step 3 crosses yield
MAIN_DTS = (0.1, 0.2, 0.5)
# Smaller steps than the Voce path's: at 32^3 the Newton solve of this
# family's first steps does not converge at dt 0.1 (every step starts
# from a velocity field kinked at the loaded face's nodes; ROADMAP C8)
# two steps: a third was cut to make room for phase 19
MTSDD_DTS = (0.01, 0.01)
# The mesh-file PA path: the main path's first step.  Its third (dt 0.5,
# across yield) passed only as 8 sub-solves, at the last retry; its second
# was cut to keep the smoke inside its time limit on a slow host
MESH_PA_DTS = (0.1,)
# the PA kernels against their plain version, over the largest |y|
PA_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
# the EA apply's kernels against the plain version over the largest |y|,
# by x's type (f32 blocks): tests/test_torch_ea_apply.py's TOL and reason
EA_TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
# The f32 path: ten elastic steps to phase 5's first output time, t = 0.1,
# where sigma_zz compares with phase 5's f64 value.  At dt 0.1 its first
# Newton solve stalls near 0.7 of its first residual and then grows to 7x
# it, and so do its 2- and 4-step retries (the plain f32 point solve has
# no f64 polish), at a point tolerance of 1e-6 and of 1e-7 alike
F32_DTS = (0.01,) * 10
# Krylov tolerances at which phase 11 measures f32 PCG
F32_PCG_TOLS = (1e-4, 1e-5, 1e-6, 1e-7, 1e-8)
# 4^3 configurations held CUDA against CPU in phase 10: (family, options,
# rel tolerance on the average stress).  f32 runs stop Newton at rel 1e-3
# (cases.TOLERANCES), so the two devices' roundings part further
VARIANTS = {
    "mesh EA": ("voce", dict(mesh_file=True), 1e-6),
    "mesh PA": ("voce", dict(mesh_file=True, assembly="PA"), 1e-6),
    "BBar": ("voce", dict(integ_model="BBAR"), 1e-6),
    "GMRES": ("voce", dict(krylov_solver="GMRES"), 1e-6),
    "MINRES": ("voce", dict(krylov_solver="MINRES"), 1e-6),
    "UMAT": ("umat", {}, 1e-6),
    "f32": ("voce", dict(precision="f32"), 1e-4),
}
# The slab path (phase 17): phase 9's step over 4 shards (8 z-layers a
# shard at 32^3); the decomposition against one device at 8x8x16.  One
# step: a second (dt 0.2), with the one-device run forced to its
# sub-solves, was cut to keep the smoke inside its time limit on a slow
# host
SLAB_DTS = (0.1,)
SLAB_SHARDS = 4
SLAB_CHECK_GRID = (8, 8, 16)
SLAB_CHECK_NR_TOLS, SLAB_CHECK_KRYLOV_TOL = (1e-9, 1e-14), 1e-10
# sigma_zz of a slab run against a one-device run that took the same
# sub-solves in every step so far: phase 5's where it did, else one device
# forced to the slab run's sub-solves (``same_structure_szz``).  Whether a first solve converges within 25
# Newton iterations follows the rounding (ROADMAP C7, C8), and a dt 0.2
# step solved whole and the same step as two sub-solves of 0.1 differ by
# rel 1.7e-4 in sigma_zz: two time discretisations
SLAB_SZZ_RTOL = 1e-4
# the 2-rank run against one process's 4 stacked shards, on the final
# checkpoint's arrays (rtol, atol)
SLAB_RANKS_TOLS = (1e-8, 1e-14)
# the one-device numerics a sharded 32^3 run is held to, in the order
# they are tried: (name, krylov_precond, f32 EA build)
SLAB_NUMERICS = (("the slab's", "jacobi", False), ("phase 5's", "auto", True))
# The replicated-node path (phase 18): phase 17's steps over 3 shards,
# which 32,768 elements do not fill (one pad element, a copy of element 0);
# against one device at this path's numerics at 8x8x16; the card against
# the CPU at 4^3 over 3 shards for what the slab refuses and the
# point-major half: (family, options, rel tolerance on the average stress)
REPL_DTS = SLAB_DTS
REPL_SHARDS = 3
REPL_VARIANTS = {
    "UMAT": ("umat", dict(parallel_mode="replicated"), 1e-6),
    "GMRES": ("voce", dict(parallel_mode="replicated",
                           krylov_solver="GMRES"), 1e-6),
    "MINRES": ("voce", dict(parallel_mode="replicated",
                            krylov_solver="MINRES"), 1e-6),
    "mesh EA": ("voce", dict(parallel_mode="replicated", mesh_file=True),
                1e-6),
    "PA": ("voce", dict(parallel_mode="replicated", assembly="PA"), 1e-6),
    "BBar": ("voce", dict(parallel_mode="replicated", integ_model="BBAR"),
             1e-6),
    "auto, unpartitionable": ("voce", dict(parallel_mode="auto"), 1e-6),
    "f32": ("voce", dict(parallel_mode="replicated", precision="f32"),
            1e-4),
}
# the 2-rank run, 2 shards a card, against one process's 4 stacked shards
REPL_CARDS_SHARDS = 4
# this path's one-device numerics (Jacobi, the f32 EA build; the index
# map sums as the strided one does), then phase 5's
REPL_NUMERICS = (("this path's", "jacobi", True), ("phase 5's", "auto", True))
# the reference's region names (the regions of MechSystem.span)
REGIONS = ("operator_setup", "line_search", "krylov_solve")
# phase 20: the production-size meshes, the setup chunks "auto" takes
# there (262,144 points a chunk), make_step's dt (phase 14's), the first
# dt of bench.py's ramp, and the bar of the chunked setup against the
# whole one on every output, f32-built blocks included: the reference's
# own (rtol 0, atol 1e-12, tests/test_setup_chunks.py)
LARGE_EDGE, LARGE_CHUNKS = 64, 8
HUGE_EDGE, HUGE_CHUNKS = 96, 27
LARGE_DT, LARGE_STEP_DT = 0.01, 0.005
LARGE_CHUNK_ATOL = 1e-12
# timed calls of make_step after a warm call: phase 20's at 64^3 and
# 96^3 and phase 14's at 32^3 (1 each; they were 3), cut to make room
# for phase 21
LARGE_REPS, MAKE_STEP_REPS = 1, 1
SETUP_NAMES = ("residual", "EA blocks", "diagonal", "stress", "end state",
               "point solution")
BCC_STAGE_SIZE = 262_144
TPU_KERNEL = "exaconstit_tpu/solvers/dogleg_pallas.py:211"
KERNEL_SOURCE = "exaconstit_tpu_torch/csrc/dogleg_voce.cu"
PA_SOURCE = "exaconstit_tpu_torch/csrc/pa_apply.cu"
EA_SOURCE = "exaconstit_tpu_torch/csrc/ea_apply.cu"
# NVIDIA H100 SXM data sheet: f32 outside the tensor cores, HBM3
F32_OPS_PER_S = 67e12
BYTES_PER_S = 3.35e12
MIN_WARPS_PER_SM = 16


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


@contextlib.contextmanager
def env(**values):
    """Environment variables set for the body (the port's MechSystem
    reads its switches when it is built), restored after."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def event_ms(fn):
    """Device ms of one call of ``fn`` between two CUDA events."""
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1)


def cuda_time_ms(fn, reps=3):
    """Median of ``reps`` timed calls (CUDA events) after one warm-up."""
    fn()
    return float(np.median([event_ms(fn) for _ in range(reps)]))


def bound(ops, nbytes):
    """(least ms the card could take, what sets it) for ``ops`` f32
    operations and ``nbytes`` moved."""
    t_ops, t_bytes = ops / F32_OPS_PER_S, nbytes / BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def build_voce_model(xtal="FCC"):
    """The power-law Voce point model of the in-repo case, on the FCC
    lattice or with the BCC slip systems."""
    from exaconstit_tpu_torch.cases import VOCE_PROPS
    from exaconstit_tpu_torch.config.options import (ExaOptions, MechType,
                                                     SlipType, XtalType)
    from exaconstit_tpu_torch.models.ecmech import build_model
    opt = ExaOptions()
    opt.mech_type = MechType.EXACMECH
    opt.xtal_type = XtalType[xtal]
    opt.slip_type = SlipType.POWERVOCE
    return build_model(opt, VOCE_PROPS).evptn


def stage_inputs(model, n, dt, seed):
    """Seeded f32 stage inputs on the card, made as the JAX package's
    tests/test_dogleg_pallas.py makes them; every 997th lane inactive."""
    from exaconstit_tpu_torch.models import evptn_cm as cm
    from exaconstit_tpu_torch.utils.tensors import BASIS_DEV
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3, 3)).astype(np.float32) * 1e-3
    d = 0.5 * (d + np.swapaxes(d, 1, 2))
    d -= np.trace(d, axis1=1, axis2=2)[:, None, None] / 3.0 * np.eye(3)
    dev = "cuda"

    def f32(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                               device=dev)

    d_vecd = f32(np.einsum("kij,nij->kn", BASIS_DEV, d))
    w = f32(rng.normal(size=(3, n)) * 1e-3 * 0.3)
    q = rng.normal(size=(n, 4))
    q = f32((q / np.linalg.norm(q, axis=1, keepdims=True)).T)
    e = f32(rng.normal(size=(5, n)) * 2e-4)
    h = f32(0.017 + rng.uniform(0, 0.01, size=(1, n)))
    dts = torch.full((n,), dt, dtype=torch.float32, device=dev)
    Dsm = cm.vecd_to_mat_cm(d_vecd)
    deff = torch.sqrt(2.0 / 3.0 * torch.sum(d_vecd * d_vecd, dim=0))
    x0 = torch.cat([cm._initial_guess_cm(model, dts, Dsm, deff, e, q, h),
                    torch.zeros(3, n, device=dev)])
    active = torch.ones(n, dtype=torch.bool, device=dev)
    active[::997] = False
    return d_vecd, w, e, q, h, dts, x0, active


def phase_device():
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    log(smi)
    log(f"[1 device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    from exaconstit_tpu_torch import set_precision_policy
    set_precision_policy()
    check(not torch.backends.cuda.matmul.allow_tf32, "matmul TF32 is on")
    check(not torch.backends.cudnn.allow_tf32, "cuDNN TF32 is on")
    check(torch.get_float32_matmul_precision() == "highest",
          "f32 matmul precision is not 'highest'")
    return smi


def phase_build():
    from exaconstit_tpu_torch.solvers.dogleg_cuda import KERNEL
    t0 = time.perf_counter()
    path = KERNEL.build()
    secs = time.perf_counter() - t0
    logf = path.with_suffix(".log")
    build_log = logf.read_text() if logf.exists() else KERNEL.build_log
    ptxas = [ln.strip() for ln in build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    log(f"[2 build] {secs:.2f} s -> {path.name}; " + " | ".join(ptxas))
    info = KERNEL.build_info()
    warps = info["blocks_per_sm"] * info["threads"] // 32
    log(f"[2 build] {info['registers']} registers, {info['local_bytes']} "
        f"local bytes per thread, {info['blocks_per_sm']} resident blocks "
        f"of {info['threads']} threads per SM = {warps} warps per SM")
    spills = [int(v) for ln in ptxas
              for v in re.findall(r"(\d+) bytes spill", ln)]
    check(spills and not any(spills), f"the kernel spills: {ptxas}")
    check(warps >= MIN_WARPS_PER_SM,
          f"{warps} resident warps per SM < {MIN_WARPS_PER_SM}")
    from exaconstit_tpu_torch.fem.pa_apply_cuda import KERNEL as PA
    t0 = time.perf_counter()
    path = PA.build()
    secs = time.perf_counter() - t0
    logf = path.with_suffix(".log")
    pa_log = logf.read_text() if logf.exists() else PA.build_log
    spills = [int(v) for v in re.findall(r"(\d+) bytes spill", pa_log)]
    log(f"[2 build] {secs:.2f} s -> {path.name}; "
        + "; ".join(f"{name}: {i['registers']} registers, "
                    f"{i['local_bytes']} local bytes, {i['blocks_per_sm']} "
                    f"blocks of {i['threads']} per SM"
                    for name, i in PA.build_info().items()))
    check(spills and not any(spills), "the PA kernels spill")
    from exaconstit_tpu_torch.fem.ea_apply_cuda import KERNEL as EA
    t0 = time.perf_counter()
    path = EA.build()
    secs = time.perf_counter() - t0
    logf = path.with_suffix(".log")
    ea_log = logf.read_text() if logf.exists() else EA.build_log
    spills = [int(v) for v in re.findall(r"(\d+) bytes spill", ea_log)]
    log(f"[2 build] {secs:.2f} s -> {path.name}; "
        + "; ".join(f"{name}: {i['registers']} registers, "
                    f"{i['local_bytes']} local bytes, {i['blocks_per_sm']} "
                    f"blocks of {i['threads']} per SM"
                    for name, i in EA.build_info().items()))
    check(spills and not any(spills), "the EA kernels spill")
    return info


def phase_stage(model, sizes=STAGE_SIZES, label="3 stage"):
    """Kernel against the plain version at the main path's batch sizes."""
    from exaconstit_tpu_torch.models import evptn_cm as cm
    from exaconstit_tpu_torch.solvers import dogleg_cuda as dc
    results = {}
    for n in sizes:
        d, w, e, q, h, dts, x0, active = stage_inputs(model, n, 0.08,
                                                      seed=3)
        x0_keep = x0.clone()

        def kernel():
            return dc.dogleg_stage(model, x0, h, dts, d, w, e, q, active,
                                   TOL, MAX_ITER)

        def plain():
            return dc.dogleg_stage_reference(model, x0, h, dts, d, w, e, q,
                                             active, TOL, MAX_ITER)

        x_k, ok_k, it_k, _, J_k = kernel()
        x_r, ok_r, it_r, _, J_r = plain()
        torch.cuda.synchronize()
        check(torch.equal(x0, x0_keep), "the stage modified its input")
        differ = (ok_k != ok_r).nonzero().flatten().tolist()
        for lane in differ[:20]:
            log(f"[{label} {n}] ok differs at lane {lane}: kernel "
                f"ok={bool(ok_k[lane])} iters={int(it_k[lane])}, plain "
                f"ok={bool(ok_r[lane])} iters={int(it_r[lane])}")
        check(len(differ) <= 1e-4 * n,
              f"{len(differ)} of {n} converged flags differ")
        both = ok_k & ok_r
        err = float((x_k - x_r)[:, both].abs().max())
        check(err <= 2e-5, f"stage x differs by {err:.3e} > 2e-5 at {n}")
        # the residual at the kernel's x, evaluated in f64
        f64 = [a.double() for a in (x_k, h, dts, d, w, e, q)]
        r = cm.residual_cm(model, f64[0], f64[1], f64[2],
                           cm.vecd_to_mat_cm(f64[3]), f64[4], f64[5], f64[6],
                           None)
        rn = torch.sqrt(torch.sum(r * r, dim=0))[ok_k & active]
        rmax = float(rn.max())
        check(rmax < 1.01 * TOL,
              f"residual {rmax:.3e} at the kernel's converged x >= tol")
        inactive = ~active
        check(torch.equal(x_k[:, inactive], x0[:, inactive]),
              "the kernel touched an inactive lane")
        check(bool(ok_k[inactive].all()) and int(it_k[inactive].max()) == 0,
              "inactive lanes must read converged after 0 iterations")
        ms_k = cuda_time_ms(kernel, reps=7)
        ms_r = cuda_time_ms(plain)
        hist = torch.bincount(it_k[active].long()).cpu().tolist()
        iters_sum = int(it_k.sum())
        ops, nbytes = dc.stage_work(n, iters_sum)
        bound_ms, bound_by = bound(ops, nbytes)
        log(f"[{label} {n}] kernel {ms_k:.3f} ms, plain {ms_r:.3f} ms, "
            f"max|dx| {err:.3e}, max f64 |r| {rmax:.3e} "
            f"({int((rn >= TOL).sum())} lanes in [tol, 1.01 tol)), "
            f"converged {int(ok_k.sum())}/{n}, flags differ {len(differ)}")
        log(f"[{label} {n}] iteration histogram (count per iters "
            f"0..{len(hist) - 1}): {hist}")
        log(f"[{label} {n}] bound {bound_ms:.4f} ms, set by {bound_by} "
            f"({ops:.4e} f32 operations for {iters_sum} iterations, "
            f"{nbytes:.4e} bytes); share of bound {bound_ms / ms_k:.4f}")
        results[n] = dict(ms=ms_k, plain_ms=ms_r, max_abs_err=err,
                          bound_ms=bound_ms, bound_by=bound_by)
    return results


def phase_staggered(model):
    """The f64-polished staggered solve: kernel stage vs plain stage."""
    from exaconstit_tpu_torch.models import evptn_cm as cm
    from exaconstit_tpu_torch.solvers import dogleg_cuda as dc
    n, dt = 262_144, 0.25
    d, w, e, q, h, _, _, _ = stage_inputs(model, n, dt, seed=7)
    args = [a.double() for a in (d, w, e, q, h)]
    nsub = torch.full((n,), 2, dtype=torch.int32, device="cuda")
    check(model.substep_cap > 0 and int(dt / model.substep_cap) == 2,
          "phase 4 must substep")
    with torch.inference_mode():
        out_k = cm.solve_staggered_cm_core(model, dt, *args, None, nsub)
        stage = dc.dogleg_stage
        dc.dogleg_stage = dc.dogleg_stage_reference
        try:
            out_r = cm.solve_staggered_cm_core(model, dt, *args, None, nsub)
        finally:
            dc.dogleg_stage = stage
    torch.cuda.synchronize()
    check(bool(out_k[4].all()) and bool(out_r[4].all()),
          "staggered solve did not converge everywhere")
    dx = float((out_k[0] - out_r[0]).abs().max())
    dh = float(((out_k[1] - out_r[1]) / out_r[1]).abs().max())
    check(dx <= 5e-9, f"polished x differs by {dx:.3e} > 5e-9")
    check(dh <= 1e-8, f"hardness differs by rel {dh:.3e} > 1e-8")
    log(f"[4 staggered {n}, nsub 2] max|dx| {dx:.3e}, max rel dh {dh:.3e}")
    # the same solve in pure f64 (the plain trust region to solver_tol,
    # as the MTSDD models run it) beside the mixed one, per call
    pure = dataclasses.replace(model, mixed_precision=False)
    got = {}

    def run_pure():
        got["out"] = cm.solve_staggered_cm_core(pure, dt, *args, None, nsub)

    with torch.inference_mode():
        ms_mixed = cuda_time_ms(lambda: cm.solve_staggered_cm_core(
            model, dt, *args, None, nsub))
        ms_pure = cuda_time_ms(run_pure, reps=1)
    out_p = got["out"]
    dxp = float((out_p[0] - out_k[0]).abs().max())
    check(bool(out_p[4].all()) and dxp <= 5e-9,
          f"pure-f64 x differs from the mixed solve's by {dxp:.3e} > 5e-9")
    log(f"[4 staggered {n}, nsub 2] per call: mixed (kernel + f64 polish) "
        f"{ms_mixed:.1f} ms, pure f64 (plain trust region, "
        f"{int(out_p[3].max())} iterations on the slowest lane) "
        f"{ms_pure:.1f} ms, max|dx| between them {dxp:.3e}")


def write_case(ncuts, dts, workdir, family="voce", **options):
    """Write the in-repo case of ``family`` ("voce", "mtsdd" or "umat")
    into ``workdir``/case; returns the options file's path."""
    from exaconstit_tpu_torch import cases
    path = os.path.join(workdir, "case")
    if family == "umat":
        return cases.write_umat_case(path, ncuts, dts, **options)
    write = {"voce": cases.write_voce_case,
             "mtsdd": cases.write_mtsdd_case}[family]
    return write(path, ncuts, dts, ngrains=500, seed=0, **options)


def run_case(ncuts, dts, device, workdir, family="voce", shards=None,
             **options):
    """Write the in-repo case of ``family`` and run it through
    ``run_simulation`` (over ``shards`` slab shards if given); returns
    (sim, average stress rows)."""
    from exaconstit_tpu_torch.driver import run_simulation
    toml = write_case(ncuts, dts, workdir, family, **options)
    run_dir = os.path.join(workdir, f"run_{device}")
    os.makedirs(run_dir)
    sim = run_simulation(toml, workdir=run_dir, verbose=False,
                         device=device, shards=shards)
    stress = np.loadtxt(os.path.join(run_dir, "avg_stress.txt"), ndmin=2)
    return sim, stress


class LaunchRecorder:
    """Wraps ``KERNEL.run`` for one run: per launch, a CUDA event pair
    around the kernel call and its lanes' largest and summed iteration
    counts, all kept on the device until ``read`` (no host
    synchronisation)."""

    def __init__(self, kernel):
        self.kernel = kernel
        self.events, self.it_max, self.it_sum, self.points = [], [], [], []
        self.max_iter = None

    def __enter__(self):
        inner = self.kernel.run

        def run(params, inputs, outputs, counter):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            inner(params, inputs, outputs, counter)
            t1.record()
            iters = outputs[3]
            self.events.append((t0, t1))
            self.it_max.append(iters.max())
            self.it_sum.append(iters.sum())
            self.points.append(iters.numel())
            self.max_iter = int(params[-1:].view(np.int32)[0])

        self.kernel.run = run
        return self

    def __exit__(self, *exc):
        del self.kernel.run  # back to the class's method

    def read(self):
        """(ms per launch, largest iters per launch, summed iters per
        launch) as numpy arrays, after one synchronisation."""
        torch.cuda.synchronize()
        if not self.events:
            return np.zeros(0), np.zeros(0, int), np.zeros(0, int)
        ms = np.array([a.elapsed_time(b) for a, b in self.events])
        return (ms, torch.stack(self.it_max).cpu().numpy(),
                torch.stack(self.it_sum).cpu().numpy())


def region_split(label, sim, wall):
    """Log the run's region timings: seconds, calls, ms per call, share
    of the wall."""
    regions = sim.system.regions
    check(regions is not None and set(REGIONS) <= set(regions.totals),
          f"{label}: region timings missing: "
          f"{None if regions is None else dict(regions.counts)}")
    split = {n: (regions.totals[n], regions.counts[n]) for n in REGIONS}
    log(f"[{label}] regions: " + "; ".join(
        f"{n} {t:.2f} s in {c} ({1e3 * t / c:.1f} ms each, "
        f"{t / wall:.1%} of the wall)" for n, (t, c) in split.items())
        + f"; other {wall - sum(t for t, _ in split.values()):.2f} s")


def phase_main(workdir):
    from exaconstit_tpu_torch.fem import ea_apply_cuda
    from exaconstit_tpu_torch.solvers import dogleg_cuda as dc
    KERNEL = dc.KERNEL
    torch.cuda.reset_peak_memory_stats()
    with LaunchRecorder(KERNEL) as rec, env(EXACONSTIT_TPU_REGIONS="1"):
        KERNEL.launches = 0
        ea_apply_cuda.KERNEL.launches = 0
        t0 = time.perf_counter()
        sim, stress = run_case((32, 32, 32), MAIN_DTS, "cuda", workdir)
        wall = time.perf_counter() - t0
        launches = KERNEL.launches
        ea_launches = ea_apply_cuda.KERNEL.launches
    peak = torch.cuda.max_memory_allocated()
    ms, it_max, it_sum = rec.read()
    check(len(ms) == launches, f"{len(ms)} recorded launches != {launches}")
    check(stress.shape == (len(MAIN_DTS), 6), f"stress rows {stress.shape}")
    check(np.isfinite(stress).all(), "average stress is not finite")
    check(launches > 0, "the main path never launched the dogleg kernel")
    check(ea_launches > 0, "the main path never launched the EA apply's "
          "kernels")
    for k, (st, secs) in enumerate(zip(sim.step_stats, sim.step_times)):
        kr = st["krylov_iters"]
        retry = (f"first solve failed after NR {st['first_nr']}, "
                 f"{st['subdivided']} sub-solves, the last: "
                 if st["subdivided"] > 1 else "")
        log(f"[5 main 32^3] step {k + 1} dt {MAIN_DTS[k]}: {secs:.2f} s, "
            f"{retry}NR {st['nr_iters']}, Krylov/NR {kr} "
            f"(mean {np.mean(kr) if kr else 0:.1f}), "
            f"szz {stress[k, 2]:.6g}")
    # z strain rate 1e-3 / s on a unit cube
    slopes = np.diff(np.concatenate([[0.0], stress[:, 2]])) / (
        np.asarray(MAIN_DTS) * 1e-3)
    check(slopes[-1] < 0.5 * slopes[0],
          f"no plastic flow: dszz/deps {slopes[0]:.4g} -> {slopes[-1]:.4g}")
    log(f"[5 main 32^3] {sim.system.npts} points, precond "
        f"{sim.system.precond_kind}, wall {wall:.2f} s, dszz/deps "
        f"{slopes.round(3).tolist()} GPa, kernel launches {launches}, EA "
        f"apply launches {ea_launches} (V-cycle captures included), peak "
        f"memory {peak / 2**30:.3f} GiB")
    region_split("5 main 32^3", sim, wall)
    ops, nbytes = zip(*(dc.stage_work(n, int(s))
                        for n, s in zip(rec.points, it_sum)))
    path_bound, path_by = bound(sum(ops), sum(nbytes))
    tail = it_max >= rec.max_iter
    hit = int(tail.sum())
    log(f"[5 main 32^3] kernel device ms per launch: median "
        f"{float(np.median(ms)):.4f}, max {float(ms.max()):.4f}, total "
        f"{float(ms.sum()):.2f}; launches with a lane at max_iter "
        f"{rec.max_iter}: {hit} of {launches}; mean iterations per point "
        f"{float(it_sum.sum()) / sum(rec.points):.3f}; path bound "
        f"{path_bound:.2f} ms ({path_by}), share {path_bound / ms.sum():.4f}")
    slow = int(ms.argmax())

    def median(a):
        return float(np.median(a)) if a.size else float("nan")

    log(f"[5 main 32^3] slowest launch: {float(ms[slow]):.4f} ms, largest "
        f"iterations {int(it_max[slow])}, mean "
        f"{it_sum[slow] / rec.points[slow]:.3f}; median ms of launches "
        f"with / without a lane at max_iter: {median(ms[tail]):.4f} / "
        f"{median(ms[~tail]):.4f}")
    return dict(launches=launches, ea_launches=ea_launches,
                median_ms=float(np.median(ms)),
                max_ms=float(ms.max()), szz=stress[:, 2],
                subdivided=[st["subdivided"] for st in sim.step_stats])


def phase_cpu_vs_cuda(workdir, family="voce", label="6", name=None,
                      tol=1e-6, nsteps=2, **options):
    name = name or family
    tag = name.replace(" ", "_")
    secs = {}
    out = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        _, out[dev] = run_case((4, 4, 4), MAIN_DTS[:nsteps], dev,
                               os.path.join(workdir, f"{tag}_{dev}"),
                               family, **options)
        secs[dev] = time.perf_counter() - t0
    s_gpu, s_cpu = out["cuda"], out["cpu"]
    rel = float(np.max(np.abs(s_gpu - s_cpu)) / np.max(np.abs(s_cpu)))
    check(np.isfinite(s_gpu).all() and rel <= tol,
          f"{name}: CUDA and CPU average stress differ by rel {rel:.3e} "
          f"> {tol:g}")
    log(f"[{label} {name} cuda vs cpu 4^3, {nsteps} step(s)] max rel diff "
        f"{rel:.3e} (bound {tol:g}; {secs['cuda']:.1f} s on the card, "
        f"{secs['cpu']:.1f} s on the CPU)")


class PointSolveRecorder:
    """Wraps ``evptn_cm.dogleg_cm`` (the plain trust-region solve) and
    ``Simulation.advance`` for one run: host seconds in the solves, with
    a synchronisation either side, their count and the iterations of
    their slowest lanes, summed per time step.  Every solve must run in
    ``dtype``."""

    def __init__(self, dtype=torch.float64):
        self.dtype = dtype
        self.steps = []
        self.cur = dict(seconds=0.0, calls=0, iterations=0, max_iters=0)

    def __enter__(self):
        from exaconstit_tpu_torch import driver
        from exaconstit_tpu_torch.models import evptn_cm as cm
        self.cm, self.sim_cls = cm, driver.Simulation
        self.dogleg, self.advance = cm.dogleg_cm, driver.Simulation.advance
        rec = self

        def dogleg_cm(resjac_fn, x0, tol, max_iter, active0=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = rec.dogleg(resjac_fn, x0, tol, max_iter, active0=active0)
            worst = int(out[2].max())  # reads the device: synchronises
            c = rec.cur
            c["seconds"] += time.perf_counter() - t0
            c["calls"] += 1
            c["iterations"] += worst
            c["max_iters"] = max(c["max_iters"], worst)
            check(x0.dtype == rec.dtype, f"a plain point solve ran in "
                  f"{x0.dtype}, not {rec.dtype}")
            return out

        def advance(sim, ti, dt, verbose=True):
            out = rec.advance(sim, ti, dt, verbose)
            rec.steps.append(rec.cur)
            rec.cur = dict(seconds=0.0, calls=0, iterations=0, max_iters=0)
            return out

        cm.dogleg_cm = dogleg_cm
        driver.Simulation.advance = advance
        return self

    def __exit__(self, *exc):
        self.cm.dogleg_cm = self.dogleg
        self.sim_cls.advance = self.advance


def phase_mtsdd(workdir, dts=MTSDD_DTS, label="7 mtsdd 32^3"):
    """The copper FCC MTSDD case at full width through run_simulation."""
    from exaconstit_tpu_torch.solvers import dogleg_cuda as dc
    nsteps = len(dts)
    torch.cuda.reset_peak_memory_stats()
    dc.KERNEL.launches = 0
    with PointSolveRecorder() as rec:
        t0 = time.perf_counter()
        sim, stress = run_case((32, 32, 32), dts, "cuda", workdir, "mtsdd",
                               additional_avgs=True, paraview=True,
                               vis_steps=nsteps, checkpoint_steps=nsteps)
        wall = time.perf_counter() - t0
    launches = dc.KERNEL.launches
    peak = torch.cuda.max_memory_allocated()
    check(not sim.model.evptn.mixed_precision and not sim.system.ea_asm_f32,
          "the MTSDD path must be pure f64")
    check(launches == 0, f"the MTSDD path launched the f32 kernel "
          f"{launches} times")
    check(stress.shape == (nsteps, 6) and np.isfinite(stress).all(),
          f"MTSDD average stress rows {stress.shape} or not finite")
    check(len(rec.steps) == nsteps and all(s["calls"] for s in rec.steps),
          "a step ran no f64 point solve")
    for k, (st, secs, ps) in enumerate(zip(sim.step_stats, sim.step_times,
                                           rec.steps)):
        kr = st["krylov_iters"]
        log(f"[{label}] step {k + 1} dt {dts[k]}: {secs:.2f} s, first NR "
            f"{st['first_nr']}, {st['subdivided']} sub-solve(s), last NR "
            f"{st['nr_iters']}, Krylov/NR {kr}; f64 point solve "
            f"{ps['seconds']:.2f} s in {ps['calls']} calls, "
            f"{ps['iterations']} iterations in all, slowest call "
            f"{ps['max_iters']}; szz {stress[k, 2]:.6g}")
    run_dir = sim.workdir
    npts, ne = sim.system.npts, sim.system.ne
    shapes = {"avg_pl_work.txt": (nsteps, 1), "avg_def_grad.txt": (nsteps, 9),
              "avg_dp_tensor.txt": (nsteps, 6)}
    for fname, shape in shapes.items():
        rows = np.loadtxt(os.path.join(run_dir, fname), ndmin=2)
        check(rows.reshape(nsteps, -1).shape == shape
              and np.isfinite(rows).all(), f"{fname}: rows {rows.shape}")
    fzz = np.loadtxt(os.path.join(run_dir, "avg_def_grad.txt"), ndmin=2)[:, 8]
    want = 1.0 + 1e-3 * np.cumsum(dts)
    check(np.allclose(fzz, want, rtol=1e-5), f"average F_zz {fzz} != {want}")
    with np.load(os.path.join(run_dir, "checkpoint", "checkpoint.npz")) as ck:
        check(int(ck["ti"]) == nsteps
              and ck["state"].shape == (ne, 8, sim.model.num_state)
              and np.isfinite(ck["state"]).all(), "checkpoint archive")
    vtu = os.path.join(run_dir, "results", "exaconstit",
                       f"step_{nsteps:06d}.vtu")
    check(os.path.getsize(vtu) > 100 * ne
          and os.path.exists(os.path.join(run_dir, "results",
                                          "exaconstit.pvd")),
          "visualization dump")
    ps_total = sum(s["seconds"] for s in rec.steps)
    log(f"[{label}] {npts} points, precond {sim.system.precond_kind}, wall "
        f"{wall:.2f} s for {nsteps} steps, f64 point solve {ps_total:.2f} s "
        f"({ps_total / wall:.1%} of the wall), kernel launches {launches}, "
        f"peak memory {peak / 2**30:.3f} GiB; checkpoint and "
        f"{os.path.getsize(vtu) / 2**20:.1f} MiB VTU written")


class RunRecorder:
    """Wraps ``Simulation.run`` (to capture the run's ``Simulation`` and,
    with ``final``, its end state as the checkpoint holds it, gathered
    while the process group is up) and ``MechSystem.apply_k`` (counted) at
    class level for one run."""

    def __init__(self, final=False):
        self.applies = 0
        self.sim = self.backend = None
        self.keep_final, self.final = final, None

    def __enter__(self):
        from exaconstit_tpu_torch import driver
        self.cls, self.sim_cls = driver.MechSystem, driver.Simulation
        self.saved_apply, self.saved_run = self.cls.apply_k, self.sim_cls.run
        rec = self

        def apply_k(*args, **kw):
            rec.applies += 1
            return rec.saved_apply(*args, **kw)

        def run(sim, *args, **kw):
            rec.sim = sim
            rec.backend = (torch.distributed.get_backend()
                           if torch.distributed.is_initialized() else None)
            out = rec.saved_run(sim, *args, **kw)
            if rec.keep_final:
                rec.final = end_state(sim)
            return out

        self.cls.apply_k = apply_k
        self.sim_cls.run = run
        return self

    def __exit__(self, *exc):
        self.cls.apply_k = self.saved_apply
        self.sim_cls.run = self.saved_run


def end_state(sim):
    """A run's end state in the host's global shapes, as its checkpoint
    holds it, without the point solve's iteration counts (state slot 3,
    which follow the batch)."""
    sysm = sim.system
    state = sysm.from_state(sim.state).copy()
    state[:, :, 3] = 0.0
    return dict(x_beg=sysm.from_node(sim.x_beg), v=sysm.from_node(sim.v),
                stress=sysm.from_stress(sim.stress), state=state)


def run_cli(toml, run_dir, *args, final=False):
    """The CLI entry point on ``toml`` from ``run_dir`` on the card,
    recorded; returns (recorder, wall seconds)."""
    from exaconstit_tpu_torch import cli
    os.makedirs(run_dir, exist_ok=True)
    cwd = os.getcwd()
    with RunRecorder(final) as rec:
        os.chdir(run_dir)
        try:
            t0 = time.perf_counter()
            check(cli.main(["-opt", toml, "-q", *args]) == 0,
                  f"the CLI failed on {toml}")
            wall = time.perf_counter() - t0
        finally:
            os.chdir(cwd)
    return rec, wall


def card_simulation(toml):
    """The case's ``Simulation`` on the card (the caller holds
    ``inference_mode``)."""
    from exaconstit_tpu_torch import set_precision_policy
    from exaconstit_tpu_torch.config.options import parse_options
    from exaconstit_tpu_torch.driver import Simulation
    set_precision_policy()
    return Simulation(parse_options(toml), workdir=os.path.dirname(toml),
                      device="cuda")


def newton_start(sim, dt):
    """(v, x_beg, state, dt, ess) as ``Simulation.advance`` hands them to
    the first Newton solve of step 1 at ``dt``: the BCs applied and the
    BC corrector run, from rest."""
    sysm = sim.system
    sim.cur_bcs = sim.bc_steps[1]
    sim.v = torch.zeros_like(sim.x_ref)
    v_prev = sim.v
    sim.update_velocity()
    ess = sysm.to_ess(sim.cur_bcs.ess_mask)
    sim.v = sysm.solve_init(v_prev, sim.v, sim.x_beg, sim.state, dt, ess)
    sim.update_velocity()
    return sim.v, sim.x_beg, sim.state, dt, ess


def check_setup_bitwise(toml):
    """Two calls of the run's first setup on the card (step 1's SolveInit
    setup) give bitwise-equal residuals, operator data and diagonals."""
    from exaconstit_tpu_torch.fem.space import IndexMap
    with torch.inference_mode():
        sim = card_simulation(toml)
        sysm = sim.system
        check(isinstance(sysm.emap, IndexMap) and sysm.pa
              and sysm.point_major and sysm.precond_kind == "jacobi",
              "the mesh-file PA case must take the index map, PA and "
              "Jacobi")
        sim.cur_bcs = sim.bc_steps[1]
        sim.update_velocity()
        ess = sysm.to_ess(sim.cur_bcs.ess_mask)
        dt = MESH_PA_DTS[0]
        args = (sim.v, sim.x_beg, sim.state, dt, ess, False,
                sysm.compute_nsub(dt), None, False)
        first = sysm.setup(*args)[:3]
        second = sysm.setup(*args)[:3]
    for name, a, b in zip(("residual", "PA tensor", "diagonal"), first,
                          second):
        check(torch.equal(a, b), f"two calls of the first setup give "
              f"different {name}s")
    log(f"[9 mesh PA 32^3] two calls of the first setup: residual, PA "
        f"tensor {tuple(first[1].shape)} and diagonal bitwise equal "
        f"(index map of valence {sysm.emap.valence})")
    with torch.inference_mode():
        x = torch.where(ess, 0.0, sim.v + 1.0)
        pa_ms = {str(dtype)[6:]: pa_apply_kernel(sysm, first[1].to(dtype),
                                                 x.to(dtype))
                 for dtype in (torch.float32, torch.float64)}
    del sim, sysm, first, second
    return pa_ms


def kernel_device_ms(fn, prefix, calls=20, tries=3):
    """Device ms per call of ``fn`` in the kernels whose names start with
    ``prefix`` (one launch a call), from a profiler trace of ``calls``
    calls.  A trace that holds fewer launches of them, or no device time
    (the card's profiler once returned none for a kernel it timed in
    another call), is logged and taken again, at most ``tries`` times in
    all, then fails."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        seen = [e for e in prof.key_averages() if prefix in e.key]
        launches = sum(e.count for e in seen)
        us = sum(e.device_time_total for e in seen)
        if launches == calls and us > 0:
            return us / 1e3 / calls
        log(f"[profiler] {prefix}: {launches} launches of {calls} calls, "
            f"{us:.1f} us traced; tracing again")
    check(False, f"the profiler did not trace {prefix}'s {calls} launches "
          f"in {tries} tries")


def pa_apply_kernel(sysm, k, x):
    """The PA apply's kernel pair (``csrc/pa_apply.cu``) on the mesh-file
    system against its plain version: the largest gap over the largest
    |y| (``PA_TOL``), two calls bitwise equal, the node pass bitwise the
    plain scatter of the kernel's element vectors; the kernels' device
    time per apply (element and node pass, profiler) beside the bytes
    bound, ``apply_k`` per call (CUDA events: with the host's part) and
    the plain version's."""
    from exaconstit_tpu_torch.fem import pa_apply_cuda as pc
    dtype, emap = x.dtype, sysm.emap
    dsh = sysm.dshape_as(dtype)
    tag = f"[9 mesh PA 32^3 {str(dtype)[6:]}]"
    check(sysm.pa_kernel, "the mesh-file PA system must take the kernels")
    before = pc.KERNEL.launches
    y = sysm.apply_k(k, x)
    check(pc.KERNEL.launches == before + 1, "apply_k did not launch the "
          "PA kernels")
    want = pc.pa_apply_reference(k, dsh, x, emap)
    y2, el_y = pc.KERNEL.launch(k, dsh, x, emap.conn_t, emap.table)
    err = float((y - want).abs().max() / want.abs().max())
    check(err <= PA_TOL[dtype], f"{tag} kernel against plain {err:.3e} > "
          f"{PA_TOL[dtype]:.0e} of max |y|")
    check(torch.equal(y, y2), f"{tag} two kernel applies differ")
    check(torch.equal(y, emap.scatter_add(el_y)), f"{tag} the node pass is "
          "not the plain scatter of the element vectors")
    nbytes = (k.numel() * k.element_size() + 2 * x.numel() * x.element_size()
              + (emap.conn_t.numel() + emap.table.numel()) * 8)
    bound_ms = 1e3 * nbytes / BYTES_PER_S
    run = lambda: sysm.apply_k(k, x)  # noqa: E731
    out = dict(kernel_ms=kernel_device_ms(run, "pa_element_kernel"),
               node_ms=kernel_device_ms(run, "pa_node_kernel"),
               apply_ms=cuda_time_ms(run, reps=5), bound_ms=bound_ms,
               plain_ms=cuda_time_ms(
                   lambda: pc.pa_apply_reference(k, dsh, x, emap), reps=5),
               max_rel_err=err)
    dev_ms = out["kernel_ms"] + out["node_ms"]
    log(f"{tag} kernels {dev_ms:.4f} ms (element {out['kernel_ms']:.4f}, "
        f"node {out['node_ms']:.4f}) against the bytes bound "
        f"{bound_ms:.4f} ms ({nbytes:.4e} bytes), share "
        f"{bound_ms / dev_ms:.3f}; apply_k {out['apply_ms']:.4f} ms a call; "
        f"plain {out['plain_ms']:.4f} ms; max gap {err:.3e} of max |y|")
    return out


def phase_ea_apply(grid=(32, 32, 32)):
    """Phase 22: the EA apply's kernel pair against its plain version on
    seeded symmetric positive definite f32 blocks, for an f32 and an f64
    x: ``apply_ea`` launches it once, the largest gap over the largest
    |y| (``EA_TOL``), two calls bitwise equal, the node pass bitwise the
    plain scatter of the element vectors; the times logged."""
    from exaconstit_tpu_torch.fem import ea_apply_cuda as ec
    from exaconstit_tpu_torch.fem import operators as ops
    from exaconstit_tpu_torch.fem.space import StructuredMap
    f64 = torch.float64
    smap = StructuredMap(grid)
    ne = grid[0] * grid[1] * grid[2]
    g = torch.Generator().manual_seed(22)
    b = torch.randn(ne, 24, 24, dtype=f64, generator=g)
    k = (b.transpose(1, 2) @ b + 24 * torch.eye(24, dtype=f64)).permute(
        1, 2, 0).contiguous().to(dtype=torch.float32, device="cuda")
    del b
    x64 = torch.randn(3 * int(np.prod(smap.nodes)), dtype=f64,
                      generator=g).cuda()
    out = {}
    for dtype in (torch.float32, f64):
        x = x64.to(dtype)
        tag = f"[22 EA apply {grid[0]}^3 f32 blocks, {str(dtype)[6:]} x]"
        before = ec.KERNEL.launches
        y = ops.apply_ea(k, smap, x)
        check(ec.KERNEL.launches == before + 1, f"{tag} apply_ea did not "
              "launch the EA kernels")
        want = ops.apply_ea_plain(k, smap, x)
        y2, el_y = ec.KERNEL.launch(k, x, grid)
        err = float((y - want).abs().max() / want.abs().max())
        check(err <= EA_TOL[dtype], f"{tag} kernel against plain {err:.3e} "
              f"> {EA_TOL[dtype]:.0e} of max |y|")
        check(torch.equal(y, y2), f"{tag} two kernel applies differ")
        check(torch.equal(y, smap.scatter_add(el_y)), f"{tag} the node pass "
              "is not the plain scatter of the element vectors")
        nbytes = k.numel() * k.element_size() + 2 * x.numel() \
            * x.element_size()
        bound_ms = 1e3 * nbytes / BYTES_PER_S
        run = lambda: ops.apply_ea(k, smap, x)  # noqa: E731
        r = dict(kernel_ms=kernel_device_ms(run, "ea_element_kernel"),
                 node_ms=kernel_device_ms(run, "ea_node_kernel"),
                 apply_ms=cuda_time_ms(run, reps=5), bound_ms=bound_ms,
                 plain_ms=cuda_time_ms(
                     lambda: ops.apply_ea_plain(k, smap, x), reps=5),
                 max_rel_err=err)
        dev_ms = r["kernel_ms"] + r["node_ms"]
        log(f"{tag} kernels {dev_ms:.4f} ms (element {r['kernel_ms']:.4f}, "
            f"node {r['node_ms']:.4f}) against the bytes bound "
            f"{bound_ms:.4f} ms ({nbytes:.4e} bytes), share "
            f"{bound_ms / dev_ms if dev_ms else 0:.3f}; apply_ea "
            f"{r['apply_ms']:.4f} ms a call; plain {r['plain_ms']:.4f} ms; "
            f"max gap {err:.3e} of max |y|")
        out[str(dtype)[6:]] = r
    return out


def phase_mesh_pa(workdir):
    """The Voce case from an MFEM mesh file with PA assembly and Jacobi-
    PCG at full width, through the CLI entry point on the card."""
    from exaconstit_tpu_torch.fem import pa_apply_cuda as pc
    from exaconstit_tpu_torch.solvers import dogleg_cuda as dc
    toml = write_case((32, 32, 32), MESH_PA_DTS, workdir, "voce",
                      mesh_file=True, assembly="PA")
    pa_ms = check_setup_bitwise(toml)
    run_dir = os.path.join(workdir, "run_cuda")
    torch.cuda.reset_peak_memory_stats()
    with env(EXACONSTIT_TPU_REGIONS="1"):
        dc.KERNEL.launches = 0
        pa_before = pc.KERNEL.launches
        rec, wall = run_cli(toml, run_dir)
        launches = dc.KERNEL.launches
        pa_launches = pc.KERNEL.launches - pa_before
    peak = torch.cuda.max_memory_allocated()
    sim = rec.sim
    stress = np.loadtxt(os.path.join(run_dir, "avg_stress.txt"), ndmin=2)
    nsteps = len(MESH_PA_DTS)
    check(stress.shape == (nsteps, 6) and np.isfinite(stress).all(),
          f"mesh PA average stress rows {stress.shape} or not finite")
    check(len(sim.step_stats) == nsteps, "a step of the mesh PA path did "
          "not finish")
    check(launches > 0, "the mesh PA path never launched the dogleg kernel")
    check(pa_launches == rec.applies, f"{pa_launches} PA kernel applies for "
          f"{rec.applies} PA applies")
    for k, (st, secs) in enumerate(zip(sim.step_stats, sim.step_times)):
        kr = st["krylov_iters"]
        retry = (f"first solve failed after NR {st['first_nr']}, "
                 f"{st['subdivided']} sub-solves, the last: "
                 if st["subdivided"] > 1 else "")
        log(f"[9 mesh PA 32^3] step {k + 1} dt {MESH_PA_DTS[k]}: "
            f"{secs:.2f} s, {retry}NR {st['nr_iters']}, Krylov/NR {kr} "
            f"(mean {np.mean(kr) if kr else 0:.1f}), szz {stress[k, 2]:.6g}")
    log(f"[9 mesh PA 32^3] {sim.system.npts} points, precond "
        f"{sim.system.precond_kind}, wall {wall:.2f} s for {nsteps} steps; "
        f"{rec.applies} PA applies, each a PA kernel apply; dogleg kernel "
        f"launches {launches}, peak memory {peak / 2**30:.3f} GiB")
    region_split("9 mesh PA 32^3", sim, wall)
    return dict(launches=launches, wall=wall, pa_ms=pa_ms,
                pa_launches=pa_launches)


def pcg_floor(toml, label, dt):
    """f32 PCG at the first setup of step 1 (after the BC corrector, as
    the first Newton solve sees it) at each of ``F32_PCG_TOLS``: the
    iterations, the recurrence's reduction and the true residual
    |b - K x| / |b| it leaves."""
    with torch.inference_mode():
        sim = card_simulation(toml)
        sysm = sim.system
        check(sysm.dtype == torch.float32, f"{label}: not an f32 system")
        v, x, state, _, ess = newton_start(sim, dt)
        xw = torch.zeros((8, sysm.npts), dtype=sysm.dtype, device="cuda")
        r, k, diag = sysm.setup(v, x, state, dt, ess, True,
                                sysm.compute_nsub(dt), xw, False)[:3]
        rows = []
        tol0 = sysm.opt.krylov_rel_tol
        for tol in F32_PCG_TOLS:
            sysm.opt.krylov_rel_tol = tol
            x, it, conv, red = sysm.krylov_solve(k, diag, r, ess)
            true = float(torch.linalg.vector_norm(
                r - sysm.grad_matvec(k, x, ess))
                / torch.linalg.vector_norm(r))
            rows.append(f"tol {tol:g}: {it} iterations, recurrence {red:.3e}, "
                        f"true {true:.3e}{'' if conv else ' (not converged)'}")
        sysm.opt.krylov_rel_tol = tol0
    log(f"[11 f32 {label}] f32 PCG ({sysm.precond_kind}) at the first "
        f"setup: " + "; ".join(rows) + f"; the case's tolerance {tol0:g}")


def phase_f32(workdir, szz_f64=None, dts=F32_DTS):
    """The 32^3 Voce case in f32 through the CLI on the card; ``szz_f64``
    phase 5's sigma_zz after each of its ``MAIN_DTS`` steps."""
    from exaconstit_tpu_torch.solvers import dogleg_cuda as dc
    pcg_floor(write_case((4, 4, 4), dts, os.path.join(workdir, "4"), "voce",
                         precision="f32"), "4^3", dts[0])
    toml = write_case((32, 32, 32), dts, workdir, "voce", precision="f32")
    pcg_floor(toml, "32^3", dts[0])
    torch.cuda.reset_peak_memory_stats()
    with PointSolveRecorder(torch.float32) as ps, \
            env(EXACONSTIT_TPU_REGIONS="1"):
        dc.KERNEL.launches = 0
        rec, wall = run_cli(toml, os.path.join(workdir, "run_cuda"))
        launches = dc.KERNEL.launches
    peak = torch.cuda.max_memory_allocated()
    sim = rec.sim
    nsteps = len(dts)
    stress = np.loadtxt(os.path.join(sim.workdir, "avg_stress.txt"),
                        ndmin=2)
    check(sim.system.dtype == torch.float32 and sim.state.dtype
          == torch.float32 and not sim.system.ea_asm_f32,
          "the f32 path must run in f32")
    check(launches == 0, f"the f32 path launched the kernel {launches} "
          "times")
    check(stress.shape == (nsteps, 6) and np.isfinite(stress).all(),
          f"f32 average stress rows {stress.shape} or not finite")
    check(len(sim.step_stats) == nsteps and len(ps.steps) == nsteps
          and all(p["calls"] for p in ps.steps), "an f32 step did not "
          "finish or ran no point solve")
    f64_at = {} if szz_f64 is None else dict(zip(
        np.round(np.cumsum(MAIN_DTS), 9), szz_f64))
    for k, (st, secs, p, t) in enumerate(zip(
            sim.step_stats, sim.step_times, ps.steps,
            np.round(np.cumsum(dts), 9))):
        kr = st["krylov_iters"]
        gap = ("" if t not in f64_at else
               f", gap to phase 5's f64 at t = {t:g} "
               f"{abs(stress[k, 2] - f64_at[t]) / abs(f64_at[t]):.3e}")
        log(f"[11 f32 32^3] step {k + 1} dt {dts[k]}: {secs:.2f} s, first "
            f"NR {st['first_nr']}, {st['subdivided']} sub-solve(s), last NR "
            f"{st['nr_iters']}, Krylov/NR {kr}; f32 point solve "
            f"{p['seconds']:.2f} s in {p['calls']} calls, {p['iterations']} "
            f"loop trips in all, slowest call {p['max_iters']}; szz "
            f"{stress[k, 2]:.6g}{gap}")
    ps_total = sum(p["seconds"] for p in ps.steps)
    log(f"[11 f32 32^3] {sim.system.npts} points, precond "
        f"{sim.system.precond_kind}, wall {wall:.2f} s for {nsteps} steps, "
        f"f32 point solve {ps_total:.2f} s ({ps_total / wall:.1%} of the "
        f"wall), kernel launches {launches}, peak memory "
        f"{peak / 2**30:.3f} GiB")
    region_split("11 f32 32^3", sim, wall)
    return dict(launches=launches, wall=wall)


def phase_profile(workdir):
    """A 4^3 CLI run traced by torch.profiler: the Chrome trace holds the
    kernel's launches and the three regions."""
    from exaconstit_tpu_torch.solvers import dogleg_cuda as dc
    # two steps: the first takes no line search at 4^3
    toml = write_case((4, 4, 4), MAIN_DTS[:2], workdir)
    prof = os.path.join(workdir, "profile")
    with env(EXACONSTIT_TPU_PROFILE_DIR=prof, EXACONSTIT_TPU_REGIONS="1"):
        dc.KERNEL.launches = 0
        _, wall = run_cli(toml, os.path.join(workdir, "run"))
        launches = dc.KERNEL.launches
    traces = glob.glob(os.path.join(prof, "trace_*.json"))
    check(len(traces) == 1, f"profiler traces written: {traces}")
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    dogleg = [e for e in kernels if "dogleg_voce" in e.get("name", "")]
    names = {e.get("name") for e in events}
    found = {n: sum(e.get("name") == n for e in events) for n in REGIONS}
    check(dogleg, "the trace holds no dogleg_voce kernel event")
    check(all(found.values()), f"regions missing from the trace: {found}")
    log(f"[12 profile 4^3] {wall:.2f} s traced; trace "
        f"{os.path.getsize(traces[0]) / 2**20:.1f} MiB, {len(events)} "
        f"events, {len(kernels)} kernel events of "
        f"{len({e['name'] for e in kernels})} kernels, {len(dogleg)} "
        f"dogleg_voce events for {launches} "
        f"launches; region events {found}; {len(names)} names")


def phase_guard(workdir):
    """The 4^3 Voce case on the card with and without the layer guards."""
    out, secs = {}, {}
    for flag in ("0", "1"):
        with env(EXACONSTIT_CHECK_NUMERICS=flag):
            t0 = time.perf_counter()
            sim, out[flag] = run_case((4, 4, 4), MAIN_DTS[:2], "cuda",
                                      os.path.join(workdir, flag))
            secs[flag] = time.perf_counter() - t0
            check(sim.system.check_numerics == (flag == "1"),
                  "EXACONSTIT_CHECK_NUMERICS not read")
    rel = float(np.max(np.abs(out["1"] - out["0"])) / np.max(np.abs(
        out["0"])))
    check(rel <= 1e-12, f"the guarded run's averages differ by rel {rel:.3e}")
    log(f"[13 guard 4^3] EXACONSTIT_CHECK_NUMERICS=1 passes; averages "
        f"differ by rel {rel:.3e} from the run without it ({secs['1']:.2f} "
        f"s against {secs['0']:.2f} s)")


def phase_make_step(workdir, newton_iters=2, reps=MAKE_STEP_REPS, dt=0.01):
    """The fixed-Newton step at 32^3 from phase 5's start: one call at
    phase 5's first dt, then the timed calls at ``dt``."""
    from exaconstit_tpu_torch.solvers import dogleg_cuda as dc
    toml = write_case((32, 32, 32), MAIN_DTS, workdir)
    with torch.inference_mode():
        sim = card_simulation(toml)
        sysm = sim.system
        step = sysm.make_step(newton_iters)
        first = step(*newton_start(sim, MAIN_DTS[0]))
        finite = int(torch.isfinite(first[2]).all(dim=0).sum())
        log(f"[14 make_step 32^3] dt {MAIN_DTS[0]} (phase 5's first step): "
            f"final |r| {float(first[4]):.3e}, {finite} of {sysm.npts} "
            f"points with finite stress")
        del first
        args = newton_start(sim, dt)
        out = step(*args)
        torch.cuda.synchronize()
        dc.KERNEL.launches = 0
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = step(*args)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launches = dc.KERNEL.launches / reps
        check(all(bool(torch.isfinite(t).all()) for t in out),
              f"make_step at dt {dt} returned non-finite values")
        szz = float(sysm.vol_avg(out[2].reshape(6, sysm.nq, -1),
                                 sysm.emap.gather(out[1]))[2])
    secs = float(np.median(times))
    evals = (newton_iters + 1) * sysm.npts
    log(f"[14 make_step 32^3] {newton_iters} Newton iterations, dt {dt}: "
        f"median {secs:.3f} s of {reps} calls "
        f"({', '.join(f'{t:.3f}' for t in times)}) after one warm call; "
        f"{launches:g} kernel launches per call; {evals / secs:.4e} point "
        f"evaluations per second ({evals} per call); final |r| "
        f"{float(out[4]):.3e}, szz {szz:.6g}")
    return dict(seconds=secs, launches=launches, evals_per_s=evals / secs)


# phase 21: entry()'s outputs on the card against the CPU (rel, and for
# the f32-built blocks and their diagonal), the dry run's shard count,
# the precision switch's bars (card against CPU, f32 and f64), the
# workflow CLIs' sizes
ENTRY_RTOL, ENTRY_F32_RTOL = 1e-9, 1e-6
DRYRUN_SHARDS = 4
SWITCH_RTOL = {"f32": 1e-4, "f64": 1e-6}
WORKFLOW_POP, WORKFLOW_GENS = 4, 1
# the fits' steps: a third, past yield, so that the experimental curve
# has two slopes and NSGA-III's slope objective a spread to divide by
FIT_DTS = (0.1, 0.2, 0.2)


@contextlib.contextmanager
def launches_counted():
    """The kernel's launch count reset for the body; ``n[0]`` after."""
    from exaconstit_tpu_torch.solvers import dogleg_cuda as dc
    n = [0]
    dc.KERNEL.launches = 0
    try:
        yield n
    finally:
        n[0] = dc.KERNEL.launches


def entry_legs(workdir):
    """Phase 21 (a): ``entry()``'s ``fn(*args)`` on the card against the
    CPU, and ``dryrun_multichip`` over DRYRUN_SHARDS shards on one card."""
    from exaconstit_tpu_torch import entry
    outs = {}
    for dev in ("cuda", "cpu"):
        fn, args = entry.entry(device=dev)
        with torch.inference_mode():
            outs[dev] = [o.cpu() for o in fn(*args)]
    gaps = {}
    for name, a, b in zip(SETUP_NAMES, outs["cuda"], outs["cpu"]):
        check(a.dtype == b.dtype and a.shape == b.shape,
              f"21 entry: {name} {a.dtype} {tuple(a.shape)} on the card, "
              f"{b.dtype} {tuple(b.shape)} on the CPU")
        gaps[name] = float((a - b).abs().max() / b.abs().max())
        bar = ENTRY_F32_RTOL if name in ("EA blocks", "diagonal") \
            else ENTRY_RTOL
        check(gaps[name] <= bar, f"21 entry: {name} card against CPU rel "
              f"{gaps[name]:.3e} (bar {bar:g})")
    log("[21 entry] entry()'s first setup at 2^3, card against CPU, max "
        "rel diff: " + ", ".join(f"{n} {g:.3e}" for n, g in gaps.items()))
    with launches_counted() as n:
        t0 = time.perf_counter()
        out = entry.dryrun_multichip(DRYRUN_SHARDS)
        wall = time.perf_counter() - t0
    check(n[0] > 0, "21 dryrun: the kernel never launched")
    log(f"[21 dryrun] dryrun_multichip({DRYRUN_SHARDS}) on one card: "
        f"replicated make_step(2) on 2x2x{DRYRUN_SHARDS} "
        f"{out['replicated_seconds']:.2f} s, slab Newton on 16x16x8 "
        f"{out['slab_seconds']:.2f} s in {out['slab_newton']} iterations; "
        f"wall {wall:.2f} s, {n[0]} kernel launches")
    return dict(dryrun_launches=n[0], dryrun_seconds=wall)


@contextlib.contextmanager
def plain_ea_apply():
    """``operators.apply_ea`` as its plain form for the body (on the
    strided map too), restored after."""
    from exaconstit_tpu_torch.fem import operators as ops
    saved = ops.apply_ea
    ops.apply_ea = ops.apply_ea_plain
    try:
        yield
    finally:
        ops.apply_ea = saved


def no_struct_leg(workdir):
    """Phase 21 (b): the 32^3 Voce case with and without
    EXACONSTIT_TPU_NO_STRUCT=1 on the card, both with the EA apply's
    plain form (``plain_ea_apply``: on the strided map the kernel pair
    sums in another order than the index map's einsum): the run's first
    setup and Krylov solve (the BC corrector), then step 1's first setup
    and Krylov solve, bitwise equal, GMG in both; one scatter-add timed
    for each map."""
    from exaconstit_tpu_torch.fem.space import IndexMap, StructuredMap
    toml = write_case((32, 32, 32), MAIN_DTS[:1], workdir)
    outs, ms = {}, {}
    for flag, kind in (("0", StructuredMap), ("1", IndexMap)):
        with env(EXACONSTIT_TPU_NO_STRUCT=flag), torch.inference_mode(), \
                plain_ea_apply():
            sim = card_simulation(toml)
            sysm = sim.system
            check(isinstance(sysm.emap, kind) and sysm.precond_kind == "gmg",
                  f"21 no struct {flag}: {type(sysm.emap).__name__}, "
                  f"precond {sysm.precond_kind}")
            v, x_beg, state, dt, ess = newton_start(sim, MAIN_DTS[0])
            xw = torch.zeros((8, sysm.npts), dtype=sysm.dtype, device="cuda")
            r, k, d, stress, st, xs = sysm.setup(
                v, x_beg, state, dt, ess, True, sysm.compute_nsub(dt), xw,
                False)
            dv = sysm.krylov_solve(k, d, r, ess)[0]
            outs[flag] = (v, r, k, d, stress, st, xs, dv)
            el = sysm.emap.gather(x_beg)
            ms[flag] = cuda_time_ms(lambda: sysm.emap.scatter_add(el), 20)
            del sim, sysm
    names = ("corrector velocity", "residual", "EA blocks", "diagonal",
             "stress", "end state", "point solution", "Krylov update")
    for name, a, b in zip(names, outs["0"], outs["1"]):
        check(torch.equal(a, b), f"21 no struct: the {name} differs "
              f"between the strided and the index map")
    log(f"[21 no struct 32^3] EXACONSTIT_TPU_NO_STRUCT=1: IndexMap, GMG; "
        f"the corrector and step 1's first setup and Krylov solve bitwise "
        f"equal to the strided map's, both with the plain EA apply; one "
        f"scatter-add {ms['0']:.4f} ms "
        f"strided, {ms['1']:.4f} ms indexed")
    return ms


def precision_legs(workdir):
    """Phase 21 (c): EXACONSTIT_TPU_PRECISION through the CLI at 4^3 on
    the f32 case file and a copy that says ``precision = "f64"``."""
    f32 = write_case((4, 4, 4), MAIN_DTS[:2], workdir, precision="f32")
    with open(f32) as f:
        text = f.read()
    check(text.count('precision = "f32"') == 1, "21 precision: case file")
    f64 = os.path.join(os.path.dirname(f32), "voce_f64.toml")
    with open(f64, "w") as f:
        f.write(text.replace('precision = "f32"', 'precision = "f64"'))

    def run(name, toml, device, value=None):
        run_dir = os.path.join(workdir, name)
        variables = {} if value is None else dict(
            EXACONSTIT_TPU_PRECISION=value)
        with env(**variables), launches_counted() as n:
            rec, wall = run_cli(toml, run_dir, "--device", device)
        with open(os.path.join(run_dir, "avg_stress.txt")) as f:
            out = f.read()
        sim = rec.sim
        dtypes = {sim.system.dtype, sim.v.dtype, sim.state.dtype}
        return dict(text=out, stress=np.loadtxt(out.splitlines(), ndmin=2),
                    launches=n[0], dtypes=dtypes, wall=wall)

    got = {"f32": run("f32", f32, "cuda"), "f64": run("f64", f64, "cuda")}
    for want, toml, value in (("f32", f64, "f32"), ("f64", f32, "f64")):
        card = run(f"{value} on card", toml, "cuda", value)
        cpu = run(f"{value} on cpu", toml, "cpu", value)
        dtype = torch.float32 if want == "f32" else torch.float64
        rel = float(np.max(np.abs(card["stress"] - cpu["stress"]))
                    / np.max(np.abs(cpu["stress"])))
        check(card["dtypes"] == cpu["dtypes"] == {dtype},
              f"21 precision {value}: run types {card['dtypes']}")
        check(card["text"] == got[want]["text"],
              f"21 precision {value}: not bitwise the {want} file's run")
        check((card["launches"] == 0) == (want == "f32")
              and got[want]["launches"] == card["launches"],
              f"21 precision {value}: {card['launches']} launches")
        check(rel <= SWITCH_RTOL[want], f"21 precision {value}: card "
              f"against CPU rel {rel:.3e}")
        log(f"[21 precision 4^3] EXACONSTIT_TPU_PRECISION={value} on the "
            f"{'f64' if want == 'f32' else 'f32'} file: {dtype}, "
            f"{card['launches']} kernel launches, bitwise the {want} "
            f"file's run; card against CPU rel {rel:.3e} (bar "
            f"{SWITCH_RTOL[want]:g}); {card['wall']:.1f} s on the card")


def moo_worst(out):
    """The largest objective in fit_params_moo's checkpoint and front."""
    import pickle
    with open(os.path.join(out, "ga_checkpoint.pkl"), "rb") as f:
        worst = float(np.max(pickle.load(f)["F"]))
    return max(worst, float(np.max(np.loadtxt(
        os.path.join(out, "pareto_f.txt")))))


def workflow_legs(workdir):
    """Phase 21 (d): the three workflow CLIs at 4^3 on the card."""
    import io
    from exaconstit_tpu_torch import workflows
    from exaconstit_tpu_torch.workflows.optimization import fit_params
    from exaconstit_tpu_torch.workflows.optimization import fit_params_moo
    from exaconstit_tpu_torch.workflows.uq_sweep import loading_sweep
    toml = write_case((4, 4, 4), MAIN_DTS[:2], workdir)

    def cli(main, argv):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            main(argv)
        return buf.getvalue(), time.perf_counter() - t0

    # the loading sweep, card against CPU (what phase 15 held)
    states, secs = {}, {}
    with launches_counted() as n:
        for dev in ("cuda", "cpu"):
            out_dir = os.path.join(workdir, f"sweep_{dev}")
            text, secs[dev] = cli(loading_sweep.main, [
                "--toml", toml, "--n_axial", "1", "--workdir", out_dir,
                "--device", dev])
            check("fitted quadratic yield surface written" in text and
                  os.path.exists(os.path.join(out_dir,
                                              "yield_surface_M.txt")),
                  f"21 loading sweep on {dev}: {text[-500:]}")
            with open(os.path.join(out_dir, "flow_states.json")) as f:
                states[dev] = np.array(json.load(f))
    rel = float(np.max(np.abs(states["cuda"] - states["cpu"]))
                / np.max(np.abs(states["cpu"])))
    check(states["cuda"].shape == (4, 6) and rel <= 1e-6,
          f"21 loading sweep: card against CPU rel {rel:.3e}")
    log(f"[21 loading sweep 4^3] --n_axial 1, 4 loads: flow states card "
        f"against CPU rel {rel:.3e} (bar 1e-6); {secs['cuda']:.1f} s on "
        f"the card ({n[0]} kernel launches), {secs['cpu']:.1f} s on the CPU")
    # the experimental curve: a seeded port run with props[10] (the Voce
    # g0) moved from 0.017 to 0.02
    toml = write_case((4, 4, 4), FIT_DTS, os.path.join(workdir, "fit_case"))
    t, szz = workflows.run_candidate(toml, {10: 0.02},
                                     os.path.join(workdir, "experiment"))
    np.savetxt(os.path.join(workdir, "exp.csv"), np.stack([t, szz], 1),
               delimiter=",")
    np.savetxt(os.path.join(workdir, "exp.txt"),
               np.stack([t * 1e-3, szz], 1))
    common = ["--toml", toml, "--params", "10:0.01,0.03", "--pop",
              str(WORKFLOW_POP), "--gens", str(WORKFLOW_GENS)]
    # differential evolution, then its resume
    fit_dir = os.path.join(workdir, "fit")
    ck = os.path.join(fit_dir, "ga_state.json")
    argv = common + ["--exp", os.path.join(workdir, "exp.csv"),
                     "--workdir", fit_dir, "--checkpoint", ck]
    with launches_counted() as n:
        text, secs_de = cli(fit_params.main, argv)
    with open(ck) as f:
        state = json.load(f)
    ran = sorted(os.listdir(fit_dir))
    check(state["gen"] == WORKFLOW_GENS - 1 and max(state["fit"]) < 1e9
          and len(ran) == 2 * WORKFLOW_POP + 1 and n[0] > 0,
          f"21 fit_params: {state}, {ran}, {n[0]} launches")
    again, _ = cli(fit_params.main, argv)
    check(f"resuming from generation {WORKFLOW_GENS}" in again
          and "gen 0:" not in again and sorted(os.listdir(fit_dir)) == ran,
          f"21 fit_params resume: {again[-500:]}")
    log(f"[21 fit_params 4^3] --pop {WORKFLOW_POP} --gens {WORKFLOW_GENS}: "
        f"{len(ran) - 1} candidates in {secs_de:.1f} s ({n[0]} kernel "
        f"launches), best misfit {min(state['fit']):.4e}; resumed from "
        f"the checkpoint with no candidate run")
    # NSGA-III, then its restart
    out = os.path.join(workdir, "moo")
    argv = common + ["--exp", os.path.join(workdir, "exp.txt"), "--out",
                     out]
    with launches_counted() as n:
        text, secs_moo = cli(fit_params_moo.main, argv)

    def gens():
        return sorted(p for p in os.listdir(out) if p.startswith("gen_"))

    check(gens() == ["gen_0", "gen_1"] and n[0] > 0 and all(
        os.path.exists(os.path.join(out, f)) for f in (
            "ga_checkpoint.pkl", "pareto_x.txt", "pareto_f.txt")),
        f"21 fit_params_moo: {gens()}, {text[-500:]}")
    # a failed candidate is printed and scored 1e3 (ExaProbMOO): none may
    check("FAILED" not in text and moo_worst(out) < 1e3,
          f"21 fit_params_moo: a candidate failed: {text[-500:]}")
    gen0 = {p: os.stat(os.path.join(out, "gen_0", p)).st_mtime_ns
            for p in os.listdir(os.path.join(out, "gen_0"))}
    again, secs_re = cli(fit_params_moo.main, argv + ["--restart"])
    check("restarting from gen 2" in again
          and gens() == ["gen_0", "gen_1", "gen_2", "gen_3"]
          and gen0 == {p: os.stat(os.path.join(out, "gen_0", p)).st_mtime_ns
                       for p in os.listdir(os.path.join(out, "gen_0"))},
          f"21 fit_params_moo restart: {gens()}, {again[-500:]}")
    check("FAILED" not in again and moo_worst(out) < 1e3,
          f"21 fit_params_moo restart: a candidate failed: {again[-500:]}")
    log(f"[21 fit_params_moo 4^3] --pop {WORKFLOW_POP} --gens "
        f"{WORKFLOW_GENS}: {2 * WORKFLOW_POP} candidates in {secs_moo:.1f} s "
        f"({n[0]} kernel launches); restarted from its checkpoint at "
        f"generation 2 in {secs_re:.1f} s, generation 0 not run again")


def phase_entry(workdir):
    """Phase 21: the port's entry points."""
    t0 = time.perf_counter()
    out = entry_legs(os.path.join(workdir, "a"))
    out["scatter_ms"] = no_struct_leg(os.path.join(workdir, "b"))
    precision_legs(os.path.join(workdir, "c"))
    workflow_legs(os.path.join(workdir, "d"))
    out["seconds"] = time.perf_counter() - t0
    log(f"[21 entry] {out['seconds']:.1f} s for the phase")
    return out


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class ExchangeRecorder:
    """Wraps ``SlabMap.exchange_add`` for one run: the halo exchanges and
    the bytes they move across the shard boundaries."""

    def __enter__(self):
        from exaconstit_tpu_torch.parallel.slab import SlabMap
        self.cls, self.saved = SlabMap, SlabMap.exchange_add
        self.calls, self.nbytes = 0, 0
        rec = self

        def exchange_add(smap, y):
            rec.calls += 1
            rec.nbytes += (smap.layout.n_shards - 1) * smap.halo_bytes(
                y.dtype)
            return rec.saved(smap, y)

        SlabMap.exchange_add = exchange_add
        return self

    def __exit__(self, *exc):
        self.cls.exchange_add = self.saved


def same_structure_szz(toml, run_dir, structure, label="17 slab 32^3",
                       dts=SLAB_DTS, numerics=SLAB_NUMERICS, knobs=None):
    """sigma_zz per step of ``toml`` on one device, step k forced to take
    ``structure[k]`` sub-solves: its whole solve and every coarser retry
    report failure without running.  A forced sub-solve may still fail
    and be retried finer (C7), so the run is tried at each of
    ``numerics`` in turn (the sharded path's own, then phase 5's: GMG,
    the f32 EA build); fails unless one of them took exactly those
    sub-solves.  ``knobs`` set on the case's model runs it instead."""
    from exaconstit_tpu_torch import set_precision_policy
    from exaconstit_tpu_torch.config.options import parse_options
    from exaconstit_tpu_torch.driver import Simulation
    set_precision_policy()
    tried = []
    for name, precond, ea_f32 in numerics:
        wd = os.path.join(run_dir, precond)
        os.makedirs(wd)
        t0 = time.perf_counter()
        with torch.inference_mode():
            opt, model = (parse_options(toml), None) if knobs is None \
                else knob_model(toml, **knobs)
            opt.krylov_precond = precond
            sim = Simulation(opt, workdir=wd, device="cuda", model=model)
            sysm = sim.system
            sysm.ea_asm_f32 = ea_f32
            solve = sysm.newton_solve

            def newton_solve(v, x_beg, state, dt, *args, **kw):
                k = len(sim.step_stats)  # the step being solved
                if dt > dts[k] / structure[k] * (1 + 1e-9):
                    return v, None, None, False, 0, None
                return solve(v, x_beg, state, dt, *args, **kw)

            sysm.newton_solve = newton_solve
            sim.run(verbose=False)
        took = [st["subdivided"] for st in sim.step_stats]
        szz = np.loadtxt(os.path.join(wd, "avg_stress.txt"), ndmin=2)[:, 2]
        log(f"[{label}] one device at {name} numerics "
            f"({sysm.precond_kind}) forced to {list(structure)} sub-solves: "
            f"took {took}, last NR "
            f"{[st['nr_iters'] for st in sim.step_stats]}, szz "
            f"{[f'{z:.6g}' for z in szz]} ({time.perf_counter() - t0:.1f} s)")
        check(sim.parallel_mode == "single",
              f"the one-device reference ran {sim.parallel_mode}")
        if took == list(structure):
            return szz
        tried.append(f"{name} numerics took {took}")
    raise SmokeFailure(f"no one-device run took the sub-solves "
                       f"{list(structure)}: {'; '.join(tried)}")


def szz_gaps(szz, structure, leg_a):
    """Per step (rel gap, name) of a sharded run's sigma_zz to a
    one-device run with the same sub-solves in every step so far: phase
    5's, or ``same_structure_szz`` at ``leg_a``'s label, steps and
    numerics (run once per structure, kept in leg_a)."""
    main, refs, dts = leg_a["main_path"], leg_a["refs"], leg_a["dts"]
    out = []
    for k in range(len(dts)):
        if main is not None and MAIN_DTS[:k + 1] == dts[:k + 1] \
                and list(main["subdivided"][:k + 1]) == structure[:k + 1]:
            want, name = main["szz"][k], "phase 5"
        else:
            key = tuple(structure)
            if key not in refs:
                refs[key] = same_structure_szz(
                    leg_a["toml"], os.path.join(leg_a["workdir"],
                                                f"one_{len(refs)}"), key,
                    leg_a["label"], dts, leg_a["numerics"])
            want, name = refs[key][k], f"one device forced to {list(key)}"
        out.append((abs(szz[k] - want) / abs(want), name))
    return out


def check_szz(label, gaps):
    for k, (rel, name) in enumerate(gaps):
        check(rel <= SLAB_SZZ_RTOL, f"{label}: sigma_zz of step {k + 1} "
              f"differs from {name}'s by rel {rel:.3e} > {SLAB_SZZ_RTOL:g}")


def slab_cli(workdir, main_path=None):
    """Leg (a): the 32^3 Voce case over SLAB_SHARDS slab shards through
    the CLI in an NCCL process group of one rank; ``main_path`` phase 5's
    result, if it ran."""
    from exaconstit_tpu_torch.solvers import dogleg_cuda as dc
    toml = write_case((32, 32, 32), SLAB_DTS, workdir, "voce",
                      parallel_mode="slab", precond="jacobi")
    run_dir = os.path.join(workdir, "run_cuda")
    torch.cuda.reset_peak_memory_stats()
    launch_env = dict(EXACONSTIT_TPU_DIST="1", RANK="0", WORLD_SIZE="1",
                      LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(free_port()))
    with LaunchRecorder(dc.KERNEL) as krec, ExchangeRecorder() as xrec, \
            env(EXACONSTIT_TPU_REGIONS="1", **launch_env):
        dc.KERNEL.launches = 0
        rec, wall = run_cli(toml, run_dir, "--shards", str(SLAB_SHARDS),
                            final=True)
        launches = dc.KERNEL.launches
    peak = torch.cuda.max_memory_allocated()
    ms, _, _ = krec.read()
    sim = rec.sim
    sysm = sim.system
    nsteps = len(SLAB_DTS)
    stress = np.loadtxt(os.path.join(run_dir, "avg_stress.txt"), ndmin=2)
    check(rec.backend == "nccl" and sim.parallel_mode == "slab"
          and sysm.layout.distributed and sysm.layout.n_shards
          == SLAB_SHARDS, f"the slab leg ran as {sim.parallel_mode} on "
          f"backend {rec.backend}")
    check(stress.shape == (nsteps, 6) and np.isfinite(stress).all(),
          f"slab average stress rows {stress.shape} or not finite")
    check(len(sim.step_stats) == nsteps, "a slab step did not finish")
    check(launches > 0 and len(ms) == launches,
          f"the slab path launched the dogleg kernel {launches} times "
          f"({len(ms)} recorded)")
    structure = [st["subdivided"] for st in sim.step_stats]
    leg_a = dict(launches=launches, wall=wall, stress=stress, toml=toml,
                 final=rec.final, structure=structure, workdir=workdir,
                 main_path=main_path, refs={}, dts=SLAB_DTS,
                 label="17 slab 32^3", numerics=SLAB_NUMERICS,
                 median_ms=float(np.median(ms)), max_ms=float(ms.max()),
                 step_times=list(sim.step_times))
    gaps = szz_gaps(stress[:, 2], structure, leg_a)
    for k, (st, secs) in enumerate(zip(sim.step_stats, sim.step_times)):
        kr = st["krylov_iters"]
        rel, name = gaps[k]
        log(f"[17 slab 32^3] step {k + 1} dt {SLAB_DTS[k]}: {secs:.2f} s, "
            f"first NR {st['first_nr']}, {st['subdivided']} sub-solve(s), "
            f"last NR {st['nr_iters']}, Krylov/NR {kr} (mean "
            f"{np.mean(kr) if kr else 0:.1f}); szz {stress[k, 2]:.6g}, gap "
            f"to {name}'s {rel:.3e} (bound {SLAB_SZZ_RTOL:g})")
    check_szz("leg (a)", gaps)
    emap = sysm.emap
    per_f64, per_f32 = (emap.halo_bytes(d) for d in (torch.float64,
                                                     torch.float32))
    boundaries = SLAB_SHARDS - 1
    log(f"[17 slab 32^3] {sysm.npts} points over {SLAB_SHARDS} shards "
        f"(n_loc {sysm.part.n_loc}, m_halo {sysm.part.m_halo}), backend "
        f"{rec.backend}, precond {sysm.precond_kind}, wall {wall:.2f} s "
        f"for {nsteps} steps, peak memory {peak / 2**30:.3f} GiB; kernel "
        f"launches {launches}, device ms per launch median "
        f"{float(np.median(ms)):.4f}, max {float(ms.max()):.4f}")
    log(f"[17 slab 32^3] halo exchange: {xrec.calls} exchanges moving "
        f"{xrec.nbytes / 2**20:.2f} MiB across the {boundaries} shard "
        f"boundaries; per matvec {per_f64} B per boundary in f64 "
        f"({boundaries * per_f64} B in all), {per_f32} B in f32; a "
        f"replicated-node all-reduce would move {3 * sysm.nn * 8} B in f64")
    region_split("17 slab 32^3", sim, wall)
    slab_batch_rounding(sim, SLAB_DTS[-1])
    del rec, sim, sysm
    slab_pieces(toml, {**launch_env, "MASTER_PORT": str(free_port())})
    return leg_a


def slab_batch_rounding(sim, dt):
    """Which layer of a setup rounds differently when a rank holds fewer
    shards (one a rank on four cards, two on two) than the stack of
    SLAB_SHARDS one rank holds: each layer over the whole stack, cut to
    its first shards, against the same layer computed on those shards'
    inputs alone, every layer fed the stack's slice of its inputs (leg
    (a)'s last velocity, coordinates and state).  Logged, not held to a
    bar."""
    from exaconstit_tpu_torch.fem import operators as ops
    from exaconstit_tpu_torch.fem.geometry import (adjugate_3x3_cm,
                                                   det_3x3_cm, grad_calc_cm,
                                                   jacobians_cm)
    sysm = sim.system
    ne, nq = sysm.ne, sysm.nq
    dsh, qw = sysm.dshape, sysm.qwts

    def vgrad(el_x, el_v):
        J = jacobians_cm(el_x, dsh)
        return grad_calc_cm(el_v, dsh, adjugate_3x3_cm(J),
                            det_3x3_cm(J)).reshape(3, 3, -1)

    def setup(L, state):
        return sysm.model.model_setup_cm(
            dt, L, state, compute_tangent=True, nsub=sysm.compute_nsub(dt),
            with_solution=True)[:3]

    with torch.inference_mode():
        el_x = sysm.emap.gather(sim.x_beg + dt * sim.v)
        el_v = sysm.emap.gather(sim.v)
        L = vgrad(el_x, el_v)
        stress, state, c6 = setup(L, sim.state)
        c6_q, s_q = c6.reshape(6, 6, nq, ne), stress.reshape(6, nq, ne)
        k = ops.assemble_ea_gradient_cm(el_x, dsh, qw, c6_q, dt)
        keep = torch.arange(state.shape[0], device=state.device) != 3
        for shards in (1, 2):
            n1 = shards * sysm.part.ne_per

            def pts(a):  # (..., nq * ne) point field -> the first shards'
                lead = a.shape[:-1]
                return a.reshape(*lead, nq, ne)[..., :n1].reshape(
                    *lead, nq * n1).contiguous()

            def els(a):  # (..., ne) element field -> the first shards'
                return a[..., :n1].contiguous()

            diffs = {}

            def compare(name, whole, alone):
                d = float((whole - alone).abs().max())
                diffs[name] = (f"{d:.3e} ({d / float(whole.abs().max()):.1e}"
                               " rel)" if d else "0 (bitwise)")

            compare("velocity gradient", pts(L),
                    vgrad(els(el_x), els(el_v)))
            alone = setup(pts(L), pts(sim.state))
            compare("point-solve stress", pts(stress), alone[0])
            compare("state (no iteration counts)", pts(state)[keep],
                    alone[1][keep])
            compare("tangent", pts(c6), alone[2])
            compare("EA blocks", els(k), ops.assemble_ea_gradient_cm(
                els(el_x), dsh, qw, els(c6_q), dt))
            compare("residual force", els(ops.residual_force_cm(
                el_x, dsh, qw, s_q)), ops.residual_force_cm(
                    els(el_x), dsh, qw, els(s_q)))
            for dtype in (torch.float32, torch.float64):
                u = torch.randn(el_x.shape, dtype=dtype, device=el_x.device,
                                generator=torch.Generator(el_x.device)
                                .manual_seed(0))
                kd = k.to(dtype)
                compare(f"EA apply {str(dtype)[6:]}",
                        els(ops.apply_ea_gradient_cm(kd, u)),
                        ops.apply_ea_gradient_cm(els(kd), els(u)))
            first = first_batch_dependent_op(
                lambda: setup(L, sim.state),
                lambda: setup(pts(L), pts(sim.state)),
                pts(torch.arange(nq * ne, device=L.device)[None])[0],
                nq * ne)
            log(f"[17 slab 32^3] {shards} shard(s) alone against their "
                f"slice of the {SLAB_SHARDS}-shard stack, max abs diff: "
                + "; ".join(f"{n} {d}" for n, d in diffs.items())
                + f"; inside the lagged tangent, {first}")


# ops whose outputs hold whatever the allocator left: never compared
UNINITIALISED = ("empty", "new_empty", "empty_like", "empty_strided")


def first_batch_dependent_op(whole, alone, idx, n_whole, scope=None):
    """The first torch op inside ``scope`` (a module and the name of a
    function in it; by default ``evptn_cm.tangent_cm_core``) whose output
    over the whole batch of ``n_whole`` points or elements (``whole()``),
    cut to ``idx``, differs from its output on those alone (``alone()``):
    the run alone records every op's output under a
    ``TorchFunctionMode``, and the whole run compares each of its ops'
    outputs whose last axis is the batch with the same op's as it goes
    (keeping none of them).  The two runs must take the same ops (no
    loop whose trip count depends on the batch)."""
    from torch.overrides import TorchFunctionMode
    from exaconstit_tpu_torch.models import evptn_cm

    module, fname = scope or (evptn_cm, "tangent_cm_core")
    n_alone = len(idx)

    class Trace(TorchFunctionMode):
        def __init__(self, ref=None):
            super().__init__()
            self.ref, self.outs, self.count, self.first = ref, [], 0, None

        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not isinstance(out, torch.Tensor):
                return out
            i, self.count = self.count, self.count + 1
            name = getattr(func, "__name__", repr(func))
            out_ok = name not in UNINITIALISED  # contents are not results
            if self.ref is None:
                self.outs.append(out)
            elif self.first is None and i < len(self.ref):
                ta = self.ref[i]
                if (out_ok and out.shape[-1] == n_whole
                        and ta.shape == out.shape[:-1] + (n_alone,)):
                    cut = out[..., idx]
                    if not torch.equal(cut, ta):
                        self.first = (i, name, out.dtype, tuple(ta.shape),
                                      float((cut - ta).abs().max()))
            return out

    def traced(run, trace):
        inner, depth = getattr(module, fname), [0]

        def scoped(*args, **kw):  # a call of itself runs inside
            if depth[0]:
                return inner(*args, **kw)
            depth[0] += 1
            try:
                with trace:
                    return inner(*args, **kw)
            finally:
                depth[0] -= 1

        setattr(module, fname, scoped)
        try:
            run()
        finally:
            setattr(module, fname, inner)
        return trace

    b = traced(alone, Trace())
    a = traced(whole, Trace(b.outs))
    if a.first is not None:
        i, name, dtype, shape, d = a.first
        return (f"op {i} of {a.count} ({b.count} alone), {name}, "
                f"{dtype} {shape}, is the first to differ: max abs diff "
                f"{d:.3e}")
    return f"none of {a.count} ops ({b.count} alone) differ"


def slab_pieces(toml, launch_env):
    """The pieces of one slab Krylov iteration timed alone at 32^3, in
    f32 (the inner PCG's type): in an NCCL group of one rank the matvec
    (gather, EA apply, masked scatter, halo exchange), the exchange alone
    and the owner-masked dot (through the group); then the dot of the
    same slab with no group, and the single device's matvec and dot."""
    from exaconstit_tpu_torch.config.options import parse_options
    from exaconstit_tpu_torch.driver import MechSystem, Simulation
    from exaconstit_tpu_torch.parallel import sharding
    from exaconstit_tpu_torch.parallel.slab_system import SlabMechSystem
    f32 = torch.float32
    ms = {}

    def time_system(name, sysm, nodes):
        nen = sysm.fes.ref.nnodes
        k = torch.zeros((3 * nen, 3 * nen, sysm.ne), dtype=f32,
                        device=sysm.device)
        x = torch.ones(3 * nodes, dtype=f32, device=sysm.device)
        if name != "slab, no group":
            ms[f"{name} matvec"] = cuda_time_ms(lambda: sysm.apply_k(k, x),
                                                reps=5)
        ms[f"{name} dot"] = cuda_time_ms(lambda: sysm.dot(x, x), reps=5)

    with env(**launch_env):
        sharding.init_distributed("cuda")
    try:
        with torch.inference_mode():
            sim = Simulation(parse_options(toml), workdir=os.path.dirname(
                toml), device="cuda", shards=SLAB_SHARDS)
            slab = sim.system
            time_system("slab", slab, slab.emap.ntot)
            y = torch.ones((3, slab.emap.ntot), dtype=f32,
                           device=slab.device)
            ms["slab exchange"] = cuda_time_ms(
                lambda: slab.emap.exchange_add(y), reps=5)
    finally:
        sharding.shutdown_distributed()
    with torch.inference_mode():
        alone = SlabMechSystem(sim.opt, sim.mesh, sim.model, SLAB_SHARDS,
                               device="cuda")
        time_system("slab, no group", alone, alone.emap.ntot)
        one = MechSystem(sim.opt, sim.mesh, sim.model, device="cuda",
                         ea_asm_f32=False)
        time_system("one device", one, one.nn)
    log("[17 slab 32^3] one Krylov iteration's pieces alone, f32, ms: "
        + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()))


def slab_against_single(workdir):
    """Leg (b): SlabMechSystem against the single-device MechSystem at the
    slab's numerics (Jacobi, the f64 EA build) on the card."""
    from exaconstit_tpu_torch.config.options import parse_options
    from exaconstit_tpu_torch.driver import Simulation
    toml = write_case(SLAB_CHECK_GRID, SLAB_DTS, workdir, "voce",
                      parallel_mode="slab", precond="jacobi")
    out, secs = {}, {}
    for shards in (None, SLAB_SHARDS):
        run_dir = os.path.join(workdir, f"run_{shards}")
        os.makedirs(run_dir)
        opt = parse_options(toml)
        # both converged tightly: at the case's Newton rel 5e-5 the two
        # partitions' solutions part at that level, not at rounding
        opt.newton_rel_tol, opt.newton_abs_tol = SLAB_CHECK_NR_TOLS
        opt.krylov_rel_tol = SLAB_CHECK_KRYLOV_TOL
        t0 = time.perf_counter()
        with torch.inference_mode():
            sim = Simulation(opt, workdir=run_dir, device="cuda",
                             shards=shards)
            sim.system.ea_asm_f32 = False  # the slab's f64 EA build
            sim.run(verbose=False)
        secs[shards] = time.perf_counter() - t0
        sysm = sim.system
        state = sysm.from_state(sim.state).copy()
        state[:, :, 3] = 0.0  # point-solve iteration counts
        out[shards] = dict(
            avg=np.loadtxt(os.path.join(run_dir, "avg_stress.txt"),
                           ndmin=2),
            stress=sysm.from_stress(sim.stress), state=state,
            v=sysm.from_node(sim.v), mode=sim.parallel_mode)
    one, slab = out[None], out[SLAB_SHARDS]
    check(one["mode"] == "single" and slab["mode"] == "slab",
          f"leg (b) ran {one['mode']} and {slab['mode']}")
    gaps = {}
    for name, rtol, atol in (("avg", 1e-5, 1e-12), ("stress", 1e-6, 1e-9),
                             ("state", 1e-6, 1e-9), ("v", 0.0, 1e-9)):
        a, b = slab[name], one[name]
        excess = float(np.max(np.abs(a - b) - (atol + rtol * np.abs(b))))
        gaps[name] = float(np.max(np.abs(a - b)))
        check(excess <= 0.0, f"slab and single-device {name} differ by "
              f"{gaps[name]:.3e} (rtol {rtol:g}, atol {atol:g})")
    log(f"[17 slab {'x'.join(map(str, SLAB_CHECK_GRID))}] {SLAB_SHARDS} "
        f"shards against one device on the card, {len(SLAB_DTS)} steps: "
        f"max abs diff " + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
        + f" ({secs[SLAB_SHARDS]:.1f} s sharded, {secs[None]:.1f} s single)")


def slab_cpu_vs_cuda(workdir):
    """Leg (c): the slab over 2 shards at 4^3, the card against the CPU."""
    out, secs = {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        sim, out[dev] = run_case((4, 4, 4), SLAB_DTS, dev,
                                 os.path.join(workdir, dev), "voce",
                                 shards=2, parallel_mode="slab",
                                 precond="jacobi")
        secs[dev] = time.perf_counter() - t0
        check(sim.parallel_mode == "slab", f"leg (c) ran "
              f"{sim.parallel_mode} on {dev}")
    rel = float(np.max(np.abs(out["cuda"] - out["cpu"]))
                / np.max(np.abs(out["cpu"])))
    check(np.isfinite(out["cuda"]).all() and rel <= 1e-6,
          f"slab CUDA and CPU average stress differ by rel {rel:.3e}")
    log(f"[17 slab cuda vs cpu 4^3, 2 shards, {len(SLAB_DTS)} step(s)] "
        f"max rel diff "
        f"{rel:.3e} (bound 1e-6; {secs['cuda']:.1f} s on the card, "
        f"{secs['cpu']:.1f} s on the CPU)")


def cli_structure(out, nsteps):
    """The sub-solves of each step, read from a verbose CLI run's output:
    the last retry a step printed, or 1."""
    blocks = re.split(r"^step \d+, dt = ", out, flags=re.M)[1:]
    subs = [re.findall(r"retrying with (\d+) substeps", b) for b in blocks]
    return [int(s[-1]) if s else 1 for s in subs][:nsteps]


def slab_cards(workdir, leg_a):
    """Leg (d): 2 NCCL ranks (and, with four cards, 4), one card each,
    under torchrun, against leg (a)'s single process on the same 4-shard
    partition, on the final checkpoint's arrays at full precision.  Two
    ranks hold 2 shards each and must agree to SLAB_RANKS_TOLS.  Four
    ranks hold one shard each; a rank's batch is then a quarter of the
    points, and on four H100s their Newton path parted from one card's
    (ROADMAP C7, A13c; ``slab_batch_rounding`` logs which layers round
    with the batch): they are held, as leg (a), to a one-device run with
    their own sub-solves at SLAB_SZZ_RTOL."""
    cards = torch.cuda.device_count()
    nsteps = len(SLAB_DTS)
    toml = None
    for ranks, word in ((2, "two"), (4, "four")):
        if cards < ranks:
            log(f"[17 slab] {word}-card NCCL leg not run: {cards} card")
            continue
        if toml is None:  # leg (a)'s case, checkpointed at its last step
            toml = write_case((32, 32, 32), SLAB_DTS, workdir, "voce",
                              parallel_mode="slab", precond="jacobi",
                              checkpoint_steps=nsteps)
        run_dir = os.path.join(workdir, f"run_{ranks}cards")
        os.makedirs(run_dir)
        penv = dict(os.environ, PYTHONPATH=os.path.dirname(
            os.path.abspath(__file__)) + os.pathsep
            + os.environ.get("PYTHONPATH", ""))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(ranks), "--local-ranks-filter", "0",
             "-m", "exaconstit_tpu_torch.cli", "-opt", toml, "--shards",
             str(SLAB_SHARDS)],
            cwd=run_dir, env=penv, capture_output=True, text=True,
            timeout=900)
        secs = time.perf_counter() - t0
        check(proc.returncode == 0, f"the {word}-card run failed:\n"
              + proc.stdout[-3000:] + proc.stderr[-3000:])
        got = np.loadtxt(os.path.join(run_dir, "avg_stress.txt"), ndmin=2)
        check(got.shape == (nsteps, 6) and np.isfinite(got).all(),
              f"{word} cards: average stress {got}")
        with np.load(os.path.join(run_dir, "checkpoint",
                                  "checkpoint.npz")) as ck:
            end = {k: ck[k] for k in leg_a["final"]}
        end["state"][:, :, 3] = 0.0  # iteration counts, as end_state
        rtol, atol = SLAB_RANKS_TOLS
        diffs, excess = {}, {}
        for name, want in leg_a["final"].items():
            a = end[name]
            diffs[name] = ("bitwise" if np.array_equal(a, want) else
                           f"{float(np.max(np.abs(a - want))):.3e}")
            excess[name] = float(np.max(np.abs(a - want)
                                        - (atol + rtol * np.abs(want))))
        structure = cli_structure(proc.stdout, nsteps)
        gaps = szz_gaps(got[:, 2], structure, leg_a)
        steps = [np.loadtxt(os.path.join(run_dir, "timing",
                                         f"time_solve.{r}.txt"), ndmin=1)
                 for r in range(ranks)]
        log(f"[17 slab 32^3] {word} cards, {ranks} NCCL ranks x "
            f"{SLAB_SHARDS // ranks} shard(s): {secs:.1f} s with the "
            f"processes' start, step seconds on rank 0 "
            f"{[round(float(t), 2) for t in steps[0]]} (one card: "
            f"{[round(t, 2) for t in leg_a['step_times']]}); sub-solves "
            f"{structure} (one card: {leg_a['structure']}); end state "
            f"against one card's, max abs diff: "
            + ", ".join(f"{k} {v}" for k, v in diffs.items())
            + "; szz gap per step: " + ", ".join(
                f"{rel:.3e} to {name}'s" for rel, name in gaps))
        if ranks == 2:
            bad = [k for k, e in excess.items() if e > 0.0]
            check(not bad, f"two cards and one card differ in {bad} beyond "
                  f"rtol {rtol:g} / atol {atol:g}: {diffs}")
        check_szz(f"{word} cards", gaps)


def phase_slab(workdir, main_path=None):
    t0 = time.perf_counter()
    leg_a = slab_cli(os.path.join(workdir, "a"), main_path)
    slab_against_single(os.path.join(workdir, "b"))
    slab_cpu_vs_cuda(os.path.join(workdir, "c"))
    slab_cards(os.path.join(workdir, "d"), leg_a)
    log(f"[17 slab] {time.perf_counter() - t0:.1f} s for the phase")
    return leg_a


class AllreduceRecorder:
    """Wraps ``ShardLayout._allreduce`` (the reductions through the
    process group) and ``Simulation.advance`` for one run: per time step,
    the all-reduces by the bytes each moves."""

    def __enter__(self):
        from exaconstit_tpu_torch import driver
        from exaconstit_tpu_torch.parallel.sharding import ShardLayout
        self.cls, self.saved = ShardLayout, ShardLayout._allreduce
        self.sim_cls = driver.Simulation
        self.advance = driver.Simulation.advance
        self.steps, self.cur = [], collections.Counter()
        rec = self

        def _allreduce(layout, t, op):
            if layout.distributed:
                rec.cur[t.numel() * t.element_size()] += 1
            return rec.saved(layout, t, op)

        def advance(sim, *args, **kw):
            out = rec.advance(sim, *args, **kw)
            rec.steps.append(rec.cur)
            rec.cur = collections.Counter()
            return out

        ShardLayout._allreduce = _allreduce
        driver.Simulation.advance = advance
        return self

    def __exit__(self, *exc):
        self.cls._allreduce = self.saved
        self.sim_cls.advance = self.advance


def replicated_cli(workdir, main_path=None):
    """Leg (a): the 32^3 Voce case over REPL_SHARDS replicated-node shards
    through the CLI in an NCCL process group of one rank; ``main_path``
    phase 5's result, if it ran."""
    from exaconstit_tpu_torch.parallel.replicated import ReplicatedMap
    from exaconstit_tpu_torch.solvers import dogleg_cuda as dc
    label = "18 replicated 32^3"
    toml = write_case((32, 32, 32), REPL_DTS, workdir, "voce",
                      parallel_mode="replicated")
    run_dir = os.path.join(workdir, "run_cuda")
    torch.cuda.reset_peak_memory_stats()
    launch_env = dict(EXACONSTIT_TPU_DIST="1", RANK="0", WORLD_SIZE="1",
                      LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(free_port()))
    with LaunchRecorder(dc.KERNEL) as krec, AllreduceRecorder() as arec, \
            env(EXACONSTIT_TPU_REGIONS="1", **launch_env):
        dc.KERNEL.launches = 0
        rec, wall = run_cli(toml, run_dir, "--shards", str(REPL_SHARDS))
        launches = dc.KERNEL.launches
    peak = torch.cuda.max_memory_allocated()
    ms, _, _ = krec.read()
    sim = rec.sim
    sysm = sim.system
    nsteps = len(REPL_DTS)
    stress = np.loadtxt(os.path.join(run_dir, "avg_stress.txt"), ndmin=2)
    emap = sysm.emap
    check(rec.backend == "nccl" and sim.parallel_mode == "replicated"
          and isinstance(emap, ReplicatedMap) and sysm.layout.distributed
          and sysm.layout.n_shards == REPL_SHARDS, f"the replicated leg ran "
          f"as {sim.parallel_mode} on backend {rec.backend}")
    check(emap.ne_pad > sysm.fes.num_elems,
          "the 32^3 run holds no pad element")
    check(sysm.ea_asm_f32 and sysm.precond_kind == "jacobi",
          "the replicated path left the f32 EA build or took GMG")
    check(stress.shape == (nsteps, 6) and np.isfinite(stress).all(),
          f"replicated average stress rows {stress.shape} or not finite")
    check(len(sim.step_stats) == nsteps, "a replicated step did not finish")
    check(launches > 0 and len(ms) == launches,
          f"the replicated path launched the dogleg kernel {launches} "
          f"times ({len(ms)} recorded)")
    points = set(krec.points)
    check(points == {sysm.npts}, f"points per launch {sorted(points)}, not "
          f"the rank's {sysm.npts} padded points")
    structure = [st["subdivided"] for st in sim.step_stats]
    leg_a = dict(launches=launches, wall=wall, toml=toml, workdir=workdir,
                 main_path=main_path, refs={}, dts=REPL_DTS, label=label,
                 numerics=REPL_NUMERICS, structure=structure,
                 median_ms=float(np.median(ms)), max_ms=float(ms.max()))
    gaps = szz_gaps(stress[:, 2], structure, leg_a)
    for k, (st, secs) in enumerate(zip(sim.step_stats, sim.step_times)):
        kr = st["krylov_iters"]
        rel, name = gaps[k]
        log(f"[{label}] step {k + 1} dt {REPL_DTS[k]}: {secs:.2f} s, first "
            f"NR {st['first_nr']}, {st['subdivided']} sub-solve(s), last NR "
            f"{st['nr_iters']}, Krylov/NR {kr} (mean "
            f"{np.mean(kr) if kr else 0:.1f}); szz {stress[k, 2]:.6g}, gap "
            f"to {name}'s {rel:.3e} (bound {SLAB_SZZ_RTOL:g}); all-reduces "
            + ", ".join(f"{c} of {b} B" for b, c in
                        sorted(arec.steps[k].items(), reverse=True)))
    check_szz("leg (a)", gaps)
    nodal = 3 * sysm.nn * 8
    check(nodal in arec.steps[0], f"no all-reduce of the {nodal} B f64 nodal "
          "vector in step 1")
    log(f"[{label}] {sysm.npts} points a rank ({emap.ne_pad} padded "
        f"elements for {sysm.fes.num_elems}) over {REPL_SHARDS} shards, "
        f"backend {rec.backend}, precond {sysm.precond_kind}, wall "
        f"{wall:.2f} s for {nsteps} steps, peak memory "
        f"{peak / 2**30:.3f} GiB; kernel launches {launches} of "
        f"{sysm.npts} points each, device ms per "
        f"launch median {float(np.median(ms)):.4f}, max "
        f"{float(ms.max()):.4f}; a nodal all-reduce moves {nodal} B in f64, "
        f"{nodal // 2} B in f32")
    region_split(label, sim, wall)
    return leg_a


def replicated_against_single(workdir):
    """Leg (b): MechSystem on a ReplicatedMap over REPL_SHARDS shards
    against the single-device system at this path's numerics (Jacobi, the
    f32 EA build) on the card."""
    from exaconstit_tpu_torch.config.options import parse_options
    from exaconstit_tpu_torch.driver import Simulation
    toml = write_case(SLAB_CHECK_GRID, REPL_DTS, workdir, "voce",
                      parallel_mode="replicated", precond="jacobi")
    out, secs = {}, {}
    for shards in (None, REPL_SHARDS):
        run_dir = os.path.join(workdir, f"run_{shards}")
        os.makedirs(run_dir)
        opt = parse_options(toml)
        opt.newton_rel_tol, opt.newton_abs_tol = SLAB_CHECK_NR_TOLS
        opt.krylov_rel_tol = SLAB_CHECK_KRYLOV_TOL
        t0 = time.perf_counter()
        with torch.inference_mode():
            sim = Simulation(opt, workdir=run_dir, device="cuda",
                             shards=shards)
            sim.run(verbose=False)
        secs[shards] = time.perf_counter() - t0
        sysm = sim.system
        ne = sysm.fes.num_elems
        state = sysm.from_state(sim.state)[:ne].copy()
        state[:, :, 3] = 0.0  # point-solve iteration counts
        out[shards] = dict(
            avg=np.loadtxt(os.path.join(run_dir, "avg_stress.txt"),
                           ndmin=2),
            stress=sysm.from_stress(sim.stress)[:ne], state=state,
            v=sysm.from_node(sim.v), mode=sim.parallel_mode,
            f32=sysm.ea_asm_f32, precond=sysm.precond_kind)
    one, rep = out[None], out[REPL_SHARDS]
    check(one["mode"] == "single" and rep["mode"] == "replicated"
          and one["f32"] and rep["f32"] and one["precond"] == "jacobi"
          == rep["precond"], f"leg (b) ran {one['mode']} and {rep['mode']}")
    gaps = {}
    for name, rtol, atol in (("avg", 1e-5, 1e-12), ("stress", 1e-6, 1e-9),
                             ("state", 1e-6, 1e-9), ("v", 0.0, 1e-9)):
        a, b = rep[name], one[name]
        excess = float(np.max(np.abs(a - b) - (atol + rtol * np.abs(b))))
        gaps[name] = float(np.max(np.abs(a - b)))
        check(excess <= 0.0, f"replicated and single-device {name} differ "
              f"by {gaps[name]:.3e} (rtol {rtol:g}, atol {atol:g})")
    log(f"[18 replicated {'x'.join(map(str, SLAB_CHECK_GRID))}] "
        f"{REPL_SHARDS} shards against one device on the card, "
        f"{len(REPL_DTS)} steps: max abs diff "
        + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
        + f" ({secs[REPL_SHARDS]:.1f} s sharded, {secs[None]:.1f} s single)")


def replicated_cpu_vs_cuda(workdir):
    """Leg (c): each configuration the slab refuses, and the point-major
    half, over REPL_SHARDS replicated shards at 4^3, the card against the
    CPU."""
    for name, (family, options, tol) in REPL_VARIANTS.items():
        tag = name.replace(" ", "_").replace(",", "")
        out, secs = {}, {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            sim, out[dev] = run_case((4, 4, 4), REPL_DTS, dev,
                                     os.path.join(workdir, f"{tag}_{dev}"),
                                     family, shards=REPL_SHARDS, **options)
            secs[dev] = time.perf_counter() - t0
            check(sim.parallel_mode == "replicated", f"leg (c) {name} ran "
                  f"{sim.parallel_mode} on {dev}")
        rel = float(np.max(np.abs(out["cuda"] - out["cpu"]))
                    / np.max(np.abs(out["cpu"])))
        check(np.isfinite(out["cuda"]).all() and rel <= tol,
              f"replicated {name}: CUDA and CPU average stress differ by "
              f"rel {rel:.3e} > {tol:g}")
        log(f"[18 replicated {name} cuda vs cpu 4^3, {REPL_SHARDS} shards, "
            f"{len(REPL_DTS)} step(s)] max rel diff {rel:.3e} (bound {tol:g}; "
            f"{secs['cuda']:.1f} s on the card, {secs['cpu']:.1f} s on the "
            "CPU)")


def replicated_cards(workdir):
    """Leg (d): with two cards or more, 2 NCCL ranks under torchrun, one
    card each, REPL_CARDS_SHARDS shards, against one process's stacked
    shards on the final checkpoint's arrays (SLAB_RANKS_TOLS)."""
    cards = torch.cuda.device_count()
    if cards < 2:
        log(f"[18 replicated] two-card NCCL leg not run: {cards} card")
        return
    nsteps = len(REPL_DTS)
    toml = write_case((32, 32, 32), REPL_DTS, workdir, "voce",
                      parallel_mode="replicated", checkpoint_steps=nsteps)
    penv = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.abspath(__file__)) + os.pathsep
        + os.environ.get("PYTHONPATH", ""))
    ends, secs, steps = {}, {}, {}
    for ranks in (1, 2):
        run_dir = os.path.join(workdir, f"run_{ranks}ranks")
        os.makedirs(run_dir)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(ranks), "--local-ranks-filter", "0",
             "-m", "exaconstit_tpu_torch.cli", "-opt", toml, "-q",
             "--shards", str(REPL_CARDS_SHARDS)],
            cwd=run_dir, env=penv, capture_output=True, text=True,
            timeout=900)
        secs[ranks] = time.perf_counter() - t0
        check(proc.returncode == 0, f"the {ranks}-rank replicated run "
              "failed:\n" + proc.stdout[-3000:] + proc.stderr[-3000:])
        with np.load(os.path.join(run_dir, "checkpoint",
                                  "checkpoint.npz")) as ck:
            ends[ranks] = {k: ck[k].copy() for k in
                           ("x_beg", "v", "stress", "state")}
        ends[ranks]["state"][:, :, 3] = 0.0  # iteration counts
        steps[ranks] = [round(float(t), 2) for t in np.loadtxt(os.path.join(
            run_dir, "timing", "time_solve.0.txt"), ndmin=1)]
    rtol, atol = SLAB_RANKS_TOLS
    diffs, bad = {}, []
    for name, want in ends[1].items():
        a = ends[2][name]
        diffs[name] = ("bitwise" if np.array_equal(a, want) else
                       f"{float(np.max(np.abs(a - want))):.3e}")
        if np.max(np.abs(a - want) - (atol + rtol * np.abs(want))) > 0:
            bad.append(name)
    log(f"[18 replicated 32^3] two cards, 2 NCCL ranks x "
        f"{REPL_CARDS_SHARDS // 2} shards against one rank's "
        f"{REPL_CARDS_SHARDS}: {secs[2]:.1f} s and {secs[1]:.1f} s with the "
        f"processes' start, step seconds on rank 0 {steps[2]} and "
        f"{steps[1]}; end state max abs diff: "
        + ", ".join(f"{k} {v}" for k, v in diffs.items()))
    check(not bad, f"two cards and one card differ in {bad} beyond rtol "
          f"{rtol:g} / atol {atol:g}: {diffs}")


def phase_replicated(workdir, main_path=None):
    t0 = time.perf_counter()
    leg_a = replicated_cli(os.path.join(workdir, "a"), main_path)
    replicated_against_single(os.path.join(workdir, "b"))
    replicated_cpu_vs_cuda(os.path.join(workdir, "c"))
    replicated_cards(os.path.join(workdir, "d"))
    leg_a["seconds"] = time.perf_counter() - t0
    log(f"[18 replicated] {leg_a['seconds']:.1f} s for the phase")
    return leg_a

# ---------------------------------------------------------------------------
# phase 19: the point update's remaining knobs and forward-mode sensitivities
# ---------------------------------------------------------------------------

# leg (a): phase 5's steps with the coupled tangent; leg (b): the coupled
# hardness on the per-point engine, dt 0.01 steps while they fit in
# VARIANT_B_BUDGET seconds (at least one)
VARIANT_A_DTS = MAIN_DTS
# leg (a)'s first steps held to phase 5's sigma_zz at phase 5's sub-solves
VARIANT_A_HELD = 2
VARIANT_B_DT, VARIANT_B_STEPS, VARIANT_B_BUDGET = 0.01, 5, 40.0
# leg (c): each knob of the point update on the 4^3 Voce case, one dt 0.2
# step (2 substeps), the card against the CPU (rel tolerance on the
# average stress)
POINT_KNOBS = {
    "engine vmap": dict(engine="vmap"),
    "tangent coupled": dict(tangent_mode="coupled"),
    "hardness coupled": dict(hardness_mode="coupled"),
    "stagger_iters 2": dict(stagger_iters=2),
    "h_per_substep off": dict(h_per_substep=False),
    "flow_theta 0.5": dict(flow_theta=0.5),
    "rot_frame begin": dict(rot_frame="begin"),
    "h_order before": dict(h_order="before", h_gd_blend=1.0),
    "h_gd_source gd_begin": dict(h_gd_source="gd_begin", h_gd_blend=1.0),
    "h_gd_source h_forward": dict(h_gd_source="h_forward", h_gd_blend=1.0),
}
POINT_KNOB_DTS, POINT_KNOB_TOL = (0.2,), 1e-6
# leg (d): forward-mode JVPs of a material-point curve at the 32^3 case's
# quadrature points: STEPS steps of dt, the state carried; the kernel's
# stage against the plain stage on the card (rel of the largest tangent),
# both against a central difference of relative step JVP_FD_H on the
# curve's mean sigma_zz; and an MTSDD curve (SplineG, ift_tangents) at
# JVP_MTSDD_POINTS, the card against the CPU
JVP_POINTS, JVP_STEPS, JVP_DT = 262_144, 5, 0.1
JVP_FIELDS = ("h0", "gs0", "xm")
JVP_STAGE_RTOL, JVP_FD_RTOL, JVP_FD_H = 1e-5, 1e-4, 1e-6
JVP_MTSDD_POINTS, JVP_MTSDD_FIELDS, JVP_MTSDD_RTOL = 1024, ("c1",), 1e-6


def knob_model(opt_toml, **knobs):
    """The options file's ECMech model with ``knobs`` set on its point
    update, and the parsed options."""
    from exaconstit_tpu_torch.config.options import parse_options
    from exaconstit_tpu_torch.models.ecmech import build_model
    opt = parse_options(opt_toml)
    props = np.loadtxt(opt.abspath(opt.props_file)).reshape(-1)
    m = build_model(opt, props)
    return opt, dataclasses.replace(m, evptn=dataclasses.replace(
        m.evptn, **knobs))


def knob_simulation(toml, run_dir, device, knobs, dts=None):
    """``Simulation`` on ``toml`` with the knobbed model, run; returns
    (sim, average stress rows, wall seconds)."""
    from exaconstit_tpu_torch import set_precision_policy
    from exaconstit_tpu_torch.driver import Simulation
    set_precision_policy()
    os.makedirs(run_dir, exist_ok=True)
    opt, model = knob_model(toml, **knobs)
    t0 = time.perf_counter()
    with torch.inference_mode():
        sim = Simulation(opt, workdir=run_dir, device=device, model=model)
        sim.run(verbose=False)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stress = np.loadtxt(os.path.join(run_dir, "avg_stress.txt"), ndmin=2)
    return sim, stress, wall


def variants_coupled_tangent(workdir, main_path):
    """Leg (a): the 32^3 Voce case with tangent_mode="coupled" on the
    component-major engine, the kernel's stage in every setup."""
    from exaconstit_tpu_torch.solvers import dogleg_cuda as dc
    label = "19 variants (a) coupled tangent 32^3"
    toml = write_case((32, 32, 32), VARIANT_A_DTS, workdir)
    torch.cuda.reset_peak_memory_stats()
    with LaunchRecorder(dc.KERNEL) as rec:
        dc.KERNEL.launches = 0
        sim, stress, wall = knob_simulation(
            toml, os.path.join(workdir, "run"), "cuda",
            dict(tangent_mode="coupled"))
        launches = dc.KERNEL.launches
    ms, _, _ = rec.read()
    peak = torch.cuda.max_memory_allocated()
    sysm = sim.system
    check(sim.model.supports_cm and not sysm.point_major,
          "the coupled tangent left the component-major engine")
    check(launches > 0 and len(ms) == launches,
          f"leg (a) launched the kernel {launches} times ({len(ms)} "
          "recorded)")
    check(stress.shape == (len(VARIANT_A_DTS), 6)
          and np.isfinite(stress).all(), f"leg (a) stress {stress}")
    for k, (st, secs) in enumerate(zip(sim.step_stats, sim.step_times)):
        kr = st["krylov_iters"]
        msg = (f"[{label}] step {k + 1} dt {VARIANT_A_DTS[k]}: {secs:.2f} s, "
               f"first NR {st['first_nr']}, {st['subdivided']} "
               f"sub-solve(s), last NR {st['nr_iters']}, Krylov/NR {kr}, "
               f"szz {stress[k, 2]:.6g}")
        if main_path is not None:
            gap = abs(stress[k, 2] - main_path["szz"][k]) / abs(
                main_path["szz"][k])
            msg += (f"; phase 5 (lagged tangent): {main_path['subdivided'][k]}"
                    f" sub-solve(s), szz {main_path['szz'][k]:.6g}, gap "
                    f"{gap:.3e}")
        log(msg)
    structure = [st["subdivided"] for st in sim.step_stats]
    if main_path is not None:
        # the tangent steers Newton but must not move a converged step:
        # phase 5's first VARIANT_A_HELD steps forced on this run's model
        nheld = VARIANT_A_HELD
        want = list(main_path["subdivided"][:nheld])
        if structure[:nheld] == want:
            szz = stress[:nheld, 2]
        else:
            toml2 = write_case((32, 32, 32), VARIANT_A_DTS[:nheld],
                               os.path.join(workdir, "held"))
            szz = same_structure_szz(
                toml2, os.path.join(workdir, "held_run"), want, label,
                VARIANT_A_DTS[:nheld], (("phase 5's", "auto", True),),
                knobs=dict(tangent_mode="coupled"))
        for k in range(nheld):
            gap = abs(szz[k] - main_path["szz"][k]) / abs(main_path["szz"][k])
            log(f"[{label}] step {k + 1} at phase 5's {want[k]} sub-solves: "
                f"szz {szz[k]:.6g}, gap to phase 5's {gap:.3e} (bound "
                f"{SLAB_SZZ_RTOL:g})")
            check(gap <= SLAB_SZZ_RTOL, f"leg (a) szz gap {gap:.3e} > "
                  f"{SLAB_SZZ_RTOL:g} at phase 5's sub-solves")
    log(f"[{label}] wall {wall:.2f} s, precond {sysm.precond_kind}, peak "
        f"{peak / 2**30:.3f} GiB, kernel launches {launches}, device ms "
        f"per launch median {float(np.median(ms)):.4f}, max "
        f"{float(ms.max()):.4f}")
    return dict(launches=launches, median_ms=float(np.median(ms)),
                max_ms=float(ms.max()), structure=structure, wall=wall,
                szz=stress[:, 2])


class DoglegSolveRecorder:
    """Wraps the per-point engine's ``dogleg_solve`` for one run: calls,
    loop trips (the largest lane's iterations: the masked loop runs until
    its slowest lane stops) and host seconds with a synchronisation either
    side."""

    def __enter__(self):
        from exaconstit_tpu_torch.models import evptn
        self.mod, self.inner = evptn, evptn.dogleg_solve
        self.calls, self.trips, self.seconds = 0, 0, 0.0
        rec = self

        def dogleg_solve(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = rec.inner(*args, **kw)
            rec.trips += int(out[2].max())
            rec.seconds += time.perf_counter() - t0
            rec.calls += 1
            return out

        evptn.dogleg_solve = dogleg_solve
        return self

    def __exit__(self, *exc):
        self.mod.dogleg_solve = self.inner


def variants_coupled_hardness(workdir):
    """Leg (b): the 32^3 Voce case with hardness_mode="coupled": the
    point-major path and the per-point engine in f64 (no kernel)."""
    from exaconstit_tpu_torch.solvers import dogleg_cuda as dc
    label = "19 variants (b) coupled hardness 32^3"
    dts = (VARIANT_B_DT,) * VARIANT_B_STEPS
    toml = write_case((32, 32, 32), dts, workdir)
    torch.cuda.reset_peak_memory_stats()
    from exaconstit_tpu_torch import set_precision_policy
    from exaconstit_tpu_torch.driver import Simulation
    set_precision_policy()
    opt, model = knob_model(toml, hardness_mode="coupled")
    run_dir = os.path.join(workdir, "run")
    os.makedirs(run_dir)
    dc.KERNEL.launches = 0
    with DoglegSolveRecorder() as rec, torch.inference_mode():
        t0 = time.perf_counter()
        sim = Simulation(opt, workdir=run_dir, device="cuda", model=model)
        sysm = sim.system
        t, secs = 0.0, []
        for k in range(VARIANT_B_STEPS):  # Simulation.run's loop, cut
            s0 = time.perf_counter()
            t += sim.advance(k + 1, VARIANT_B_DT, verbose=False)
            sim.write_averages()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - s0)
            if time.perf_counter() - t0 + secs[-1] > VARIANT_B_BUDGET:
                break
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(dc.KERNEL.launches == 0, f"the per-point engine launched the "
          f"kernel {dc.KERNEL.launches} times")
    check(sysm.point_major and not sysm.ea_asm_f32
          and sysm.precond_kind == "jacobi",
          "the coupled hardness left the point-major path")
    stress = np.loadtxt(os.path.join(run_dir, "avg_stress.txt"), ndmin=2)
    check(np.isfinite(stress).all() and len(secs) >= 1,
          f"leg (b) stress {stress}")
    for k, (st, sec) in enumerate(zip(sim.step_stats, secs)):
        log(f"[{label}] step {k + 1} dt {VARIANT_B_DT}: {sec:.2f} s, "
            f"{st['subdivided']} sub-solve(s), NR {st['nr_iters']}, "
            f"Krylov/NR {st['krylov_iters']}, szz {stress[k, 2]:.6g}")
    log(f"[{label}] {len(secs)} step(s) in {wall:.2f} s with the set-up, "
        f"peak {peak / 2**30:.3f} GiB, 0 kernel launches; per-point "
        f"dogleg: {rec.calls} calls, {rec.trips} loop trips, "
        f"{rec.seconds:.2f} s ({1e3 * rec.seconds / max(rec.trips, 1):.2f} "
        f"ms a trip over {sysm.npts} points in f64)")
    return dict(steps=len(secs), seconds=secs, trips=rec.trips,
                dogleg_s=rec.seconds, calls=rec.calls)


def variants_cpu_vs_cuda(workdir):
    """Leg (c): every knob on the 4^3 Voce case, the card against the
    CPU."""
    toml = write_case((4, 4, 4), POINT_KNOB_DTS, workdir)
    for name, knobs in POINT_KNOBS.items():
        tag = name.replace(" ", "_")
        out, secs = {}, {}
        for dev in ("cuda", "cpu"):
            sim, out[dev], secs[dev] = knob_simulation(
                toml, os.path.join(workdir, f"{tag}_{dev}"), dev, knobs)
        rel = float(np.max(np.abs(out["cuda"] - out["cpu"]))
                    / np.max(np.abs(out["cpu"])))
        check(np.isfinite(out["cuda"]).all() and rel <= POINT_KNOB_TOL,
              f"knob {name}: CUDA and CPU average stress differ by rel "
              f"{rel:.3e} > {POINT_KNOB_TOL:g}")
        log(f"[19 variants (c) {name} cuda vs cpu 4^3] engine "
            f"{'cm' if sim.model.supports_cm else 'per-point'}, max rel "
            f"diff {rel:.3e} (bound {POINT_KNOB_TOL:g}; {secs['cuda']:.1f} "
            f"s on the card, {secs['cpu']:.1f} s on the CPU)")


def curve_inputs(model, n, seed, device):
    """Seeded uniaxial velocity gradients (n, 3, 3) and a state part-way
    through loading, as the port's tests make them."""
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(n, 3, 3)) * 3e-4
    L[:, 0, 0] -= 5e-4
    L[:, 1, 1] -= 5e-4
    L[:, 2, 2] += 1e-3
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    s = model.init_state(q)
    s[:, model.IND_ESTRAIN:model.IND_ESTRAIN + 5] = rng.normal(
        size=(n, 5)) * 5e-5
    s[:, model.IND_HARD] *= rng.uniform(1.0, 1.5, size=n)
    return (torch.tensor(L, device=device), torch.tensor(s, device=device))


def jvp_curve(model, fields, theta, L, s, direction=None):
    """(stress (STEPS, N, 6), end state, their tangents or None) of the
    STEPS-step point curve at kinetics parameters ``theta``; with a
    ``direction`` the parameters are dual tensors of forward-mode AD."""
    import torch.autograd.forward_ad as fwAD
    kin = model.evptn.kinetics

    def run(params):
        m = dataclasses.replace(model, evptn=dataclasses.replace(
            model.evptn, kinetics=dataclasses.replace(
                kin, **dict(zip(fields, params)))))
        st, out = s, []
        for _ in range(JVP_STEPS):
            stress, st, _ = m.model_setup(JVP_DT, L, st,
                                          compute_tangent=False)
            out.append(stress)
        return torch.stack(out), st

    if direction is None:
        with torch.inference_mode():
            return (*run([float(v) for v in theta]), None, None)
    with fwAD.dual_level():
        th = fwAD.make_dual(torch.tensor(theta, dtype=torch.float64),
                            torch.tensor(direction, dtype=torch.float64))
        y, st = run(list(th.unbind()))
        uy, us = fwAD.unpack_dual(y), fwAD.unpack_dual(st)

        def tan(u):
            return (torch.zeros_like(u.primal) if u.tangent is None
                    else u.tangent.clone())

        return uy.primal.clone(), us.primal.clone(), tan(uy), tan(us)


def variants_jvp(workdir):
    """Leg (d): forward-mode JVPs of the Voce point curve at 262,144
    points on the card, the kernel's stage against the plain one and
    both against central differences; an MTSDD (SplineG) curve with
    ift_tangents, the card against the CPU."""
    from exaconstit_tpu_torch.solvers import dogleg_cuda as dc
    label = "19 variants (d) jvp"
    model = build_ecmech("voce")
    kin = model.evptn.kinetics
    theta = np.array([float(getattr(kin, f)) for f in JVP_FIELDS])
    L, s = curve_inputs(model, JVP_POINTS, 19, "cuda")
    out = {}
    for i, field in enumerate(JVP_FIELDS):
        d = np.eye(len(JVP_FIELDS))[i]
        stage = dc.dogleg_stage
        dc.KERNEL.launches = 0
        t0 = time.perf_counter()
        y, st, dy_k, ds_k = jvp_curve(model, JVP_FIELDS, theta, L, s, d)
        torch.cuda.synchronize()
        t_k = time.perf_counter() - t0
        launches = dc.KERNEL.launches
        dc.dogleg_stage = dc.dogleg_stage_reference
        try:
            t0 = time.perf_counter()
            _, _, dy_p, _ = jvp_curve(model, JVP_FIELDS, theta, L, s, d)
            torch.cuda.synchronize()
            t_p = time.perf_counter() - t0
        finally:
            dc.dogleg_stage = stage
        check(launches == JVP_STEPS, f"{field}: the JVP curve launched the "
              f"kernel {launches} times, not {JVP_STEPS}")
        y0, st0, _, _ = jvp_curve(model, JVP_FIELDS, theta, L, s)
        same = torch.equal(y, y0) and torch.equal(st, st0)
        vgap = float((y - y0).abs().max() / y0.abs().max())
        check(vgap <= 1e-12, f"{field}: the values with dual inputs differ "
              f"from those without by rel {vgap:.3e}")
        scale = float(dy_k.abs().max())
        gap = float((dy_k - dy_p).abs().max()) / max(scale, 1e-300)
        check(scale > 0.0 and gap <= JVP_STAGE_RTOL,
              f"{field}: kernel and plain stage tangents differ by rel "
              f"{gap:.3e} > {JVP_STAGE_RTOL:g} (largest {scale:.3e})")
        h = JVP_FD_H * abs(theta[i])
        yp = jvp_curve(model, JVP_FIELDS, theta + h * d, L, s)[0]
        ym = jvp_curve(model, JVP_FIELDS, theta - h * d, L, s)[0]
        fd = (yp - ym) / (2 * h)
        # the curve's mean sigma_zz per step, the quantity a fit reads
        m_k, m_p, m_fd = (float(a[..., 2].mean(dim=1).abs().max())
                          for a in (dy_k, dy_p, fd))
        g_k = float((dy_k[..., 2].mean(dim=1) - fd[..., 2].mean(dim=1))
                    .abs().max()) / max(m_fd, 1e-300)
        g_p = float((dy_p[..., 2].mean(dim=1) - fd[..., 2].mean(dim=1))
                    .abs().max()) / max(m_fd, 1e-300)
        pt = float((dy_k - fd).abs().max()) / scale
        check(g_k <= JVP_FD_RTOL and g_p <= JVP_FD_RTOL,
              f"{field}: mean szz tangent against the central difference "
              f"rel {g_k:.3e} (kernel), {g_p:.3e} (plain) > {JVP_FD_RTOL:g}")
        log(f"[{label} voce {JVP_POINTS}] d/d{field}: kernel stage "
            f"{t_k:.2f} s ({launches} launches), plain stage {t_p:.2f} s; "
            f"largest stress tangent {scale:.4e}, kernel vs plain rel "
            f"{gap:.3e} (bound {JVP_STAGE_RTOL:g}); mean szz tangent "
            f"{m_k:.6e} against the central difference (h {h:.3e}) rel "
            f"{g_k:.3e} kernel, {g_p:.3e} plain (bound {JVP_FD_RTOL:g}); "
            f"per point {pt:.3e} of the largest; values with duals "
            + ("bitwise those without" if same else
               f"{vgap:.3e} rel from those without"))
        out[field] = dict(gap=gap, fd_kernel=g_k, fd_plain=g_p)
    # MTSDD (SplineG) with the implicit-function tangents, card vs CPU
    mt = build_ecmech("mtsdd")
    mt = dataclasses.replace(mt, evptn=dataclasses.replace(
        mt.evptn, ift_tangents=True, solver_tol=1e-13))
    th = np.array([float(getattr(mt.evptn.kinetics, f))
                   for f in JVP_MTSDD_FIELDS])
    res, secs = {}, {}
    for dev in ("cuda", "cpu"):
        Lm, sm = curve_inputs(mt, JVP_MTSDD_POINTS, 23, dev)
        t0 = time.perf_counter()
        res[dev] = [a.cpu() for a in jvp_curve(mt, JVP_MTSDD_FIELDS, th,
                                               Lm, sm, np.ones(1))]
        secs[dev] = time.perf_counter() - t0
    dy_c, dy_h = res["cuda"][2], res["cpu"][2]
    scale = float(dy_h.abs().max())
    gap = float((dy_c - dy_h).abs().max()) / max(scale, 1e-300)
    check(scale > 0.0 and gap <= JVP_MTSDD_RTOL,
          f"MTSDD JVP: card and CPU differ by rel {gap:.3e} > "
          f"{JVP_MTSDD_RTOL:g} (largest {scale:.3e})")
    log(f"[{label} mtsdd {JVP_MTSDD_POINTS}, ift_tangents] d/d"
        f"{JVP_MTSDD_FIELDS[0]}: largest stress tangent {scale:.4e}, card "
        f"vs CPU rel {gap:.3e} (bound {JVP_MTSDD_RTOL:g}); {secs['cuda']:.2f}"
        f" s on the card, {secs['cpu']:.2f} s on the CPU")
    return out


def build_ecmech(family):
    """The in-repo case's FCC ECMech model of ``family`` ("voce" or
    "mtsdd")."""
    from exaconstit_tpu_torch.cases import MTSDD_PROPS, VOCE_PROPS
    from exaconstit_tpu_torch.config.options import (ExaOptions, MechType,
                                                     SlipType, XtalType)
    from exaconstit_tpu_torch.models.ecmech import build_model
    opt = ExaOptions()
    opt.mech_type = MechType.EXACMECH
    opt.xtal_type = XtalType.FCC
    opt.slip_type = (SlipType.POWERVOCE if family == "voce"
                     else SlipType.MTSDD)
    return build_model(opt, VOCE_PROPS if family == "voce" else MTSDD_PROPS)


def phase_variants(workdir, main_path=None):
    t0 = time.perf_counter()
    leg_a = variants_coupled_tangent(os.path.join(workdir, "a"), main_path)
    leg_b = variants_coupled_hardness(os.path.join(workdir, "b"))
    variants_cpu_vs_cuda(os.path.join(workdir, "c"))
    leg_d = variants_jvp(os.path.join(workdir, "d"))
    leg_a["seconds"] = time.perf_counter() - t0
    log(f"[19 variants] {leg_a['seconds']:.1f} s for the phase")
    return dict(leg_a, b=leg_b, d=leg_d)


def large_make_step(sim, newton_iters, reps, label):
    """``make_step(newton_iters)`` on ``sim``'s system from phase 5's
    start at LARGE_DT: one warm call, then ``reps`` timed calls, each with the previous call's outputs released; the
    memory held before the timed calls, their peak, the kernel's launches
    and their device ms."""
    from exaconstit_tpu_torch.solvers import dogleg_cuda as dc
    sysm = sim.system
    gc.collect()
    built = torch.cuda.memory_allocated()
    step = sysm.make_step(newton_iters)
    args = newton_start(sim, LARGE_DT)
    step(*args)
    torch.cuda.synchronize()
    gc.collect()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times, out = [], None
    with LaunchRecorder(dc.KERNEL) as rec:
        dc.KERNEL.launches = 0
        for _ in range(reps):
            out = None
            t0 = time.perf_counter()
            out = step(*args)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launches = dc.KERNEL.launches
    peak = torch.cuda.max_memory_allocated()
    ms = rec.read()[0]
    check(all(bool(torch.isfinite(t).all()) for t in out),
          f"{label}: make_step returned non-finite values")
    per_call = launches / reps
    setups = newton_iters + 1
    check(per_call == setups * sysm.setup_chunks,
          f"{label}: {per_call:g} kernel launches per call, expected "
          f"{setups} setups x {sysm.setup_chunks} chunks")
    check(set(rec.points) == {sysm.npts // sysm.setup_chunks},
          f"{label}: points per launch {sorted(set(rec.points))}")
    secs = float(np.median(times))
    szz = float(sysm.vol_avg(out[2].reshape(6, sysm.nq, -1),
                             sysm.emap.gather(out[1]))[2])
    log(f"[{label}] make_step({newton_iters}) dt {LARGE_DT}, "
        f"{sysm.setup_chunks} setup chunk(s): median {secs:.3f} s of "
        f"{reps} call(s) ({', '.join(f'{t:.3f}' for t in times)}); "
        f"{per_call:g} kernel launches per call of {rec.points[0]} points, "
        f"device ms per launch median {float(np.median(ms)):.4f}, max "
        f"{float(ms.max()):.4f}; memory held by the built Simulation "
        f"{built / 2**30:.3f} GiB, before the calls {held / 2**30:.3f} GiB, "
        f"their peak {peak / 2**30:.3f} GiB; final |r| "
        f"{float(out[4]):.3e}, szz {szz:.6g}")
    return dict(seconds=secs, launches=per_call, points=rec.points[0],
                median_ms=float(np.median(ms)), max_ms=float(ms.max()),
                built=built, held=held, peak=peak)


def one_setup(sysm, args):
    """One setup of ``sysm`` at ``args`` (``newton_start``'s), cold point
    solves, and the peak memory it took."""
    v, x_beg, state, dt, ess = args
    xw = torch.zeros((8, sysm.npts), dtype=sysm.dtype, device=sysm.device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = sysm.setup(v, x_beg, state, dt, ess, True, sysm.compute_nsub(dt),
                     xw, False)
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated()


def chunk_parting(whole, chunked, args, dt):
    """Where a chunked setup parts from the whole one.  For each chunk,
    each layer computed on the chunk's elements alone against the whole
    system's slice, every layer fed the whole's slice of its inputs: the
    velocity gradient, the point solve's outputs, the EA build on the
    same tangent (in the build's dtype), the force on the same stress.
    In the first chunk that parts, the first op of the EA build and of
    the lagged tangent whose output parts (``first_batch_dependent_op``;
    the trust-region loops take batch-dependent trip counts, so the
    point solve is compared by its outputs only)."""
    from exaconstit_tpu_torch.fem import operators as ops
    v, x_beg, state = args[0], args[1], args[2]
    nq, ne, nc = whole.nq, whole.ne, chunked.setup_chunks
    nec = ne // nc
    el_x = whole.emap.gather(x_beg + dt * v)
    el_v = whole.emap.gather(v)
    dtype = torch.float32 if chunked.ea_asm_f32 else el_x.dtype
    geo = (whole.dshape.to(dtype), whole.qwts.to(dtype))

    def solve(L, st):
        return whole.model.model_setup_cm(
            dt, L, st, compute_tangent=True, nsub=whole.compute_nsub(dt),
            with_solution=True)

    L = whole._vgrad(el_x, el_v)
    out_w = solve(L, state)
    c6 = out_w[2].reshape(6, 6, nq, ne).to(dtype)
    s_w = out_w[0].reshape(6, nq, ne)
    xd = el_x.to(dtype)
    k_w = ops.assemble_ea_gradient_cm(xd, *geo, c6, dt)
    f_w = ops.residual_force_cm(el_x, whole.dshape, whole.qwts, s_w)
    report = []
    for c in range(nc):
        e = slice(c * nec, (c + 1) * nec)

        def pts(a):
            lead = a.shape[:-1]
            return a.reshape(*lead, nq, ne)[..., e].reshape(*lead, -1)

        found = []

        def compare(name, a, b):
            if not torch.equal(a, b):
                d = float((a - b).abs().max())
                found.append(f"{name} {d:.3e} "
                             f"({d / float(a.abs().max()):.1e} rel)")

        compare("velocity gradient", pts(L),
                whole._vgrad(el_x[..., e], el_v[..., e]))
        out_c = solve(pts(L).contiguous(), pts(state).contiguous())
        for name, a, b in zip(("stress", "end state", "tangent",
                               "solution"), out_w, out_c):
            compare(name, pts(a), b)
        del out_c
        compare(f"EA build ({str(dtype)[6:]}) on the same tangent",
                k_w[..., e], ops.assemble_ea_gradient_cm(
                    xd[..., e], *geo, c6[..., e], dt))
        compare("force on the same stress", f_w[..., e],
                ops.residual_force_cm(el_x[..., e], whole.dshape,
                                      whole.qwts, s_w[..., e]))
        if not found:
            continue
        report.append(f"chunk {c}: " + ", ".join(found))
        if len(report) > 1:
            continue
        els = torch.arange(ne, device=L.device)[e]
        first_ea = first_batch_dependent_op(
            lambda: ops.assemble_ea_gradient_cm(xd, *geo, c6, dt),
            lambda: ops.assemble_ea_gradient_cm(xd[..., e], *geo,
                                                c6[..., e], dt),
            els, ne, scope=(ops, "assemble_ea_gradient_cm"))
        first_tan = first_batch_dependent_op(
            lambda: solve(L, state),
            lambda: solve(pts(L).contiguous(), pts(state).contiguous()),
            pts(torch.arange(nq * ne, device=L.device)[None])[0], nq * ne)
        report.append(f"in chunk {c}'s EA build, {first_ea}; inside its "
                      f"lagged tangent, {first_tan}")
    return "; ".join(report) or "no chunk's layers part"


def phase_large(workdir, reps=LARGE_REPS):
    """Phase 20: production-size meshes on one card."""
    from exaconstit_tpu_torch.driver import (EA_F32_POINTS, MechSystem,
                                             run_simulation)
    from exaconstit_tpu_torch.solvers import dogleg_cuda as dc
    t_phase = time.perf_counter()
    label = f"20 large {LARGE_EDGE}^3"
    toml = write_case((LARGE_EDGE,) * 3, (LARGE_STEP_DT,),
                      os.path.join(workdir, "large"))
    # (a) make_step(2), the setup whole and in "auto"'s chunks
    steps = {}
    for chunks in ("1", "auto"):
        with env(EXACONSTIT_SETUP_CHUNKS=chunks), torch.inference_mode():
            sim = card_simulation(toml)
            want = 1 if chunks == "1" else LARGE_CHUNKS
            check(sim.system.setup_chunks == want,
                  f"{label}: setup_chunks {sim.system.setup_chunks} under "
                  f"{chunks!r}, expected {want}")
            steps[chunks] = large_make_step(sim, 2, reps, label)
        if chunks == "1":
            del sim
    with torch.inference_mode():
        sysm = sim.system
        args = newton_start(sim, LARGE_DT)
        whole = MechSystem(sim.opt, sim.mesh, sim.model, device="cuda",
                           setup_chunks=1)
        out_c, _ = one_setup(sysm, args)
        out_w, _ = one_setup(whole, args)
        gaps, same = {}, True
        for name, a, b in zip(SETUP_NAMES, out_c, out_w):
            check(a.dtype == b.dtype and a.shape == b.shape,
                  f"{label}: chunked {name} {a.dtype} {tuple(a.shape)} "
                  f"against {b.dtype} {tuple(b.shape)}")
            if torch.equal(a, b):
                gaps[name] = 0.0
                continue
            same = False
            gaps[name] = float((a - b).abs().max())
        parting = "" if same else "; " + chunk_parting(
            whole, sysm, args, LARGE_DT)
        log(f"[{label}] one setup in {LARGE_CHUNKS} chunks against whole "
            f"(f32 EA build {sysm.ea_asm_f32}): "
            + ("bitwise equal in all six outputs" if same else
               ", ".join(f"{n} {'bitwise' if g == 0 else f'{g:.3e} abs'}"
                         for n, g in gaps.items())) + parting)
        for name, gap in gaps.items():
            check(gap <= LARGE_CHUNK_ATOL, f"{label}: the chunked setup's "
                  f"{name} is {gap:.3e} from the whole one's (atol "
                  f"{LARGE_CHUNK_ATOL:g})")
        del out_c, out_w, whole
        # (c) the storage rule on the card: the f64 build, its blocks
        # stored in f32 above 1,500,000 points
        f32s = MechSystem(sim.opt, sim.mesh, sim.model, device="cuda",
                          ea_asm_f32=False)
        f64s = MechSystem(sim.opt, sim.mesh, sim.model, device="cuda",
                          ea_asm_f32=False, ea_f32=False)
        check(f32s.ea_f32 and f32s.ea_dtype == torch.float32
              and not f64s.ea_f32,
              f"{label}: auto storage at {f32s.npts} points took "
              f"{f32s.ea_dtype}")
        o32, peak32 = one_setup(f32s, args)
        o64, peak64 = one_setup(f64s, args)
        check(o32[1].dtype == torch.float32
              and torch.equal(o32[1], o64[1].to(torch.float32)),
              f"{label}: the stored f32 blocks are not the f64 build's cast")
        check(torch.equal(o32[2], o64[2]),
              f"{label}: the f32-stored system's diagonal is not the f64 "
              "build's")
        for i in (0, 3, 4, 5):
            check(torch.equal(o32[i], o64[i]),
                  f"{label}: storage changed the {SETUP_NAMES[i]}")
        nb32 = o32[1].numel() * o32[1].element_size()
        nb64 = o64[1].numel() * o64[1].element_size()
        log(f"[{label}] storage rule: {f32s.npts} points > "
            f"{EA_F32_POINTS:,}, auto "
            f"stores the f64 build's blocks in f32: blocks bitwise the f64 "
            f"build's cast, diagonal and the other outputs bitwise the f64 "
            f"system's; blocks {nb32 / 1e6:.1f} MB against {nb64 / 1e6:.1f} "
            f"MB; setup peak {peak32 / 2**30:.3f} GiB against "
            f"{peak64 / 2**30:.3f} GiB")
        del o32, o64, f32s, f64s, sim, sysm, args
    # (b) one Simulation step at dt 0.005, chunks "auto"
    run_dir = os.path.join(workdir, "large", "run_cuda")
    os.makedirs(run_dir)
    torch.cuda.reset_peak_memory_stats()
    dc.KERNEL.launches = 0
    t0 = time.perf_counter()
    sim = run_simulation(toml, workdir=run_dir, verbose=False, device="cuda")
    wall = time.perf_counter() - t0
    launches = dc.KERNEL.launches
    peak = torch.cuda.max_memory_allocated()
    stress = np.loadtxt(os.path.join(run_dir, "avg_stress.txt"), ndmin=2)
    check(stress.shape == (1, 6) and np.isfinite(stress).all(),
          f"{label}: the step's average stress {stress}")
    check(sim.system.setup_chunks == LARGE_CHUNKS and launches > 0
          and launches % LARGE_CHUNKS == 0,
          f"{label}: {launches} launches over {sim.system.setup_chunks} "
          "chunks")
    st = sim.step_stats[0]
    log(f"[{label}] Simulation step dt {LARGE_STEP_DT}: "
        f"{sim.step_times[0]:.2f} s, NR {st['nr_iters']} (first solve "
        f"{st['first_nr']}), Krylov/NR {st['krylov_iters']}, "
        f"{st['subdivided']} sub-solve(s), szz {stress[0, 2]:.6g}; wall "
        f"{wall:.2f} s, peak {peak / 2**30:.3f} GiB, {launches} launches "
        f"({launches // LARGE_CHUNKS} setups and residuals x "
        f"{LARGE_CHUNKS} chunks), precond {sim.system.precond_kind}")
    step_b = dict(seconds=sim.step_times[0], wall=wall, peak=peak,
                  launches=launches, nr=st["nr_iters"])
    del sim
    # (d) 96^3, chunks "auto": one make_step(1) call
    label96 = f"20 large {HUGE_EDGE}^3"
    toml96 = write_case((HUGE_EDGE,) * 3, (LARGE_DT,),
                        os.path.join(workdir, "huge"))
    with torch.inference_mode():
        sim = card_simulation(toml96)
        check(sim.system.setup_chunks == HUGE_CHUNKS,
              f"{label96}: setup_chunks {sim.system.setup_chunks}")
        huge = large_make_step(sim, 1, 1, label96)
        del sim
    secs = time.perf_counter() - t_phase
    log(f"[20 large] {secs:.1f} s for the phase")
    return dict(whole=steps["1"], chunked=steps["auto"], step=step_b,
                huge=huge, seconds=secs)


PHASES = ("stage", "staggered", "main", "cpu", "mtsdd", "mesh_pa",
          "configs", "f32", "profile", "guard", "make_step", "slab",
          "replicated", "variants", "large", "entry", "ea_apply")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=None,
                    help="timed make_step calls in phases 14 and 20 (default "
                         f"{MAKE_STEP_REPS} and {LARGE_REPS}; more to compare "
                         "two trees' times)")
    ap.add_argument("--only", default=",".join(PHASES),
                    help="comma-separated phases to run (default: all)")
    args = ap.parse_args(argv)
    only = args.only.split(",")
    unknown = set(only) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}; choose from {PHASES}")
    full = set(only) == set(PHASES)
    t_start = time.perf_counter()
    try:
        phase_device()
        model = build_voce_model()
        phase_build()
        if "stage" in only:
            stage = phase_stage(model)
            stage_bcc = phase_stage(build_voce_model("BCC"),
                                    (BCC_STAGE_SIZE,), "3 stage bcc12")
        if "staggered" in only:
            phase_staggered(model)
        with tempfile.TemporaryDirectory() as tmp:
            main_path = (phase_main(os.path.join(tmp, "main"))
                         if "main" in only else None)
            if "cpu" in only:
                phase_cpu_vs_cuda(tmp)
            if "mtsdd" in only:
                phase_mtsdd(os.path.join(tmp, "mtsdd"))
                # one step: a second (about 35 s on the card and 40 on
                # the CPU) was cut to keep the smoke inside its time limit
                phase_cpu_vs_cuda(tmp, "mtsdd", "8", nsteps=1)
            if "mesh_pa" in only:
                mesh_pa = phase_mesh_pa(os.path.join(tmp, "mesh_pa"))
            if "configs" in only:
                for name, (family, options, tol) in VARIANTS.items():
                    phase_cpu_vs_cuda(tmp, family, "10", name, tol,
                                      **options)
            if "f32" in only:
                f32 = phase_f32(os.path.join(tmp, "f32"),
                                main_path["szz"] if main_path else None)
            if "profile" in only:
                phase_profile(os.path.join(tmp, "profile"))
            if "guard" in only:
                phase_guard(os.path.join(tmp, "guard"))
            if "make_step" in only:
                step = phase_make_step(os.path.join(tmp, "make_step"),
                                       reps=args.reps or MAKE_STEP_REPS)
            if "slab" in only:
                slab = phase_slab(os.path.join(tmp, "slab"), main_path)
            if "replicated" in only:
                replicated = phase_replicated(os.path.join(tmp, "replicated"),
                                              main_path)
            if "variants" in only:
                variants = phase_variants(os.path.join(tmp, "variants"),
                                          main_path)
            if "large" in only:
                large = phase_large(os.path.join(tmp, "large"),
                                    args.reps or LARGE_REPS)
            if "entry" in only:
                phase_entry(os.path.join(tmp, "entry"))
            if "ea_apply" in only:
                ea_apply = phase_ea_apply()
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr, flush=True)
        return 1
    if not full:
        log(f"[16 total] {time.perf_counter() - t_start:.1f} s for the "
            f"phases {only}; no result line")
        return 0
    big = stage[STAGE_SIZES[0]]
    # ms, plain_ms and the bound at the larger stage size; no single
    # PyTorch call computes this solve, so library_ms is null
    print(json.dumps({"kernels": [{
        "name": "dogleg_voce_f32", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": TPU_KERNEL, "launches": main_path["launches"],
        "max_abs_err": max(r["max_abs_err"]
                           for r in (*stage.values(), *stage_bcc.values())),
        "ms": big["ms"], "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
        "share_of_bound": big["bound_ms"] / big["ms"],
        "library_ms": None,
        "path_ms_per_launch_median": main_path["median_ms"],
        "path_ms_per_launch_max": main_path["max_ms"],
        "launches_mesh_pa_path": mesh_pa["launches"],
        "launches_f32_path": f32["launches"],
        "launches_per_make_step": step["launches"],
        "launches_slab_path": slab["launches"],
        "launches_replicated_path": replicated["launches"],
        "replicated_path_ms_per_launch_median": replicated["median_ms"],
        "replicated_path_ms_per_launch_max": replicated["max_ms"],
        "launches_coupled_tangent_path": variants["launches"],
        "coupled_tangent_path_ms_per_launch_median": variants["median_ms"],
        "coupled_tangent_path_ms_per_launch_max": variants["max_ms"],
        "launches_per_make_step_64": large["chunked"]["launches"],
        "make_step_64_ms_per_launch_median": large["chunked"]["median_ms"],
        "make_step_64_ms_per_launch_max": large["chunked"]["max_ms"],
        "launches_per_make_step_64_whole": large["whole"]["launches"],
        "make_step_64_whole_ms_per_launch_median":
            large["whole"]["median_ms"],
        "launches_per_make_step_96": large["huge"]["launches"]}, {
        # the PA apply's kernel pair at 32^3 in f32 (f64 in PERF.md);
        # library_ms: no single PyTorch call computes this apply
        "name": "pa_apply", "route": "cuda", "source": PA_SOURCE,
        "replaces": None, "launches": mesh_pa["pa_launches"],
        "max_rel_err": mesh_pa["pa_ms"]["float32"]["max_rel_err"],
        "ms": (mesh_pa["pa_ms"]["float32"]["kernel_ms"]
               + mesh_pa["pa_ms"]["float32"]["node_ms"]),
        "plain_ms": mesh_pa["pa_ms"]["float32"]["plain_ms"],
        "bound_ms": mesh_pa["pa_ms"]["float32"]["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "apply_ms": mesh_pa["pa_ms"]["float32"]["apply_ms"]}, {
        # the EA apply's kernel pair at 32^3, f32 blocks and x (an f64 x
        # in PERF.md); library_ms: no single PyTorch call computes it
        "name": "ea_apply", "route": "cuda", "source": EA_SOURCE,
        "replaces": None, "launches": main_path["ea_launches"],
        "max_rel_err": ea_apply["float32"]["max_rel_err"],
        "ms": (ea_apply["float32"]["kernel_ms"]
               + ea_apply["float32"]["node_ms"]),
        "plain_ms": ea_apply["float32"]["plain_ms"],
        "bound_ms": ea_apply["float32"]["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "apply_ms": ea_apply["float32"]["apply_ms"]}]}))
    log(f"[16 total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
