#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (exaconstit_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing a line; any failed check exits non-zero with no
result line:

1. device: the card's name and power limit (nvidia-smi), TF32 off;
2. build: nvcc builds the dogleg kernel from csrc/; registers and spills
   from -Xptxas -v, resident blocks per SM from the occupancy query (no
   spills, and at least 16 resident warps per SM);
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
   card, with the kernel's launch count reset just before and read just
   after; every step converges, stress is finite, and the hardening
   slope drops below half the elastic one.  Each launch records a CUDA
   event pair around the kernel call alone (not the wrapper's output
   allocations and counter fill) and its lanes' largest and summed
   iteration counts on the
   device; they are read once after the run: device ms per launch
   (median, max), the launches in which some lane hit max_iter, and the
   path's kernel time against its bound;
6. the same case at 4^3 for 2 steps on the card and on the CPU (the
   plain versions there): average stress to rel 1e-6;
7. the MTSDD path: ``run_simulation`` on the in-repo 32^3 copper FCC
   MTSDD case (500 grains, three steps of dt 0.01) on the card, with
   the additional averages, one checkpoint and one VTU/PVD dump
   written.  Its point solve is pure f64 (plain PyTorch; it must
   launch the kernel no time): per step the seconds, Newton and Krylov
   counts, sub-solves, seconds in the f64 trust-region solves and their
   iterations; peak memory; every output file is read back;
8. the MTSDD case at 4^3 for 2 steps on the card and on the CPU: average
   stress to rel 1e-6;
9. the mesh-file path: the Voce case of phase 5 written as an MFEM mesh
   file and run through the CLI entry point (``Mesh.type = "other"``,
   PA assembly, PCG with Jacobi, the index gather/scatter, cold point
   solves) on the card, dt 0.1, 0.2.  First, two calls of the first
   setup give bitwise-equal residuals, PA tensors and diagonals (the
   index scatter uses no atomics); then, with the kernel's launch count
   reset just before the run and read just after, per step the seconds,
   Newton and Krylov counts and sigma_zz, the seconds in setups, line
   searches and Krylov solves, the PA applies, peak memory, and one PA
   apply timed alone in f32 and f64;
10. CUDA against CPU at 4^3 for 2 steps, average stress to rel 1e-6, for
   each configuration the earlier phases do not run: a mesh file with
   EA, PA, B-bar, GMRES, MINRES and the elastic UMAT;
11. a ``kernels`` JSON line; then the ``ok`` JSON line, last.
"""

import dataclasses
import json
import os
import re
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
MTSDD_DTS = (0.01, 0.01, 0.01)
# The mesh-file PA path: the main path's first two steps.  Its third
# (dt 0.5, across yield) passed only as 8 sub-solves, at the last retry
MESH_PA_DTS = (0.1, 0.2)
# 4^3 configurations held CUDA against CPU in phase 10: (family, options)
VARIANTS = {
    "mesh EA": ("voce", dict(mesh_file=True)),
    "mesh PA": ("voce", dict(mesh_file=True, assembly="PA")),
    "BBar": ("voce", dict(integ_model="BBAR")),
    "GMRES": ("voce", dict(krylov_solver="GMRES")),
    "MINRES": ("voce", dict(krylov_solver="MINRES")),
    "UMAT": ("umat", {}),
}
BCC_STAGE_SIZE = 262_144
TPU_KERNEL = "exaconstit_tpu/solvers/dogleg_pallas.py:211"
KERNEL_SOURCE = "exaconstit_tpu_torch/csrc/dogleg_voce.cu"
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


def run_case(ncuts, dts, device, workdir, family="voce", **options):
    """Write the in-repo case of ``family`` and run it through
    ``run_simulation``; returns (sim, average stress rows)."""
    from exaconstit_tpu_torch.driver import run_simulation
    toml = write_case(ncuts, dts, workdir, family, **options)
    run_dir = os.path.join(workdir, f"run_{device}")
    os.makedirs(run_dir)
    sim = run_simulation(toml, workdir=run_dir, verbose=False,
                         device=device)
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


def phase_main(workdir):
    from exaconstit_tpu_torch.solvers import dogleg_cuda as dc
    KERNEL = dc.KERNEL
    torch.cuda.reset_peak_memory_stats()
    with LaunchRecorder(KERNEL) as rec:
        KERNEL.launches = 0
        t0 = time.perf_counter()
        sim, stress = run_case((32, 32, 32), MAIN_DTS, "cuda", workdir)
        wall = time.perf_counter() - t0
        launches = KERNEL.launches
    peak = torch.cuda.max_memory_allocated()
    ms, it_max, it_sum = rec.read()
    check(len(ms) == launches, f"{len(ms)} recorded launches != {launches}")
    check(stress.shape == (len(MAIN_DTS), 6), f"stress rows {stress.shape}")
    check(np.isfinite(stress).all(), "average stress is not finite")
    check(launches > 0, "the main path never launched the dogleg kernel")
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
        f"{slopes.round(3).tolist()} GPa, kernel launches {launches}, peak "
        f"memory {peak / 2**30:.3f} GiB")
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
    return dict(launches=launches, median_ms=float(np.median(ms)),
                max_ms=float(ms.max()))


def phase_cpu_vs_cuda(workdir, family="voce", label="6", name=None,
                      **options):
    name = name or family
    tag = name.replace(" ", "_")
    secs = {}
    out = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        _, out[dev] = run_case((4, 4, 4), MAIN_DTS[:2], dev,
                               os.path.join(workdir, f"{tag}_{dev}"),
                               family, **options)
        secs[dev] = time.perf_counter() - t0
    s_gpu, s_cpu = out["cuda"], out["cpu"]
    rel = float(np.max(np.abs(s_gpu - s_cpu)) / np.max(np.abs(s_cpu)))
    check(np.isfinite(s_gpu).all() and rel <= 1e-6,
          f"{name}: CUDA and CPU average stress differ by rel {rel:.3e}")
    log(f"[{label} {name} cuda vs cpu 4^3, 2 steps] max rel diff "
        f"{rel:.3e} ({secs['cuda']:.1f} s on the card, {secs['cpu']:.1f} s "
        f"on the CPU)")


class PointSolveRecorder:
    """Wraps ``evptn_cm.dogleg_cm`` (the plain f64 trust-region solve) and
    ``Simulation.advance`` for one run: host seconds in the solves, with
    a synchronisation either side, their count and the iterations of
    their slowest lanes, summed per time step."""

    def __init__(self):
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
            check(x0.dtype == torch.float64, "the MTSDD point solve must "
                  "run in f64")
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


class LayerRecorder:
    """Wraps the ``MechSystem`` methods of one run at class level: host
    seconds in each (a synchronisation either side) and its calls, and
    the operator applies (``apply_k``, counted, not timed); captures the
    run's ``Simulation``."""

    TIMED = ("setup", "residual_only", "krylov_solve")

    def __init__(self):
        self.seconds = dict.fromkeys(self.TIMED, 0.0)
        self.calls = dict.fromkeys(self.TIMED + ("apply_k",), 0)
        self.sim = None

    def __enter__(self):
        from exaconstit_tpu_torch import driver
        self.cls, self.sim_cls = driver.MechSystem, driver.Simulation
        self.saved = {n: getattr(self.cls, n)
                      for n in self.TIMED + ("apply_k",)}
        self.saved_run = self.sim_cls.run
        rec = self

        def timed(name):
            inner = rec.saved[name]

            def call(*args, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = inner(*args, **kw)
                torch.cuda.synchronize()
                rec.seconds[name] += time.perf_counter() - t0
                rec.calls[name] += 1
                return out
            return call

        def apply_k(*args, **kw):
            rec.calls["apply_k"] += 1
            return rec.saved["apply_k"](*args, **kw)

        def run(sim, *args, **kw):
            rec.sim = sim
            return rec.saved_run(sim, *args, **kw)

        for name in self.TIMED:
            setattr(self.cls, name, timed(name))
        self.cls.apply_k = apply_k
        self.sim_cls.run = run
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.cls, name, fn)
        self.sim_cls.run = self.saved_run


def check_setup_bitwise(toml):
    """Two calls of the run's first setup on the card (step 1's SolveInit
    setup) give bitwise-equal residuals, operator data and diagonals."""
    from exaconstit_tpu_torch import set_precision_policy
    from exaconstit_tpu_torch.config.options import parse_options
    from exaconstit_tpu_torch.driver import Simulation
    from exaconstit_tpu_torch.fem.space import IndexMap
    set_precision_policy()
    with torch.inference_mode():
        sim = Simulation(parse_options(toml), workdir=os.path.dirname(toml),
                         device="cuda")
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
    pa_ms = {}
    with torch.inference_mode():
        x = torch.where(ess, 0.0, sim.v + 1.0)
        for dtype in (torch.float32, torch.float64):
            k = first[1].to(dtype)
            pa_ms[str(dtype)[6:]] = cuda_time_ms(
                lambda: sysm.apply_k(k, x.to(dtype)), reps=5)
    log(f"[9 mesh PA 32^3] two calls of the first setup: residual, PA "
        f"tensor {tuple(first[1].shape)} and diagonal bitwise equal "
        f"(index map of valence {sysm.emap.valence}); one PA apply "
        f"(gather, apply, scatter) {pa_ms['float32']:.3f} ms in f32, "
        f"{pa_ms['float64']:.3f} ms in f64")
    del sim, sysm, first, second
    return pa_ms


def phase_mesh_pa(workdir):
    """The Voce case from an MFEM mesh file with PA assembly and Jacobi-
    PCG at full width, through the CLI entry point on the card."""
    from exaconstit_tpu_torch import cli
    from exaconstit_tpu_torch.solvers import dogleg_cuda as dc
    toml = write_case((32, 32, 32), MESH_PA_DTS, workdir, "voce",
                      mesh_file=True, assembly="PA")
    pa_ms = check_setup_bitwise(toml)
    run_dir = os.path.join(workdir, "run_cuda")
    os.makedirs(run_dir)
    cwd = os.getcwd()
    torch.cuda.reset_peak_memory_stats()
    with LayerRecorder() as rec:
        os.chdir(run_dir)
        try:
            dc.KERNEL.launches = 0
            t0 = time.perf_counter()
            cli.main(["-opt", toml, "-q"])
            wall = time.perf_counter() - t0
            launches = dc.KERNEL.launches
        finally:
            os.chdir(cwd)
    peak = torch.cuda.max_memory_allocated()
    sim = rec.sim
    stress = np.loadtxt(os.path.join(run_dir, "avg_stress.txt"), ndmin=2)
    nsteps = len(MESH_PA_DTS)
    check(stress.shape == (nsteps, 6) and np.isfinite(stress).all(),
          f"mesh PA average stress rows {stress.shape} or not finite")
    check(len(sim.step_stats) == nsteps, "a step of the mesh PA path did "
          "not finish")
    check(launches > 0, "the mesh PA path never launched the dogleg kernel")
    for k, (st, secs) in enumerate(zip(sim.step_stats, sim.step_times)):
        kr = st["krylov_iters"]
        retry = (f"first solve failed after NR {st['first_nr']}, "
                 f"{st['subdivided']} sub-solves, the last: "
                 if st["subdivided"] > 1 else "")
        log(f"[9 mesh PA 32^3] step {k + 1} dt {MESH_PA_DTS[k]}: "
            f"{secs:.2f} s, {retry}NR {st['nr_iters']}, Krylov/NR {kr} "
            f"(mean {np.mean(kr) if kr else 0:.1f}), szz {stress[k, 2]:.6g}")
    sec, calls = rec.seconds, rec.calls
    log(f"[9 mesh PA 32^3] {sim.system.npts} points, precond "
        f"{sim.system.precond_kind}, wall {wall:.2f} s for {nsteps} steps; "
        f"setup {sec['setup']:.2f} s in {calls['setup']}, line-search "
        f"residuals {sec['residual_only']:.2f} s in "
        f"{calls['residual_only']}, Krylov {sec['krylov_solve']:.2f} s in "
        f"{calls['krylov_solve']} solves with {calls['apply_k']} PA "
        f"applies; kernel launches {launches}, peak memory "
        f"{peak / 2**30:.3f} GiB")
    return dict(launches=launches, wall=wall, pa_ms=pa_ms)


def main():
    t_start = time.perf_counter()
    try:
        phase_device()
        model = build_voce_model()
        phase_build()
        stage = phase_stage(model)
        stage_bcc = phase_stage(build_voce_model("BCC"), (BCC_STAGE_SIZE,),
                                "3 stage bcc12")
        phase_staggered(model)
        with tempfile.TemporaryDirectory() as tmp:
            main_path = phase_main(os.path.join(tmp, "main"))
            phase_cpu_vs_cuda(tmp)
            phase_mtsdd(os.path.join(tmp, "mtsdd"))
            phase_cpu_vs_cuda(tmp, "mtsdd", "8")
            mesh_pa = phase_mesh_pa(os.path.join(tmp, "mesh_pa"))
            for name, (family, options) in VARIANTS.items():
                phase_cpu_vs_cuda(tmp, family, "10", name, **options)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr, flush=True)
        return 1
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
        "launches_mesh_pa_path": mesh_pa["launches"]}]}))
    log(f"[11 total] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
