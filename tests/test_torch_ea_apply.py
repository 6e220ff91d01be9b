"""The EA operator apply on the strided map (``fem/ea_apply_cuda.py``).

On the CPU: ``operators.apply_ea`` is bitwise today's plain form (the
blocks cast to x's dtype, the gather, the einsum, the strided scatter)
and never touches the kernel library; an ``IndexMap``, ``SlabMap``,
``ReplicatedMap`` or order-2 system keeps the plain form and would keep
it on the card too (``engages``), while the strided map of an order-1
brick with the system's contiguous blocks would take the kernels; the C
entry points match the wrapper's ctypes arguments.  Marked ``cuda``
(they skip here): the kernel pair against the plain version at 32^3 and
16^3 for f32 blocks with f32 and f64 x and for f64 blocks, bitwise
between calls, its element vectors bitwise the fixed-order sums of
``utils.tensors.fixed_dot`` and its node pass bitwise
``StructuredMap.scatter_add`` of them; the inputs it refuses; and a
short GMG solve whose applies all went through the kernels.  Imports
nothing of the JAX package, so that the card's tests run with

    python -m pytest tests/test_torch_ea_apply.py -q -m cuda   # on the card
"""

import os
import re
import types
from collections import Counter

import pytest
import torch

from exaconstit_tpu_torch import cases
from exaconstit_tpu_torch.config.options import parse_options
from exaconstit_tpu_torch.driver import Simulation
from exaconstit_tpu_torch.fem import ea_apply_cuda
from exaconstit_tpu_torch.fem import operators as ops
from exaconstit_tpu_torch.fem.space import IndexMap, StructuredMap
from exaconstit_tpu_torch.solvers import dogleg_cuda, gmg
from exaconstit_tpu_torch.utils import nvcc, profiling
from exaconstit_tpu_torch.utils.tensors import fixed_dot

f32, f64 = torch.float32, torch.float64
# (blocks, x) dtypes the kernels take, and x's f32 with f64 blocks (cast)
PAIRS = [(f32, f32), (f32, f64), (f64, f64)]
PAIR_IDS = ["f32", "f32-blocks-f64-x", "f64"]
# the kernel against the plain version, over the largest |y|: in x's f32
# the plain sums 24 products and 8 element rows in f32 in cuBLAS's order,
# the kernel the 24 products in f64 and the 8 rows in f32, so they part
# by some tens of f32 epsilons of the largest term; in f64 the same at
# f64's epsilon (f32 blocks promoted exactly on both sides)
TOL = {f32: 1e-5, f64: 1e-12}
# a stand-in for x on the card, for ``engages`` on the CPU
ON_CARD = types.SimpleNamespace(is_cuda=True)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")


def ea_problem(grid, k_dtype, x_dtype, device="cpu", seed=0):
    """(StructuredMap, seeded symmetric positive definite (24, 24, ne)
    blocks, x with the z = 0 face's entries zeroed as grad_matvec zeroes
    its essential columns, that face's mask)."""
    ne = grid[0] * grid[1] * grid[2]
    g = torch.Generator().manual_seed(seed)
    b = torch.randn(ne, 24, 24, dtype=f64, generator=g)
    k = (b.transpose(1, 2) @ b + 24 * torch.eye(24, dtype=f64))
    k = k.permute(1, 2, 0).contiguous().to(dtype=k_dtype, device=device)
    smap = StructuredMap(grid)
    ess = torch.zeros((3, *smap.nodes), dtype=torch.bool)
    ess[:, 0] = True
    ess = ess.reshape(-1).to(device)
    x = torch.randn(ess.numel(), dtype=f64, generator=g).to(device)
    return smap, k, torch.where(ess, 0.0, x).to(x_dtype), ess


def _todays_apply(k, smap, x):
    """The EA apply as it was before the kernels, written out."""
    u = smap.gather(x).transpose(0, 1).reshape(24, -1)
    y = torch.einsum("abe,be->ae", k.to(x.dtype), u)
    return smap.scatter_add(y.reshape(8, 3, -1).transpose(0, 1))


def _fixed_order_rows(k, smap, x):
    """The element vectors (3, 8, ne) the kernels compute: each row's 24
    products summed in column order by ``fixed_dot`` (in f64, rounded
    once to x's type)."""
    u = smap.gather(x).transpose(0, 1).reshape(24, -1)
    y = fixed_dot((k[:, c], u[c]) for c in range(24)).to(x.dtype)
    return y.reshape(8, 3, -1).transpose(0, 1)


def _refuse(*args, **kw):
    raise AssertionError("the EA kernel library was touched")


@pytest.mark.parametrize("k_dtype, x_dtype", PAIRS + [(f64, f32)],
                         ids=PAIR_IDS + ["f64-blocks-f32-x"])
def test_cpu_path_is_todays_apply(k_dtype, x_dtype, monkeypatch):
    """On CPU tensors ``apply_ea`` is bitwise today's plain form, counts
    nothing and never builds, loads or launches the kernels."""
    monkeypatch.setattr(ea_apply_cuda.KERNEL, "lib", _refuse)
    monkeypatch.setattr(ea_apply_cuda.KERNEL, "build", _refuse)
    smap, k, x, ess = ea_problem((3, 3, 2), k_dtype, x_dtype)
    assert ea_apply_cuda.engages(k, smap, ON_CARD)
    assert not ea_apply_cuda.engages(k, smap, x)
    regions = profiling.Regions()
    before = ea_apply_cuda.KERNEL.launches
    with profiling.recording(regions):
        got = ops.apply_ea(k, smap, x)
    assert got.dtype == x_dtype and torch.equal(got, _todays_apply(k, smap,
                                                                   x))
    assert torch.equal(got, ops.apply_ea_plain(k, smap, x))
    assert ea_apply_cuda.KERNEL.launches == before
    assert "operator.ea_kernel_applies" not in regions.counters


def test_only_the_strided_order1_map_with_contiguous_blocks_engages():
    """On the card the kernels take the strided map of an order-1 brick
    with (24, 24, ne) contiguous blocks, and nothing else: not an order-2
    map, not an index map of the same brick, not blocks of another
    brick, not element-major blocks (as RAP leaves them on the CPU)."""
    smap, k, _, _ = ea_problem((3, 3, 2), f32, f32)
    assert ea_apply_cuda.engages(k, smap, ON_CARD)
    order2 = StructuredMap((3, 3, 2), order=2)
    assert not ea_apply_cuda.engages(k, order2, ON_CARD)
    assert not ea_apply_cuda.engages(
        torch.zeros(81, 81, 18), order2, ON_CARD)
    conn = gmg._grid_conn(3, 3, 2)
    assert not ea_apply_cuda.engages(k, IndexMap(conn, 48), ON_CARD)
    assert not ea_apply_cuda.engages(k[..., :9], smap, ON_CARD)
    strided = k.permute(0, 2, 1).contiguous().permute(0, 2, 1)
    assert torch.equal(strided, k) and not strided.is_contiguous()
    assert not ea_apply_cuda.engages(strided, smap, ON_CARD)


def _one_step(tmp_path, monkeypatch, ncuts=(2, 2, 2), shards=None,
              **options):
    """One dt 0.1 step of the Voce case with EA on the CPU, the blocks and
    map of every EA apply kept; returns (system, those pairs)."""
    toml = cases.write_voce_case(tmp_path / "case", ncuts, (0.1,),
                                 ngrains=4, assembly="EA", **options)
    seen = []
    apply_ea = ops.apply_ea

    def kept(k_cm, emap, x):
        seen.append((k_cm, emap))
        return apply_ea(k_cm, emap, x)

    monkeypatch.setattr(ops, "apply_ea", kept)
    wd = tmp_path / "run"
    wd.mkdir()
    with torch.inference_mode():
        sim = Simulation(parse_options(toml), workdir=str(wd), device="cpu",
                         shards=shards)
        sim.run(verbose=False)
    assert len(sim.step_stats) == 1
    return sim.system, seen


@pytest.mark.parametrize("layout", ["structured", "index", "slab",
                                    "replicated"])
def test_systems_keep_the_plain_form_off_the_card(layout, tmp_path,
                                                  monkeypatch):
    """An EA run on the CPU never builds, loads or launches the kernels,
    whatever its map.  On the card the index map's, the slab's and the
    replicated map's applies would keep the plain form too, and the
    strided map's would take the kernels: the system's blocks are
    (24, 24, ne) contiguous, as they read them."""
    monkeypatch.setattr(ea_apply_cuda.KERNEL, "lib", _refuse)
    monkeypatch.setattr(ea_apply_cuda.KERNEL, "build", _refuse)
    before = ea_apply_cuda.KERNEL.launches
    options = {"structured": dict(),
               "index": dict(mesh_file=True),
               "slab": dict(ncuts=(2, 2, 4), shards=2, parallel_mode="slab",
                            precond="jacobi"),
               "replicated": dict(shards=2, mesh_file=True,
                                  parallel_mode="replicated")}[layout]
    sysm, seen = _one_step(tmp_path, monkeypatch, **options)
    assert seen and all(emap is sysm.emap for _, emap in seen)
    assert isinstance(sysm.emap, StructuredMap) == (layout == "structured")
    assert isinstance(sysm.emap, IndexMap) == (layout == "index")
    engaged = {ea_apply_cuda.engages(k, emap, ON_CARD) for k, emap in seen}
    assert engaged == {layout == "structured"}
    assert ea_apply_cuda.KERNEL.launches == before


def test_cuda_source_matches_the_wrapper():
    """The C entry points take the wrapper's ctypes arguments in order,
    the build is keyed by source and flags into the package's build
    directory beside the other kernels, and the source says which TPU
    kernel it replaces (none), what bounds it and why it was added."""
    src = ea_apply_cuda.SOURCE.read_text()
    assert "Replaces no TPU kernel" in src and "__global__" in src
    assert "What bounds it on Hopper: bytes" in src
    assert ea_apply_cuda.KERNEL.library_path().parent == \
        dogleg_cuda.KERNEL.library_path().parent
    assert re.fullmatch(r"ea_apply_[0-9a-f]{16}\.so",
                        ea_apply_cuda.KERNEL.library_path().name)
    ctype = {f32: "float", f64: "double"}
    for (k_dtype, x_dtype), name in ea_apply_cuda.ENTRY.items():
        sig = re.search(rf'extern "C" int {name}\(([^)]*)\)', src)
        params = [" ".join(p.split()) for p in sig.group(1).split(",")]
        assert len(params) == len(ea_apply_cuda.ARGTYPES)
        kt, xt = ctype[k_dtype], ctype[x_dtype]
        assert params[:4] == [f"const {kt}* K", f"const {xt}* x",
                              f"{xt}* el_y", f"{xt}* y"]
        assert params[4:7] == ["int nx", "int ny", "int nz"]
        assert params[-1] == "void* stream"
    assert len(re.findall(r'extern "C" int ea_apply_f', src)) == len(
        ea_apply_cuda.ENTRY)
    assert "use_fast_math" not in " ".join(nvcc.FLAGS)


# -- on the card ------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [(32, 32, 32), (16, 16, 16)],
                         ids=["32", "16"])
@pytest.mark.parametrize("k_dtype, x_dtype", PAIRS, ids=PAIR_IDS)
def test_kernel_matches_plain_version(grid, k_dtype, x_dtype):
    """The kernel pair against the plain version within TOL of the
    largest |y|; two calls bitwise equal; its element vectors bitwise
    the fixed-order sums, and its node pass bitwise the plain scatter of
    them; y bitwise ``apply_ea`` through the dispatch."""
    _needs_card()
    smap, k, x, _ = ea_problem(grid, k_dtype, x_dtype, "cuda")
    before = ea_apply_cuda.KERNEL.launches
    y, el_y = ea_apply_cuda.KERNEL.launch(k, x, grid)
    y2 = ops.apply_ea(k, smap, x)
    torch.cuda.synchronize()
    assert ea_apply_cuda.KERNEL.launches == before + 2
    assert y.dtype == el_y.dtype == x_dtype
    want = ops.apply_ea_plain(k, smap, x)
    scale = float(want.abs().max())
    assert scale > 0
    assert float((y - want).abs().max()) <= TOL[x_dtype] * scale
    assert torch.equal(y, y2)
    assert torch.equal(el_y, _fixed_order_rows(k, smap, x))
    assert torch.equal(y, smap.scatter_add(el_y))


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take():
    """A pair of dtypes it has no entry for, a non-contiguous x, a wrong
    shape of x or a tensor off the card raises before any launch; blocks
    that are not contiguous or not of the grid's shape are ``engages``'s
    to refuse, and ``apply_ea`` takes the plain form for them with no
    launch; the wrapper casts f64 blocks to an f32 x's type first, as
    the plain form does."""
    _needs_card()
    grid = (3, 3, 2)
    smap, k, x, _ = ea_problem(grid, f32, f32, "cuda")
    before = ea_apply_cuda.KERNEL.launches
    strided = k.permute(0, 2, 1).contiguous().permute(0, 2, 1)
    bad = [dict(k_cm=k.double()), dict(x=x.half()),
           dict(k_cm=k.half(), x=x.half()),
           dict(x=torch.stack([x, x], 1)[:, 0]),
           dict(x=x[:-3]), dict(x=x.cpu()), dict(k_cm=k.cpu())]
    for change in bad:
        with pytest.raises(ValueError):
            ea_apply_cuda.KERNEL.launch(**{**dict(k_cm=k, x=x, grid=grid),
                                           **change})
    for blocks in (strided, k[..., :-1], k[..., :-1].contiguous()):
        assert not ea_apply_cuda.engages(blocks, smap, x)
    assert torch.equal(ops.apply_ea(strided, smap, x),
                       ops.apply_ea_plain(strided, smap, x))
    assert ea_apply_cuda.KERNEL.launches == before
    y = ea_apply_cuda.ea_apply(k.double(), smap, x)
    assert ea_apply_cuda.KERNEL.launches == before + 1
    assert torch.equal(y, ea_apply_cuda.KERNEL.launch(k.double().float(), x,
                                                      grid)[0])
    assert os.path.basename(ea_apply_cuda.KERNEL.library_path()).startswith(
        "ea_apply_")


@pytest.mark.cuda
def test_kernel_counts_a_short_solve(tmp_path, monkeypatch):
    """One step of the 10^3 Voce case with EA and GMG on the card: every
    apply outside a capture is one kernel apply counted as
    ``operator.ea_kernel_applies`` (under span ``operator.apply`` as
    many as that span's calls, the rest the coarse levels' power
    iterations under ``gmg.build``), every capture took 9 more (the fine
    level's applies of a V-cycle; the coarsest level is a dense solve),
    and the Newton iterations equal the CPU run's."""
    _needs_card()
    monkeypatch.setenv("EXACONSTIT_TPU_REGIONS", "1")
    grid = (10, 10, 10)
    meta = gmg.GMGMeta(grid)
    assert meta.nlevels == 2 and meta.coarse_dense
    per_capture = 2 * gmg.DEGREE + 3
    toml = cases.write_voce_case(tmp_path / "case", grid, (0.005,),
                                 ngrains=8, assembly="EA", precond="auto")
    nr = {}
    for device in ("cpu", "cuda"):
        wd = tmp_path / device
        wd.mkdir()
        with torch.inference_mode():
            sim = Simulation(parse_options(toml), workdir=str(wd),
                             device=device)
            assert sim.system.precond_kind == "gmg"
            before = ea_apply_cuda.KERNEL.launches
            sim.run(verbose=False)
            if device == "cuda":
                torch.cuda.synchronize()
        launched = ea_apply_cuda.KERNEL.launches - before
        regions = sim.system.regions
        counted = Counter(regions.counters.get("operator.ea_kernel_applies",
                                               {}))
        captures = sum(regions.counters.get("gmg.graph_captures",
                                            {}).values())
        if device == "cuda":
            assert captures > 0 and counted["gmg.build"] > 0
            assert counted["operator.apply"] == \
                regions.spans["operator.apply"]["calls"]
            assert set(counted) == {"operator.apply", "gmg.build"}
            assert launched == sum(counted.values()) \
                + per_capture * captures
        else:
            assert launched == 0 and not counted
        nr[device] = [st["nr_iters"] for st in sim.step_stats]
    assert nr["cuda"] == nr["cpu"]
