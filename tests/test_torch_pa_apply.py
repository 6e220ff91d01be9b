"""The PA operator apply on an index map (``fem/pa_apply_cuda.py``).

On the CPU: the wrapper's plain path is bitwise today's
``apply_pa_gradient_cm`` + ``IndexMap.scatter_add`` on a mesh whose
incidence table is padded, with essential rows; a CPU mesh-file PA run
never touches the kernel library; the strided map and the sharded maps
keep the plain form; the C entry points match the wrapper's ctypes
arguments.  Marked ``cuda`` (they skip here): the kernel pair
against the plain version at the 32^3 mesh-file shapes, bitwise between
calls, the scatter in the table's order with pad slots read as zero, its
launch count on a short 8^3 solve whose Newton iterations match the
CPU's, and the inputs it refuses.  Imports nothing of the JAX package,
so that the card's tests run with

    python -m pytest tests/test_torch_pa_apply.py -q -m cuda   # on the card
"""

import os
import re

import numpy as np
import pytest
import torch

from exaconstit_tpu_torch import cases
from exaconstit_tpu_torch.config.options import parse_options
from exaconstit_tpu_torch.driver import Simulation
from exaconstit_tpu_torch.fem import operators as ops
from exaconstit_tpu_torch.fem import pa_apply_cuda
from exaconstit_tpu_torch.fem.reference import ref_element
from exaconstit_tpu_torch.fem.space import IndexMap, StructuredMap
from exaconstit_tpu_torch.mesh.voxel import make_cartesian_mesh
from exaconstit_tpu_torch.solvers import dogleg_cuda
from exaconstit_tpu_torch.utils import nvcc

# the kernel against the plain version, over the largest |y|: f32 sums
# of 648 products a node in another order, f64 the same at its epsilon
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")


def pa_problem(ncuts, dtype, device="cpu", seed=0):
    """(IndexMap, PA tensor, dshape, x with zeroed essential rows, ess)
    on a perturbed order-1 brick read through the index map, with a
    seeded symmetric tangent; the tensor is built in f64 and cast."""
    rng = np.random.default_rng(seed)
    mesh = make_cartesian_mesh(ncuts, [1.0, 1.0, 1.0])
    ref = ref_element(1)
    ne, nn, nq = mesh.num_elems, mesh.num_nodes, ref.nqpts
    coords = mesh.coords + rng.normal(size=mesh.coords.shape) * 0.02 / max(
        ncuts)
    emap = IndexMap(mesh.conn, nn, device=device)
    f64 = dict(dtype=torch.float64, device=device)
    el_x = torch.as_tensor(coords.T.reshape(-1), **f64).reshape(3, nn)[
        :, emap.conn_t]
    c6 = rng.normal(size=(6, 6, nq, ne))
    c6 = 0.5 * (c6 + c6.transpose(1, 0, 2, 3)) \
        + 4.0 * np.eye(6)[:, :, None, None]
    d = ops.assemble_pa_gradient_cm(
        el_x, torch.as_tensor(ref.dshape, **f64),
        torch.as_tensor(ref.qwts, **f64), torch.as_tensor(c6, **f64), 0.37)
    ess = torch.zeros(3 * nn, dtype=torch.bool, device=device)
    ess[:nn][torch.as_tensor(coords[:, 0] < 1e-3, device=device)] = True
    x = torch.as_tensor(rng.normal(size=3 * nn), **f64)
    x = torch.where(ess, 0.0, x).to(dtype)
    return (emap, d.to(dtype), torch.as_tensor(ref.dshape, dtype=dtype,
                                               device=device), x, ess)


def _plain(d, dshape, x, emap):
    return emap.scatter_add(ops.apply_pa_gradient_cm(d, dshape,
                                                     emap.gather(x)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_cpu_path_is_plain_version(dtype):
    """On CPU tensors ``pa_apply`` is bitwise the plain apply and
    scatter, on a brick whose table is padded (valences 1 to 8), with
    essential rows as ``grad_matvec`` applies them; the PA tensor is
    contiguous, element fastest, as the kernel reads it."""
    emap, d, dshape, x, ess = pa_problem((3, 3, 2), dtype)
    counts = (emap.table < emap.conn_t.numel()).sum(dim=0)
    assert emap.valence == 8 and int(counts.min()) == 1
    assert d.is_contiguous() and d.stride()[-1] == 1
    before = pa_apply_cuda.KERNEL.launches
    got = torch.where(ess, x, pa_apply_cuda.pa_apply(d, dshape, x, emap))
    want = torch.where(ess, x, _plain(d, dshape, x, emap))
    assert got.dtype == dtype and torch.equal(got, want)
    assert pa_apply_cuda.KERNEL.launches == before


def _one_step(tmp_path, monkeypatch, ncuts=(2, 2, 2), shards=None,
              **options):
    """One dt 0.1 step of the Voce case with PA on the CPU, every plain
    PA apply counted; returns (system, that count)."""
    toml = cases.write_voce_case(tmp_path / "case", ncuts, (0.1,),
                                 ngrains=4, assembly="PA", **options)
    calls = []
    plain = ops.apply_pa_gradient_cm

    def counted(*args):
        calls.append(1)
        return plain(*args)

    monkeypatch.setattr(ops, "apply_pa_gradient_cm", counted)
    wd = tmp_path / "run"
    wd.mkdir()
    with torch.inference_mode():
        sim = Simulation(parse_options(toml), workdir=str(wd), device="cpu",
                         shards=shards)
        sim.run(verbose=False)
    assert len(sim.step_stats) == 1
    return sim.system, len(calls)


def test_cpu_index_map_system_never_loads_the_kernels(tmp_path,
                                                      monkeypatch):
    """A mesh-file PA run on the CPU takes the wrapper for every apply
    and its plain path, and never builds, loads or launches the
    kernels."""

    def refuse(*args, **kw):
        raise AssertionError("the kernel library was touched")

    monkeypatch.setattr(pa_apply_cuda.KERNEL, "lib", refuse)
    monkeypatch.setattr(pa_apply_cuda.KERNEL, "build", refuse)
    before = pa_apply_cuda.KERNEL.launches
    sysm, plain_calls = _one_step(tmp_path, monkeypatch, mesh_file=True)
    assert isinstance(sysm.emap, IndexMap) and sysm.pa_kernel
    assert plain_calls > 0
    assert pa_apply_cuda.KERNEL.launches == before


@pytest.mark.parametrize("layout", ["structured", "slab", "replicated"])
def test_other_maps_keep_the_plain_form(layout, tmp_path, monkeypatch):
    """The strided map of a voxel brick, the slab's and the replicated
    map's sharded scatters never reach the wrapper: their PA applies run
    the plain contraction and their own scatter."""

    def refuse(*args, **kw):
        raise AssertionError("pa_apply called off the index map")

    monkeypatch.setattr(pa_apply_cuda, "pa_apply", refuse)
    options = {"structured": dict(ncuts=(2, 2, 2)),
               "slab": dict(ncuts=(2, 2, 4), shards=2, parallel_mode="slab",
                            precond="jacobi"),
               "replicated": dict(ncuts=(2, 2, 2), shards=2, mesh_file=True,
                                  parallel_mode="replicated")}[layout]
    sysm, plain_calls = _one_step(tmp_path, monkeypatch, **options)
    assert not sysm.pa_kernel and sysm.pa and plain_calls > 0
    assert not isinstance(sysm.emap, IndexMap)
    assert isinstance(sysm.emap, StructuredMap) == (layout == "structured")


def test_cuda_source_matches_the_wrapper():
    """The C entry points take the wrapper's ctypes arguments in order,
    the build is keyed by source and flags into the package's build
    directory beside the dogleg library, and the source says which TPU
    kernel it replaces (none) and why it was added."""
    src = pa_apply_cuda.SOURCE.read_text()
    assert "Replaces no TPU kernel" in src and "__global__" in src
    assert pa_apply_cuda.KERNEL.library_path().parent == \
        dogleg_cuda.KERNEL.library_path().parent
    assert re.fullmatch(r"pa_apply_[0-9a-f]{16}\.so",
                        pa_apply_cuda.KERNEL.library_path().name)
    for dtype, name in pa_apply_cuda.ENTRY.items():
        sig = re.search(rf'extern "C" int {name}\(([^)]*)\)', src)
        params = [p.strip() for p in sig.group(1).split(",")]
        assert len(params) == len(pa_apply_cuda.ARGTYPES) == 11
        ctype = {torch.float32: "float", torch.float64: "double"}[dtype]
        assert params[0] == f"const {ctype}* D" and params[6] == f"{ctype}* y"
        assert params[3:5] == ["const long long* conn_t",
                               "const long long* table"]
        assert params[7:] == ["int ne", "int nn", "int valence",
                              "void* stream"]
    assert "use_fast_math" not in " ".join(nvcc.FLAGS)


# -- on the card ------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_kernel_matches_plain_version_at_32(dtype):
    """At the 32^3 mesh-file shapes (32,768 elements, 35,937 nodes) the
    kernel pair against the plain version within TOL of the largest |y|;
    two calls bitwise equal; the node pass bitwise the plain scatter of
    the kernel's own element vectors (the table's order), so a node of
    valence 1 reads its one slot and seven pad slots as zero."""
    _needs_card()
    emap, d, dshape, x, ess = pa_problem((32, 32, 32), dtype, "cuda")
    before = pa_apply_cuda.KERNEL.launches
    y, el_y = pa_apply_cuda.KERNEL.launch(d, dshape, x, emap.conn_t,
                                          emap.table)
    y2 = pa_apply_cuda.pa_apply(d, dshape, x, emap)
    torch.cuda.synchronize()
    assert pa_apply_cuda.KERNEL.launches == before + 2
    want = _plain(d, dshape, x, emap)
    scale = float(want.abs().max())
    assert scale > 0
    assert float((y - want).abs().max()) <= TOL[dtype] * scale
    assert torch.equal(y, y2)
    assert torch.equal(y, emap.scatter_add(el_y))
    assert float((el_y - ops.apply_pa_gradient_cm(
        d, dshape, emap.gather(x))).abs().max()) <= TOL[dtype] * scale
    pad = emap.table >= emap.conn_t.numel()
    lone = torch.nonzero(pad[1:].all(dim=0)).flatten()
    assert lone.numel() == 8  # the brick's corners
    slot = emap.table[0, lone]
    assert torch.equal(y.reshape(3, -1)[:, lone],
                       el_y.reshape(3, -1)[:, slot])


@pytest.mark.cuda
def test_kernel_counts_a_short_solve(tmp_path, monkeypatch):
    """An 8^3 mesh-file PA step on the card: every PA apply is one
    kernel apply (``launches`` and the counter
    ``operator.pa_kernel_applies``), and the Newton iterations equal the
    CPU run's."""
    _needs_card()
    monkeypatch.setenv("EXACONSTIT_TPU_REGIONS", "1")
    toml = cases.write_voce_case(tmp_path / "case", (8, 8, 8), (0.1,),
                                 ngrains=20, mesh_file=True, assembly="PA")
    nr = {}
    for device in ("cpu", "cuda"):
        wd = tmp_path / device
        wd.mkdir()
        with torch.inference_mode():
            sim = Simulation(parse_options(toml), workdir=str(wd),
                             device=device)
            sysm = sim.system
            applies = []
            apply_k = sysm.apply_k

            def counted(k_data, x):
                applies.append(1)
                return apply_k(k_data, x)

            sysm.apply_k = counted
            before = pa_apply_cuda.KERNEL.launches
            sim.run(verbose=False)
            torch.cuda.synchronize()
        launched = pa_apply_cuda.KERNEL.launches - before
        counted_by = sum(sysm.regions.counters.get(
            "operator.pa_kernel_applies", {}).values())
        assert sysm.pa_kernel and applies
        if device == "cuda":
            assert launched == counted_by == len(applies)
        else:
            assert launched == counted_by == 0
        nr[device] = [st["nr_iters"] for st in sim.step_stats]
    assert nr["cuda"] == nr["cpu"]


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take():
    """A wrong dtype, a non-contiguous tensor or a wrong shape raises
    before any launch."""
    _needs_card()
    emap, d, dshape, x, _ = pa_problem((3, 3, 2), torch.float32, "cuda")
    args = dict(d_pa=d, dshape=dshape, x=x, emap=emap)
    before = pa_apply_cuda.KERNEL.launches
    bad = [dict(d_pa=d.double()), dict(x=x.half()),
           dict(x=x.double(), dshape=dshape.double()),
           dict(d_pa=d.transpose(4, 5).contiguous().transpose(4, 5)),
           dict(x=torch.stack([x, x], 1)[:, 0]),
           dict(d_pa=d[..., :-1]), dict(x=x[:-3]),
           dict(dshape=dshape[:, :4])]
    for change in bad:
        with pytest.raises(ValueError):
            pa_apply_cuda.pa_apply(**{**args, **change})
    assert pa_apply_cuda.KERNEL.launches == before
    assert os.path.basename(pa_apply_cuda.KERNEL.library_path()).startswith(
        "pa_apply_")
