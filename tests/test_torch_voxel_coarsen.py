"""PyTorch port against the JAX package: ``utils/voxel_coarsen.py``.

The port keeps its own copy of the reference's host tool (blocked
majority-vote coarsening of ExaCA grain ids, through
``native/libvoxel_coarsen.so`` or its numpy fallback): both routes give
the reference's output bitwise on seeded grids, and the file entry and
the size check behave as the reference's."""

import numpy as np
import pytest

from exaconstit_tpu.utils import voxel_coarsen as J_VC
from exaconstit_tpu_torch.utils import voxel_coarsen as T_VC


# the tool's block indexing (the reference's, after the Rust original)
# strides both in-plane axes by bx / cs, so it takes square x-y sections
BOXES = [((8, 8, 8), 2), ((12, 12, 4), 4), ((6, 6, 9), 3)]


def grains(box, ngrains, seed):
    """Seeded grain ids with some spatial coherence: a blocky field of
    random ids plus scattered noise, so the majority vote has ties and
    clear winners alike."""
    rng = np.random.default_rng(seed)
    bx, by, bz = box
    base = rng.integers(0, ngrains, size=(-(-bz // 2), -(-by // 2),
                                          -(-bx // 2)))
    g = np.repeat(np.repeat(np.repeat(base, 2, 0), 2, 1), 2,
                  2)[:bz, :by, :bx]
    noise = rng.uniform(size=g.shape) < 0.3
    g = np.where(noise, rng.integers(0, ngrains, size=g.shape), g)
    return g.reshape(-1).astype(np.int32)


@pytest.fixture
def no_library(monkeypatch):
    """Both packages on their numpy fallback."""
    for mod in (J_VC, T_VC):
        monkeypatch.setattr(mod, "_LIB", None)
        monkeypatch.setattr(mod, "_LIB_PATH", "/nonexistent/libvc.so")


@pytest.mark.parametrize("box,cs", BOXES)
def test_library_matches_reference(box, cs):
    """Through the shared library (present in ``native/``)."""
    assert T_VC._load() is not None
    data = grains(box, 7, seed=sum(box) + cs)
    got = T_VC.voxel_coarsen(data, box, cs, seed=3)
    want = J_VC.voxel_coarsen(data, box, cs, seed=3)
    assert got.dtype == np.int32 and got.size == data.size // cs ** 3
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("box,cs", BOXES)
def test_fallback_matches_reference(box, cs, no_library):
    assert T_VC._load() is None
    data = grains(box, 7, seed=sum(box) + cs)
    got = T_VC.voxel_coarsen(data, box, cs, seed=3)
    np.testing.assert_array_equal(got, J_VC.voxel_coarsen(data, box, cs,
                                                           seed=3))
    # a block of one id coarsens to that id
    one = np.full(box[0] * box[1] * box[2], 5, dtype=np.int32)
    assert (T_VC.voxel_coarsen(one, box, cs) == 5).all()


def test_file_entry_and_size_check(tmp_path):
    """The ExaCA file entry (two header lines, x, y, z, grain id) and the
    refusal of a box the block size does not divide, as the reference."""
    box = (4, 4, 6)
    data = grains(box, 5, seed=11)
    bx, by, bz = box
    k, j, i = np.meshgrid(np.arange(bz), np.arange(by), np.arange(bx),
                          indexing="ij")
    rows = np.stack([i.ravel(), j.ravel(), k.ravel(), data], axis=1)
    path = tmp_path / "exaca.csv"
    with open(path, "w") as f:
        f.write("header\nx,y,z,gid\n")
        np.savetxt(f, rows, fmt="%d", delimiter=",")
    b_t, g_t = T_VC.voxel_coarsen_file(str(path), 2)
    b_j, g_j = J_VC.voxel_coarsen_file(str(path), 2)
    assert b_t == b_j == box
    np.testing.assert_array_equal(g_t, g_j)
    with pytest.raises(ValueError, match="not divisible"):
        T_VC.voxel_coarsen(data, box, 3)
