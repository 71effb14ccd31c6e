"""The port's node partitioner (conservation_fem_tpu_torch/parallel/
partition.py) against the JAX package's (conservation_fem_tpu/parallel/
partition.py): every field of Partition and CellPartition exactly equal,
values, dtypes and shapes, pads included, on four meshes:

  * disk_mesh(1/8) on 8 blocks, RCM-reordered (the JAX package's
    test_partition_structure);
  * rectangle_mesh((0,0),(1,1),nx=9) on 8 blocks as it is (the mesh of the
    JAX package's multichip path 2);
  * irregular_mesh((-2,-2),(2,2),12,seed=1) on 3 blocks as it is;
  * rectangle_mesh((0,0),(1,1),nx=4) on 1 block: no halo, no shared row,
    the width-1 pads.

The JAX partitioner is numpy only: nothing is compiled here.
"""

import numpy as np
import pytest
import torch

from conservation_fem_tpu.ops import mesh as jmesh
from conservation_fem_tpu.parallel import partition as jpart
from conservation_fem_tpu_torch.ops import mesh as tmesh
from conservation_fem_tpu_torch.parallel import partition as tpart

CASES = {
    "disk_8_reordered": (lambda m: m.disk_mesh(1 / 8), 8, True),
    "rect9_8": (lambda m: m.rectangle_mesh((0, 0), (1, 1), nx=9), 8, False),
    "irregular12_3": (lambda m: m.irregular_mesh((-2, -2), (2, 2), 12,
                                                 seed=1), 3, False),
    "rect4_1_no_halo": (lambda m: m.rectangle_mesh((0, 0), (1, 1), nx=4), 1,
                        False),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(name):
    make, n_dev, reorder = CASES[name]
    return (jpart.build_partition(make(jmesh), n_dev, reorder=reorder),
            tpart.build_partition(make(tmesh), n_dev, reorder=reorder))


def _assert_fields_equal(ref, got):
    assert type(got)._fields == type(ref)._fields
    for field in ref._fields:
        a, b = getattr(ref, field), getattr(got, field)
        if field == "mesh":
            assert np.array_equal(a.points, b.points)
            assert np.array_equal(a.cells, b.cells)
        elif isinstance(a, np.ndarray):
            assert (b.dtype, b.shape) == (a.dtype, a.shape), field
            assert np.array_equal(a, b), field
        else:
            assert type(b) is type(a) and b == a, field


@pytest.mark.parametrize("name", sorted(CASES))
def test_partition_equals_jax(name):
    ref, got = _both(name)
    _assert_fields_equal(ref, got)
    # every halo slot reads a published slot; the owned rows tile the mesh
    assert got.halo_src.max() < got.n_dev * got.shared_size
    rows = got.global_rows[got.global_rows >= 0]
    assert sorted(rows.tolist()) == list(range(got.mesh.n_nodes))
    if name == "rect4_1_no_halo":
        assert (got.halo_size, got.shared_size) == (1, 1)


@pytest.mark.parametrize("name", sorted(CASES))
def test_cell_partition_equals_jax(name):
    ref, got = _both(name)
    cref = jpart.build_cell_partition(ref)
    cgot = tpart.build_cell_partition(got)
    _assert_fields_equal(cref, cgot)
    assert cgot.cell_valid.sum() == got.mesh.n_cells
    if name == "rect4_1_no_halo":
        assert cgot.rev_src.shape == (1, 1, 1) and not cgot.rev_mask.any()


@pytest.mark.parametrize("name", ["disk_8_reordered", "irregular12_3"])
def test_mesh_cell_slots_are_the_first_masked_match(name):
    """The port reads mesh.cell_slots where the JAX partitioner searches
    each cell pair's row for the first masked match of its column: the
    same slot for every pair of every cell."""
    make, _, reorder = CASES[name]
    m = make(tmesh)
    if reorder:
        m = tmesh.reorder_mesh(m, tmesh.rcm_permutation(m))
    cols, mask = m.patch_cols, m.patch_mask
    cells = m.cells.astype(np.int64)
    rows = np.repeat(cells, 3, axis=1).reshape(-1, 3, 3)
    want = np.tile(cells, (1, 3)).reshape(-1, 3, 3)
    hit = (cols[rows] == want[..., None]) & mask[rows]
    assert hit.any(-1).all()
    assert np.array_equal(np.argmax(hit, axis=-1), m.cell_slots)


def test_blocks_past_the_mesh():
    """More blocks than a block count the JAX partitioner accepts: the
    blocks past the mesh hold pad rows only (global_rows -1) and no
    cells; the partition still tiles the mesh."""
    m = tmesh.rectangle_mesh((0, 0), (1, 1), nx=2)        # 9 nodes
    part = tpart.build_partition(m, 8, reorder=False)
    assert part.n_own == 2 and (part.global_rows[5:] == -1).all()
    cp = tpart.build_cell_partition(part)
    assert not cp.cell_valid[5:].any()
    assert cp.cell_valid.sum() == m.n_cells
