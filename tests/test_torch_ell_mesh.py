"""The port's unstructured mesh structures against the JAX package's,
exactly: geometry, boundary, the ELL patches, cell slots and scatter
orderings of a rectangle, irregular_mesh(nx=8, seed=1) and disk_mesh(1/8),
before and after the RCM reordering; the RCM permutation itself; the
device bundle (MeshArrays) and its lean guard; load_h5_mesh; and the
fingerprint of the smallest anchored irregular mesh."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conservation_fem_tpu.ops import mesh as jmesh
from conservation_fem_tpu_torch.ops import mesh as tmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("points", "cells", "boundary_mask", "area", "grads", "h_cell",
          "patch_cols", "patch_mask", "diag_slot", "cell_slots", "mat_perm",
          "mat_segs", "vec_perm", "vec_segs")
MESHES = {
    "rectangle": lambda m: m.rectangle_mesh((-2, -2), (2, 2), nx=6, ny=5),
    "irregular": lambda m: m.irregular_mesh((-2, -2), (2, 2), nx=8, seed=1),
    "disk": lambda m: m.disk_mesh(1 / 8),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the test run shares the cores among several
    pytest worker processes, where torch's thread pool only
    oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_same(got, ref):
    for f in FIELDS:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(ref, f))
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("name", sorted(MESHES))
@pytest.mark.parametrize("rcm", [False, True])
def test_mesh_structures_match_jax_exactly(name, rcm):
    ref, got = MESHES[name](jmesh), MESHES[name](tmesh)
    if rcm:
        ref = jmesh.reorder_mesh(ref, jmesh.rcm_permutation(ref))
        got = tmesh.reorder_mesh(got, tmesh.rcm_permutation(got))
    _assert_same(got, ref)
    assert got.max_patch == ref.max_patch
    np.testing.assert_array_equal(got.boundary_nodes, ref.boundary_nodes)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_rcm_permutation_matches_jax(name):
    """rcm_permutation is the JAX package's (its native preprocessor's
    rule); rcm_from_connectivity is scipy's, as there (on disk_mesh(1/8)
    the two orders differ, so both are held)."""
    ref, got = MESHES[name](jmesh), MESHES[name](tmesh)
    np.testing.assert_array_equal(tmesh.rcm_permutation(got),
                                  jmesh.rcm_permutation(ref))
    np.testing.assert_array_equal(
        tmesh.rcm_from_connectivity(got.n_nodes, got.cells),
        jmesh.rcm_from_connectivity(ref.n_nodes, ref.cells))


def test_device_arrays_match_jax():
    ref = MESHES["irregular"](jmesh).device_arrays(jnp.float64)
    host = MESHES["irregular"](tmesh)
    got = host.device_arrays(torch.float64, "cpu")
    for f in ref._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f)
    assert got.points.dtype == torch.float64
    assert got.patch_cols.dtype == torch.int64
    f32 = host.device_arrays(torch.float32, "cpu")
    assert f32.area.dtype == torch.float32
    n, K = host.patch_cols.shape
    assert got.mat_lens.shape == (n * K,) and int(got.mat_lens.sum()) == \
        9 * host.n_cells
    assert int(got.vec_lens.sum()) == 3 * host.n_cells


def test_lean_mesh_ships_placeholders():
    """rectangle_mesh_lean has no ELL structure: its device bundle holds
    1-element placeholders for the cell arrays and the patches, as the
    JAX package's does."""
    ref = jmesh.rectangle_mesh_lean((0, 0), (1, 1), nx=6).device_arrays(
        jnp.float64)
    got = tmesh.rectangle_mesh_lean((0, 0), (1, 1), nx=6).device_arrays(
        torch.float64, "cpu")
    for f in ("cells", "patch_cols", "area", "grads", "h_cell", "mat_perm",
              "vec_segs"):
        assert tuple(getattr(got, f).shape) == getattr(ref, f).shape, f
    np.testing.assert_array_equal(got.points.numpy(), np.asarray(ref.points))


def test_load_h5_mesh_matches_jax():
    pytest.importorskip("h5py")
    path = os.path.join(REPO, "golden", "kpp_rv8.h5")
    _assert_same(tmesh.load_h5_mesh(path), jmesh.load_h5_mesh(path))


def test_anchor_mesh_fingerprint():
    """chip_smoke.py checks the five anchored meshes (irregular_mesh nx
    140 ... 640, seed 1, RCM order) against the fingerprints of the JAX
    package's builds; nx 140 here, built by both packages."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    ref = jmesh.irregular_mesh((-2, -2), (2, 2), nx=140, seed=1)
    ref = jmesh.reorder_mesh(ref, jmesh.rcm_permutation(ref))
    got = tmesh.irregular_mesh((-2, -2), (2, 2), nx=140, seed=1)
    got = tmesh.reorder_mesh(got, tmesh.rcm_permutation(got))
    assert tmesh.mesh_fingerprint(ref) == cs.IRR_FINGERPRINTS[140]
    assert tmesh.mesh_fingerprint(got) == cs.IRR_FINGERPRINTS[140]
