"""The plan of the cg_solve kernel (ops/stencil_kernels.cg_plan,
csrc/stencil.cu) on the CPU: which instance a shape gets, bands that cover
the grid once with their halos in the neighbouring bands, shared memory
within what a block may take, and plans that cannot be made raising. The
kernel takes the plan's instance, CTAs and residency and lays out each
band itself; on the card each instance is held to the plain version in
tests/test_torch_cuda_kernels.py."""

import pytest

from conservation_fem_tpu_torch.ops import stencil_kernels as sk

SMS = 132   # the H100's SMs
CAP = sk.SMEM_OPTIN - sk.CG_STATIC_SMEM


def _owners(plan):
    """{node: CTA} of every node a plan's bands cover."""
    return {n: b for b in range(plan["ctas"])
            for n in range(plan["starts"][b], plan["starts"][b + 1])}


# (n1x, n1y, itemsize, instance): Burgers mesh 50 and 100, KPP mesh 64
@pytest.mark.parametrize("n1x,n1y,itemsize,instance", [
    (51, 51, 8, "cluster"), (101, 101, 8, "cluster"), (257, 257, 8, "grid"),
    (51, 51, 4, "cluster"), (101, 101, 4, "cluster"),
    (257, 257, 4, "grid")])
def test_instance_at_the_driven_shapes(n1x, n1y, itemsize, instance):
    """The Burgers reference shapes fit one cluster in f64 (113 B a node:
    51^2 and 101^2 in 8 CTAs); KPP mesh 64 in f64 (~7.5 MB of
    state) fits no cluster and runs the grid instance, resident, one CTA
    per SM, in f32 too (~3.8 MB of state)."""
    plan = sk.cg_plan(n1x, n1y, itemsize, SMS)
    assert plan["instance"] == instance
    assert plan["resident"]
    if instance == "grid":
        assert plan["ctas"] == SMS
    else:
        assert plan["ctas"] <= sk.CG_MAX_CLUSTER
    if itemsize == 8 and n1x <= 101:
        assert sk.cg_plan(n1x, n1y, 8, SMS, instance="cluster",
                          ctas=8)["smem"] <= CAP


SHAPES = [(2, 2), (3, 3), (17, 17), (40, 9), (51, 51), (67, 31),
          (101, 101), (257, 257), (513, 513), (1025, 1025)]


@pytest.mark.parametrize("n1x,n1y", SHAPES)
@pytest.mark.parametrize("itemsize", [4, 8])
def test_bands_cover_the_grid_once_and_hold_their_halos(n1x, n1y, itemsize):
    """Every node in one band; every band at least n1y + 1 nodes (one band
    alone: any), so the n1y + 1 nodes below a band lie in the band before
    it and those above in the band after it; the shared memory within the
    cap; a cluster of at most 16 CTAs, a grid of at most one CTA per SM
    (two where the band is in device memory, 256 in all)."""
    plan = sk.cg_plan(n1x, n1y, itemsize, SMS)
    n, h, C = n1x * n1y, n1y + 1, plan["ctas"]
    owners = _owners(plan)
    assert sorted(owners) == list(range(n))
    sizes = [plan["starts"][b + 1] - plan["starts"][b] for b in range(C)]
    assert max(sizes) == plan["cap"] and max(sizes) - min(sizes) <= 1
    if C > 1:
        assert min(sizes) >= h
    for b in range(C):
        lo, hi = plan["starts"][b], plan["starts"][b + 1]
        for m in list(range(lo - h, lo)) + list(range(hi, hi + h)):
            if 0 <= m < n:
                assert owners[m] == (b - 1 if m < lo else b + 1)
    assert plan["smem"] <= CAP
    assert C <= (sk.CG_MAX_CLUSTER if plan["instance"] == "cluster"
                 else SMS if plan["resident"] else min(2 * SMS, 256))
    assert plan["halo"] == h


@pytest.mark.parametrize("itemsize", [4, 8])
def test_shared_memory_mirrors_the_kernel_layout(itemsize):
    """cg_smem counts what csrc/stencil.cu CgLayout lays out: 13 arrays of
    the band in a cluster CTA (7 planes, dinv, x, Ap, two p, r), 12 in a
    resident grid CTA, none in one that is not; resident, the operand at
    the band and its 2 (n1y + 1) halo nodes; the halo's dinv; the cluster's
    2 buffers of 16 CTAs' 4 partials; a mask byte a node of the band
    (resident) and of the halo."""
    cap, n1y = 100, 9
    h = n1y + 1
    assert sk.cg_smem(cap, n1y, itemsize, True, True) == (
        (14 * cap + 4 * h + 2 * 16 * 4) * itemsize + cap + 2 * h)
    assert sk.cg_smem(cap, n1y, itemsize, True, False) == (
        (13 * cap + 4 * h) * itemsize + cap + 2 * h)
    assert sk.cg_smem(cap, n1y, itemsize, False, False) == (
        2 * h * itemsize + 2 * h)


@pytest.mark.parametrize("ctas", [1, 2, 8, 16])
def test_forced_cluster_sizes(ctas):
    """The cluster sizes the card tests force, on a thin grid whose bands
    are uneven and, at 16 CTAs, barely longer than a halo."""
    plan = sk.cg_plan(40, 9, 8, SMS, instance="cluster", ctas=ctas)
    assert plan["instance"] == "cluster" and plan["ctas"] == ctas
    sizes = {plan["starts"][b + 1] - plan["starts"][b] for b in range(ctas)}
    assert min(sizes) >= 10 or ctas == 1
    assert plan["smem"] == sk.cg_smem(plan["cap"], 9, 8, True, True)


def test_grid_bands_in_device_memory_take_two_ctas_an_sm():
    """KPP mesh 256 in f64 does not fit shared memory on 132 bands: its
    bands go to device memory, 256 of them (two an SM)."""
    plan = sk.cg_plan(1025, 1025, 8, SMS)
    assert plan["instance"] == "grid" and not plan["resident"]
    assert plan["ctas"] == 256
    with pytest.raises(ValueError, match="shared memory"):
        sk.cg_plan(1025, 1025, 8, SMS, instance="grid", ctas=132,
                   resident=True)


@pytest.mark.parametrize("resident", [True, False])
def test_forced_grid(resident):
    """The grid instance forced on a small grid, its band's arrays in
    shared memory or in device memory."""
    plan = sk.cg_plan(40, 9, 8, SMS, instance="grid", ctas=36,
                      resident=resident)
    assert plan["instance"] == "grid" and plan["ctas"] == 36
    assert plan["resident"] is resident
    assert plan["cap"] == 10


def test_plans_that_cannot_be_made_raise():
    """A cap too small for even the grid's halo, a cluster too large for
    its state or the card, and bands shorter than a halo all raise."""
    with pytest.raises(ValueError, match="shared memory"):
        sk.cg_plan(257, 257, 8, SMS, smem_cap=1000)
    with pytest.raises(ValueError, match="shared memory"):
        sk.cg_plan(257, 257, 8, SMS, instance="cluster", ctas=16)
    with pytest.raises(ValueError, match="at most 16"):
        sk.cg_plan(101, 101, 8, SMS, instance="cluster", ctas=32)
    with pytest.raises(ValueError, match="bands"):
        sk.cg_plan(12, 9, 8, SMS, instance="cluster", ctas=12)
    with pytest.raises(ValueError, match="one per SM"):
        sk.cg_plan(257, 257, 8, SMS, instance="grid", ctas=200)
    with pytest.raises(ValueError, match="two per SM"):
        sk.cg_plan(1025, 1025, 8, SMS, instance="grid", ctas=300)
    with pytest.raises(ValueError, match="instance"):
        sk.cg_plan(51, 51, 8, SMS, instance="tiles")
    # a card whose clusters hold fewer CTAs: mesh 100 in f64 needs 6
    assert sk.cg_plan(101, 101, 8, SMS, cluster_max=5)["instance"] == "grid"
    assert sk.cg_plan(101, 101, 8, SMS, cluster_max=6)["instance"] == (
        "cluster")
