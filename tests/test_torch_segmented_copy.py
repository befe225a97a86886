"""Differential tests of the port's segmented-copy layer against the JAX
reference: identical descriptor packing and plan caching, and plain
scatter/gather versions byte-identical to the reference's ``'ref'`` and
``'pallas'`` (interpret mode) plans.  The descriptor tables are
``test_torch_kernels``'s, where the CUDA kernels meet the same tables
on a card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.kernels import segmented_copy as rsc

from repro_torch.kernels import segmented_copy as tsc

from test_torch_kernels import ARENA, CASES, _tables


def _ref_impls(desc, seg):
    """The reference's own impl choice for a table: pallas where its
    window precondition holds (``CommEngine._pick_impl``)."""
    out = ["ref"]
    if rsc.pallas_ok(desc, seg, ARENA[1]):
        out.append("pallas")
    return out


# ---------------------------------------------------------- host layer --

@pytest.mark.parametrize("name", CASES)
def test_pack_descriptors_identical(name):
    _, pays, (rows, offs, lens, strides, counts), _ = _tables(name)
    r = rsc.pack_descriptors(rows, offs, lens, pays, strides=strides,
                             counts=counts)
    t = tsc.pack_descriptors(rows, offs, lens, pays, strides=strides,
                             counts=counts)
    np.testing.assert_array_equal(t[0], r[0])
    np.testing.assert_array_equal(t[1], r[1])
    assert t[2] == r[2] and t[0].dtype == np.int32
    assert tsc.strided_buckets(t[0], t[2]) == rsc.strided_buckets(r[0], r[2])
    # the engine stages payloads itself: densely in run order, in a flat
    # buffer whose plan-key length is the reference's bucketed one
    assert tsc.flat_bucket(t[0].shape[0], t[2]) == r[1].shape[0]
    used = np.concatenate(pays)
    np.testing.assert_array_equal(r[1][:used.size], used)
    assert not r[1][used.size:].any()
    g = tsc.pack_descriptors(rows, offs, lens, strides=strides,
                             counts=counts)
    assert g[1] is None
    np.testing.assert_array_equal(g[0], t[0])


@settings(deadline=None, max_examples=30)
@given(st.lists(st.tuples(st.integers(0, 7), st.integers(0, 4000),
                          st.integers(0, 300), st.integers(0, 500),
                          st.integers(1, 9)), min_size=1, max_size=40))
def test_pack_descriptors_property(ops):
    rows = [o[0] for o in ops]
    offs = [o[1] for o in ops]
    lens = [o[2] for o in ops]
    strides = [o[3] for o in ops]
    counts = [o[4] for o in ops]
    pays = [np.full(l * c, i % 251, np.uint8)
            for i, (l, c) in enumerate(zip(lens, counts))]
    r = rsc.pack_descriptors(rows, offs, lens, pays, strides, counts)
    t = tsc.pack_descriptors(rows, offs, lens, pays, strides, counts)
    np.testing.assert_array_equal(t[0], r[0])
    np.testing.assert_array_equal(t[1], r[1])
    assert t[2] == r[2]
    assert tsc.flat_bucket(t[0].shape[0], t[2]) == r[1].shape[0]
    used = np.concatenate(pays)
    np.testing.assert_array_equal(r[1][:used.size], used)


@pytest.mark.parametrize("n,floor", [(0, 1), (1, 1), (5, 1), (8, 1),
                                     (9, 1), (3, 16), (17, 16), (3, 4)])
def test_bucket_pow2_identical(n, floor):
    assert tsc.bucket_pow2(n, floor) == rsc.bucket_pow2(n, floor)


@pytest.mark.parametrize("shape", [(4, 1 << 20), (16, 48 << 20),
                                   (1, (1 << 30) - 1), (2, 1 << 29),
                                   (16, 64 << 20)])
def test_flat_addressable_cap_identical(shape):
    try:
        rsc.check_flat_addressable(shape)
    except NotImplementedError:
        with pytest.raises(NotImplementedError):
            tsc.check_flat_addressable(shape)
    else:
        tsc.check_flat_addressable(shape)


def test_plan_cache_counts_like_reference():
    """The same plan requests give the same hit/miss pattern."""
    reqs = [("s", 4, 16, 80, False), ("s", 4, 16, 80, False),
            ("s", 4, 16, 80, True), ("g", 4, 16), ("g", 4, 16),
            ("s", 8, 32, 288, False), ("g", 8, 16), ("s", 4, 16, 80, True)]
    rsc.clear_plan_cache()
    tsc.clear_plan_cache()
    r_hits, t_hits = [], []
    for q in reqs:
        if q[0] == "s":
            r_hits.append(rsc.scatter_plan(ARENA, q[1], q[2], q[3],
                                           ordered=q[4])[1])
            t_hits.append(tsc.scatter_plan(ARENA, q[1], q[2], q[3],
                                           ordered=q[4])[1])
        else:
            r_hits.append(rsc.gather_plan(ARENA, q[1], q[2])[1])
            t_hits.append(tsc.gather_plan(ARENA, q[1], q[2])[1])
    assert t_hits == r_hits
    assert tsc.plan_cache_stats()["size"] == rsc.plan_cache_stats()["size"]
    tsc.clear_plan_cache()
    assert tsc.plan_cache_stats()["size"] == 0


# ------------------------------------------- plain versions vs reference --

def _ref_scatter(arena, desc, flat, seg, ordered, impl):
    kw = {}
    if impl == "pallas":
        kw = dict(zip(("sseg", "cb"), rsc.strided_buckets(desc, seg)))
    fn, _ = rsc.scatter_plan(arena.shape, desc.shape[0], seg, flat.shape[0],
                             ordered=ordered, impl=impl, donate=False, **kw)
    return np.asarray(fn(jnp.asarray(arena), jnp.asarray(desc),
                         jnp.asarray(flat)))


def _ref_gather(arena, desc, seg, impl):
    kw = {}
    if impl == "pallas":
        kw = dict(zip(("sseg", "cb"), rsc.strided_buckets(desc, seg)))
    fn, _ = rsc.gather_plan(arena.shape, desc.shape[0], seg, impl=impl, **kw)
    return np.asarray(fn(jnp.asarray(arena), jnp.asarray(desc)))


@pytest.mark.parametrize("name", CASES)
def test_plain_scatter_matches_reference(name):
    arena, pays, geo, ordered = _tables(name, seed=11)
    desc, flat, seg = tsc.pack_descriptors(*geo[:3], pays, strides=geo[3],
                                           counts=geo[4])
    fn, _ = tsc.scatter_plan(ARENA, desc.shape[0], seg, flat.shape[0],
                             ordered=ordered, impl="ref")
    port = torch.from_numpy(arena.copy())
    out = fn(port, torch.from_numpy(desc), torch.from_numpy(flat))
    assert out is port                                  # in place
    for impl in _ref_impls(desc, seg):
        np.testing.assert_array_equal(
            port.numpy(), _ref_scatter(arena, desc, flat, seg, ordered, impl),
            err_msg=f"{name} vs reference impl={impl}")
    # the order-free kernel on a disjoint table equals the ordered one
    if not ordered:
        other = torch.from_numpy(arena.copy())
        tsc.scatter_ref(other, torch.from_numpy(desc),
                        torch.from_numpy(flat), seg=seg, ordered=True)
        assert torch.equal(other, port)


@pytest.mark.parametrize("name", CASES)
def test_plain_gather_matches_reference(name):
    arena, _, geo, _ = _tables(name, seed=12)
    desc, _, seg = tsc.pack_descriptors(*geo[:3], strides=geo[3],
                                        counts=geo[4])
    fn, _ = tsc.gather_plan(ARENA, desc.shape[0], seg, impl="ref")
    out = fn(torch.from_numpy(arena.copy()), torch.from_numpy(desc)).numpy()
    assert out.shape == (desc.shape[0], seg) and out.dtype == np.uint8
    np.testing.assert_array_equal(out, _ref_gather(arena, desc, seg, "ref"))
    if "pallas" in _ref_impls(desc, seg):
        pal = _ref_gather(arena, desc, seg, "pallas")
        totals = desc[:, tsc.LEN] * desc[:, tsc.COUNT]
        for i, n in enumerate(totals):      # pallas: first nbytes only
            np.testing.assert_array_equal(out[i, :n], pal[i, :n])


@settings(deadline=None, max_examples=20)
@given(st.lists(st.tuples(st.integers(0, 3), st.integers(0, 480),
                          st.integers(0, 16)), min_size=1, max_size=4),
       st.booleans(), st.integers(0, 2**31 - 1))
def test_plain_scatter_gather_property(ops, ordered, seed):
    """Random small tables (one plan shape: kb=4, seg=16) against the
    reference's ref plans."""
    rng = np.random.default_rng(seed)
    rows = [o[0] for o in ops]
    offs = [o[1] for o in ops]
    lens = [o[2] for o in ops]
    pays = [rng.integers(0, 256, n, dtype=np.uint8) for n in lens]
    arena = rng.integers(0, 256, ARENA, dtype=np.uint8)
    desc, flat, seg = tsc.pack_descriptors(rows, offs, lens, pays)
    port = torch.from_numpy(arena.copy())
    tsc.scatter_ref(port, torch.from_numpy(desc), torch.from_numpy(flat),
                    seg=seg, ordered=ordered)
    np.testing.assert_array_equal(
        port.numpy(), _ref_scatter(arena, desc, flat, seg, ordered, "ref"))
    got = tsc.gather_ref(port, torch.from_numpy(desc), seg=seg).numpy()
    np.testing.assert_array_equal(
        got, _ref_gather(port.numpy(), desc, seg, "ref"))


# ------------------------------------------------------------- guards --

def test_resolve_impl():
    cpu = torch.zeros(ARENA, dtype=torch.uint8)
    assert tsc.resolve_impl("auto", cpu) == "ref"
    assert tsc.resolve_impl("ref", cpu) == "ref"
    with pytest.raises(ValueError, match="CUDA arena"):
        tsc.resolve_impl("cuda", cpu)
    with pytest.raises(ValueError, match="unknown impl"):
        tsc.resolve_impl("pallas", cpu)


def test_cuda_wrappers_refuse_cpu_tensors():
    arena = torch.zeros(ARENA, dtype=torch.uint8)
    desc, flat, seg = tsc.pack_descriptors([0], [0], [4],
                                           [np.ones(4, np.uint8)])
    before = dict(tsc.launch_counts)
    with pytest.raises(ValueError, match="CUDA arena"):
        tsc.scatter_cuda(arena, torch.from_numpy(desc),
                         torch.from_numpy(flat), seg=seg, ordered=False)
    with pytest.raises(ValueError, match="CUDA arena"):
        tsc.gather_cuda(arena, torch.from_numpy(desc), seg=seg)
    assert tsc.launch_counts == before


def test_plain_plans_on_cpu_are_not_counted_as_cuda_work():
    arena = torch.zeros(ARENA, dtype=torch.uint8)
    desc, flat, seg = tsc.pack_descriptors([0], [0], [4],
                                           [np.ones(4, np.uint8)])
    before = dict(tsc.launch_counts)
    fn, _ = tsc.scatter_plan(ARENA, desc.shape[0], seg, flat.shape[0],
                             ordered=False, impl="ref")
    fn(arena, torch.from_numpy(desc), torch.from_numpy(flat))
    assert tsc.launch_counts == before
    assert arena[0, :4].tolist() == [1, 1, 1, 1]
