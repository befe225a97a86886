"""The host-plane collectives of the torch port (``dart_bcast``,
``dart_gather[_typed]``, ``dart_scatter[_typed]``, ``dart_allreduce``,
``dart_reduce``, ``dart_barrier``) against the JAX reference on CPU
heaps: the same arenas and results, and the same engine counters.
Integer data and integer-valued floats must agree exactly; random
float32 allreduces may reduce in another order than XLA and agree to
``rtol=1e-6``.  Pointers are plain (no ``FLAG_SHM``): the reference
serves shm pointers through its shm plane, which the port does not have
yet (ROADMAP queue 3)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.core import collectives as rcoll
from repro.kernels import segmented_copy as rsc

import repro_torch.core as T
from repro_torch.core import collectives as tcoll
from repro_torch.kernels import segmented_copy as tsc

N_UNITS = 4
POOL = 2048
OPS = ("sum", "prod", "min", "max")
COUNTERS = ("dispatch_count", "ops_enqueued", "ops_coalesced",
            "compile_count", "plan_cache_hits")


@pytest.fixture()
def pair():
    rsc.clear_plan_cache()
    tsc.clear_plan_cache()
    cfg = dict(non_collective_pool_bytes=POOL, team_pool_bytes=POOL)
    rc = R.dart_init(n_units=N_UNITS, config=R.DartConfig(**cfg))
    rc.engine.impl = "ref"
    tc = T.dart_init(n_units=N_UNITS, config=T.DartConfig(**cfg),
                     device="cpu")
    yield rc, tc
    R.dart_exit(rc)
    T.dart_exit(tc)


def _np(v):
    if not isinstance(v, torch.Tensor):
        return np.asarray(v)
    if v.dtype == torch.bfloat16:
        return v.contiguous().view(torch.int16).numpy().view(
            np.dtype(jnp.bfloat16))
    return v.numpy()


def _same_state(rc, tc):
    for pid, a in rc.state.items():
        np.testing.assert_array_equal(tc.state[pid].numpy(), np.asarray(a),
                                      err_msg=f"pool {pid}")
    assert (tuple(getattr(tc.engine, c) for c in COUNTERS)
            == tuple(getattr(rc.engine, c) for c in COUNTERS))


def _both(pair, fn):
    rc, tc = pair
    r, t = fn(R, rc), fn(T, tc)
    _same_state(rc, tc)
    return r, t


def test_bcast_and_allreduce(pair):
    """``test_core_runtime_onesided.test_bcast_and_allreduce``, on both."""
    def fn(pkg, ctx):
        g = pkg.dart_team_memalloc_aligned(ctx, pkg.DART_TEAM_ALL, 128)
        for u in range(N_UNITS):
            pkg.dart_put_blocking(ctx, g.setunit(u),
                                  np.full((4,), float(u + 1), np.float32))
        red = pkg.dart_allreduce(ctx, g, (4,), np.float32, op="sum")
        outs = [pkg.dart_get_blocking(ctx, g.setunit(u), (4,), np.float32)
                for u in range(N_UNITS)]
        pkg.dart_put_blocking(ctx, g.setunit(2),
                              np.full((4,), 42.0, np.float32))
        h = pkg.dart_bcast(ctx, g.setunit(2), 16)
        h.wait()
        outs += [pkg.dart_get_blocking(ctx, g.setunit(u), (4,), np.float32)
                 for u in range(N_UNITS)]
        pkg.dart_barrier(ctx)
        return [_np(red)] + [_np(o) for o in outs]
    r, t = _both(pair, fn)
    assert (t[0] == 10.0).all() and all((o == 10.0).all() for o in t[1:5])
    assert all((o == 42.0).all() for o in t[5:])
    for a, b in zip(r, t):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_allreduce_identity_padding_all_ops(pair, dtype):
    """min/max/prod need true identities in the padded lanes: negative
    values and a non-power-of-two element count."""
    vals = {0: [-5, 2, 7], 1: [4, -9, 1], 2: [0, 3, -2], 3: [8, 8, 8]}
    expect = {"sum": [7, 4, 14], "prod": [0, -432, -112],
              "min": [-5, -9, -2], "max": [8, 8, 8]}

    def fn(pkg, ctx):
        g = pkg.dart_team_memalloc_aligned(ctx, pkg.DART_TEAM_ALL, 256)
        out = []
        for op in OPS:
            for u, v in vals.items():
                pkg.dart_put_blocking(ctx, g.setunit(u), np.asarray(v, dtype))
            out.append(_np(pkg.dart_allreduce(ctx, g, (3,), dtype, op)))
            out += [_np(pkg.dart_get_blocking(ctx, g.setunit(u), (3,), dtype))
                    for u in range(N_UNITS)]
        return out
    r, t = _both(pair, fn)
    for i, op in enumerate(OPS):
        for got in t[5 * i:5 * i + 5]:
            np.testing.assert_array_equal(got, expect[op])
    for a, b in zip(r, t):
        assert a.tobytes() == b.tobytes()


def test_reduce_lands_on_root_only(pair):
    def fn(pkg, ctx):
        g = pkg.dart_team_memalloc_aligned(ctx, pkg.DART_TEAM_ALL, 256)
        for u in range(N_UNITS):
            pkg.dart_put_blocking(ctx, g.setunit(u),
                                  np.full((5,), u + 1, np.int32))
        red = pkg.dart_reduce(ctx, g, (5,), np.int32, "sum", root=2)
        return [_np(red)] + [
            _np(pkg.dart_get_blocking(ctx, g.setunit(u), (5,), np.int32))
            for u in range(N_UNITS)]
    r, t = _both(pair, fn)
    np.testing.assert_array_equal(t[0], [10] * 5)
    for u in range(N_UNITS):
        np.testing.assert_array_equal(t[1 + u], [10 if u == 2 else u + 1] * 5)


def test_allreduce_does_not_touch_adjacent_bytes(pair):
    def fn(pkg, ctx):
        g = pkg.dart_team_memalloc_aligned(ctx, pkg.DART_TEAM_ALL, 256)
        for u in range(N_UNITS):
            pkg.dart_put_blocking(ctx, g.setunit(u),
                                  np.full((3,), u, np.int32))
            pkg.dart_put_blocking(ctx, g.setunit(u) + 12,
                                  np.full((4,), 0xEE, np.uint8))
        pkg.dart_allreduce(ctx, g, (3,), np.int32, "sum")
        return [_np(pkg.dart_get_blocking(ctx, g.setunit(u) + 12, (4,),
                                          np.uint8))
                for u in range(N_UNITS)]
    _, t = _both(pair, fn)
    assert all(x.tolist() == [0xEE] * 4 for x in t)


def test_allreduce_sees_queued_puts(pair):
    def fn(pkg, ctx):
        g = pkg.dart_team_memalloc_aligned(ctx, pkg.DART_TEAM_ALL, 128)
        for u in range(N_UNITS):
            pkg.dart_put(ctx, g.setunit(u), np.full((2,), u + 1, np.float32))
        return _np(pkg.dart_allreduce(ctx, g, (2,), np.float32, "sum"))
    r, t = _both(pair, fn)
    np.testing.assert_array_equal(t, [10.0, 10.0])
    np.testing.assert_array_equal(t, r)


def test_scalar_allreduce(pair):
    def fn(pkg, ctx):
        g = pkg.dart_team_memalloc_aligned(ctx, pkg.DART_TEAM_ALL, 64)
        for u in range(N_UNITS):
            pkg.dart_put_blocking(ctx, g.setunit(u),
                                  np.asarray(float(u + 1), np.float32))
        return _np(pkg.dart_allreduce(ctx, g, (), np.float32, "max"))
    r, t = _both(pair, fn)
    assert t.shape == () and float(t) == 4.0 == float(r)


def test_allreduce_zero_recompiles_steady_state(pair):
    combos = [((5,), np.float32, "sum"), ((7,), np.float32, "min"),
              ((6,), np.int32, "sum"), ((8,), np.int32, "max"),
              ((2, 3), np.float32, "prod")]
    steady = [((6,), np.float32, "sum"), ((8,), np.float32, "min"),
              ((5,), np.int32, "sum"), ((7,), np.int32, "max"),
              ((3, 2), np.float32, "prod"), ((8,), np.float32, "sum")]

    def fn(pkg, ctx):
        g = pkg.dart_team_memalloc_aligned(ctx, pkg.DART_TEAM_ALL, 512)
        for shape, dt, op in combos:
            pkg.dart_allreduce(ctx, g, shape, dt, op)
        c0 = ctx.engine.compile_count
        shapes = [_np(pkg.dart_allreduce(ctx, g, s, dt, op)).shape
                  for s, dt, op in steady]
        assert ctx.engine.compile_count == c0
        assert ctx.engine.plan_cache_hits > 0
        return shapes
    r, t = _both(pair, fn)
    assert t == [s for s, _, _ in steady] == r


@pytest.mark.parametrize("op", OPS)
def test_random_float32_allreduce_within_tolerance(pair, op):
    """Random float32 data: the fold over rows may round in another order
    than XLA's reduction, so results agree to rtol=1e-6 (the arenas are
    compared at the same tolerance, not byte for byte)."""
    rng = np.random.default_rng(17)
    data = rng.uniform(0.5, 2.0, (N_UNITS, 33)).astype(np.float32)
    rc, tc = pair
    out = []
    for pkg, ctx in ((R, rc), (T, tc)):
        g = pkg.dart_team_memalloc_aligned(ctx, pkg.DART_TEAM_ALL, 256)
        for u in range(N_UNITS):
            pkg.dart_put_blocking(ctx, g.setunit(u), data[u])
        red = _np(pkg.dart_allreduce(ctx, g, (33,), np.float32, op))
        rows = _np(pkg.dart_gather_typed(ctx, g, (33,), np.float32)[0])
        out.append((red, rows))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-6)
    np.testing.assert_allclose(out[1][1], out[0][1], rtol=1e-6)
    assert (out[1][1] == out[1][0][None, :]).all()


@pytest.mark.parametrize("dtype", ["int32", "float32", "bfloat16", "uint8"])
def test_gather_scatter_typed_and_raw(pair, dtype):
    rng = np.random.default_rng(3)
    dt = np.dtype(jnp.dtype(dtype))
    vals = (rng.integers(0, 100, (N_UNITS, 2, 3)).astype(np.float32)
            .astype(dt))
    raw = rng.integers(0, 256, (N_UNITS, 21), dtype=np.uint8)

    def fn(pkg, ctx):
        g = pkg.dart_team_memalloc_aligned(ctx, pkg.DART_TEAM_ALL, 256)
        pkg.dart_scatter_typed(ctx, g, vals)
        typed, h = pkg.dart_gather_typed(ctx, g, (2, 3), dt)
        h.wait()
        pkg.dart_scatter(ctx, g + 64, raw)
        got, _ = pkg.dart_gather(ctx, g + 64, 21)
        return _np(typed), _np(got)
    r, t = _both(pair, fn)
    assert t[0].tobytes() == r[0].tobytes() == vals.tobytes()
    assert t[0].shape == (N_UNITS, 2, 3)
    np.testing.assert_array_equal(t[1], raw)
    np.testing.assert_array_equal(t[1], r[1])


def test_scatter_typed_narrows_64_bit_values(pair):
    vals = np.arange(N_UNITS * 3, dtype=np.int64).reshape(N_UNITS, 3)

    def fn(pkg, ctx):
        g = pkg.dart_team_memalloc_aligned(ctx, pkg.DART_TEAM_ALL, 64)
        pkg.dart_scatter_typed(ctx, g, vals)
        pkg.dart_scatter_typed(ctx, g + 32, vals.astype(np.float64) / 4)
        return _np(pkg.dart_gather_typed(ctx, g, (3,), np.int32)[0])
    r, t = _both(pair, fn)
    np.testing.assert_array_equal(t, vals)


def test_collectives_order_after_queued_ops_and_count(pair):
    """A collective flushes the pool's queued ops first and counts one
    dispatch of its own, as in the reference."""
    def fn(pkg, ctx):
        g = pkg.dart_team_memalloc_aligned(ctx, pkg.DART_TEAM_ALL, 64)
        for u in range(N_UNITS):
            pkg.dart_accumulate(ctx, g.setunit(u), np.full(2, u, np.int32))
        d0 = ctx.engine.dispatch_count
        out, _ = pkg.dart_gather(ctx, g, 8)
        assert ctx.engine.dispatch_count - d0 == 2     # flush + gather
        assert ctx.engine.pending_ops() == 0
        pkg.dart_bcast(ctx, g.setunit(3), 8)
        red = pkg.dart_reduce(ctx, g, (2,), np.int32, "max", root=1)
        return _np(out), _np(red)
    r, t = _both(pair, fn)
    np.testing.assert_array_equal(t[0].view(np.int32),
                                  np.repeat(np.arange(4), 2).reshape(4, 2))
    np.testing.assert_array_equal(t[1], [3, 3])


@pytest.mark.parametrize("name", ["bcast", "scatter", "scatter_typed",
                                  "allreduce", "reduce"])
def test_functional_path_leaves_caller_state_untouched(pair, name):
    """With ``engine=None`` a collective returns a new state and leaves
    the caller's arenas as they were (the reference's PR 4 donation
    bug); the new state equals the reference's."""
    rc, tc = pair
    rng = np.random.default_rng(5)
    vals = rng.integers(0, 50, (N_UNITS, 4)).astype(np.int32)
    results = []
    for pkg, coll, ctx in ((R, rcoll, rc), (T, tcoll, tc)):
        g = pkg.dart_team_memalloc_aligned(ctx, pkg.DART_TEAM_ALL, 64)
        pkg.dart_scatter_typed(ctx, g, vals)
        pid = pkg.deref(ctx.heap, ctx.teams_by_slot, g)[0]
        before = np.array(_np(ctx.state[pid]))
        args = (ctx.state, ctx.heap, ctx.teams_by_slot)
        if name == "bcast":
            new, _ = coll.dart_bcast(*args, g.setunit(1), 16)
        elif name == "scatter":
            new, _ = coll.dart_scatter(*args, g, vals.view(np.uint8) + 1)
        elif name == "scatter_typed":
            new, _ = coll.dart_scatter_typed(*args, g, -vals)
        elif name == "allreduce":
            new, _ = coll.dart_allreduce(*args, g, (4,), np.int32, "sum")
        else:
            new, _ = coll.dart_reduce(*args, g, (4,), np.int32, "min",
                                      root=2)
        np.testing.assert_array_equal(_np(ctx.state[pid]), before)
        assert new is not ctx.state and new[pid] is not ctx.state[pid]
        results.append(np.array(_np(new[pid])))
    np.testing.assert_array_equal(results[1], results[0])
    assert not np.array_equal(results[1], before)


def test_barrier_fences_and_flushes(pair):
    _, tc = pair
    g = T.dart_memalloc(tc, 64, 2)
    h = T.dart_put(tc, g, np.ones(4, np.uint8))
    T.dart_barrier(tc)
    assert h.state == "complete" and tc.engine.pending_ops() == 0
    tcoll.dart_barrier()
    tcoll.dart_barrier(tc.state)
