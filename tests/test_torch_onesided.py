"""Seeded op sequences through the JAX reference (``repro.core``) and the
torch port (``repro_torch.core``, CPU heap): byte-identical arenas,
identical returned values and identical engine counters, plus the
completion ladder, per-target flush, window destruction with ops still
queued, and carrying a heap across from the reference mid-sequence."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.kernels import segmented_copy as rsc

import repro_torch.core as T
from repro_torch.kernels import segmented_copy as tsc

N_UNITS = 4
POOL = 4096
WORLD_ALLOC = 2048
TEAM_ALLOC = 1024
COUNTERS = ("dispatch_count", "ops_enqueued", "ops_coalesced",
            "compile_count", "plan_cache_hits")
DTYPES = ["uint8", "int32", "float32", "bfloat16", "float16"]


def _np_dtype(name):
    return np.dtype(jnp.dtype(name))


def _bytes(v) -> bytes:
    if isinstance(v, torch.Tensor):
        return v.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.asarray(v).tobytes()


class Side:
    """One package's runtime driven by the abstract op list."""

    def __init__(self, pkg, ctx):
        self.pkg = pkg
        self.ctx = ctx
        self.world = [pkg.dart_memalloc(ctx, WORLD_ALLOC, u)
                      for u in range(N_UNITS)]
        self.team = pkg.dart_team_memalloc_aligned(ctx, pkg.DART_TEAM_ALL,
                                                   TEAM_ALLOC)
        self.sub = None          # (teamid, gptr) of the live sub-team
        self.handles = []        # (op index, handle) of queued get_nb
        self.put_handles = []
        self.values = []         # bytes of every value returned, in order
        self.errors = []         # (op index, error class name)

    def base(self, where):
        return {"world": self.world[0], "team": self.team,
                "sub": self.sub and self.sub[1]}[where]

    def ptr(self, where, unit, off):
        if where == "world":
            return self.world[unit] + off
        if where == "team":
            return self.team.setunit(unit) + off
        return self.sub[1].setunit(unit) + off

    def arenas(self):
        return {pid: np.array(a) if not isinstance(a, torch.Tensor)
                else a.numpy().copy() for pid, a in self.ctx.state.items()}

    def counters(self):
        return tuple(getattr(self.ctx.engine, c) for c in COUNTERS)

    def run(self, i, op):
        pkg, ctx = self.pkg, self.ctx
        kind = op[0]
        if kind in ("put", "put_blocking"):
            _, where, unit, off, value, stride, count = op
            if where == "sub" and self.sub is None:
                return
            fn = pkg.dart_put if kind == "put" else pkg.dart_put_blocking
            h = fn(ctx, self.ptr(where, unit, off), value, stride=stride,
                   count=count)
            if kind == "put":
                self.put_handles.append((i, h))
        elif kind in ("get", "get_nb", "get_blocking"):
            _, where, unit, off, shape, dtype, stride, count = op
            if where == "sub" and self.sub is None:
                return
            g = self.ptr(where, unit, off)
            if kind == "get":
                v, h = pkg.dart_get(ctx, g, shape, dtype, stride=stride,
                                    count=count)
                self.values.append(_bytes(v))
            elif kind == "get_nb":
                self.handles.append((i, pkg.dart_get_nb(
                    ctx, g, shape, dtype, stride=stride, count=count)))
            else:
                self.values.append(_bytes(pkg.dart_get_blocking(
                    ctx, g, shape, dtype)))
        elif kind == "flush":
            pkg.dart_flush(ctx)
        elif kind in ("flush_pool", "flush_target"):
            if self.base(op[1]) is None:
                return
            pkg.dart_flush(ctx, self.base(op[1]),
                           target=op[2] if kind == "flush_target" else None)
        elif kind == "resolve":
            # read every queued get_nb value, in issue order
            for j, h in self.handles:
                try:
                    self.values.append(_bytes(h.value()))
                except pkg.DartError as e:
                    self.errors.append((j, type(e).__name__))
            self.handles = []
            for j, h in self.put_handles:
                try:
                    h.wait()
                except pkg.DartError as e:
                    self.errors.append((j, type(e).__name__))
            self.put_handles = []
        elif kind == "team_create":
            members = op[1]
            tid = pkg.dart_team_create(ctx, pkg.DART_TEAM_ALL,
                                       pkg.DartGroup(tuple(members)))
            self.sub = (tid, pkg.dart_team_memalloc_aligned(ctx, tid, 512))
        elif kind == "team_destroy":
            if self.sub is not None:
                pkg.dart_team_destroy(ctx, self.sub[0])
                self.sub = None
        else:
            raise KeyError(kind)


def _make_ops(seed, n_ops=60, teams=True):
    """A seeded op list over both packages' common surface.  Sizes and
    offsets come from small sets so runs coalesce, overlap (ordered
    dispatch) and mix sizes."""
    rng = np.random.default_rng(seed)
    ops = []
    sub_members = None
    last_put = None
    for _ in range(n_ops):
        r = rng.random()
        wheres = ["world", "team"] + (["sub"] if sub_members else [])
        where = wheres[int(rng.integers(len(wheres)))]
        n_rows = len(sub_members) if where == "sub" else N_UNITS
        space = 512 if where == "sub" else (
            WORLD_ALLOC if where == "world" else TEAM_ALLOC)
        unit = (sub_members[int(rng.integers(n_rows))] if where == "sub"
                else int(rng.integers(n_rows)))
        strided = rng.random() < 0.2
        if strided:
            count = int(rng.integers(2, 9))
            seg = int(rng.choice([1, 4, 8]))
            stride = seg + int(rng.integers(0, 24))
        else:
            count, seg, stride = 1, 0, 0
        if r < 0.45:                                       # put
            if strided:
                value = rng.integers(0, 256, seg * count, dtype=np.uint8)
            else:
                dt = DTYPES[int(rng.integers(len(DTYPES)))]
                n = int(rng.choice([1, 2, 3, 4, 8]))
                if dt in ("uint8", "int32"):
                    value = rng.integers(0, 100, n).astype(dt)
                elif dt == "float32":
                    value = rng.standard_normal(n)       # float64 → f32
                else:
                    value = rng.standard_normal(n).astype(_np_dtype(dt))
            span = ((count - 1) * stride + seg if strided
                    else value.nbytes if value.dtype != np.float64
                    else value.size * 4)
            off = int(rng.choice([0, 4, 8, 13, 64, 100,
                                  int(space - span)]))
            off = min(off, space - span)
            kind = "put" if rng.random() < 0.8 else "put_blocking"
            if last_put is not None and rng.random() < 0.35:
                # rewrite the last put's bytes (+ a shift): same-size
                # overlapping ops, the ordered dispatch's case
                _, where, unit, off, old, stride, count = last_put
                value = rng.permutation(old)
                if count == 1 and off >= 2 and rng.random() < 0.5:
                    off -= 2
            last_put = (kind, where, unit, off, value, stride, count)
            ops.append(last_put)
        elif r < 0.75:                                     # get
            if strided:
                dt, shape = "uint8", (seg * count,)
            else:
                dt = DTYPES[int(rng.integers(len(DTYPES)))]
                shape = (int(rng.choice([1, 2, 4, 8])),)
            nb = int(np.prod(shape)) * _np_dtype(dt).itemsize
            span = (count - 1) * stride + seg if strided else nb
            off = min(int(rng.choice([0, 4, 8, 13, 64, 100])), space - span)
            kinds = ["get", "get_nb", "get_nb"] + (
                [] if strided else ["get_blocking"])
            kind = kinds[int(rng.integers(len(kinds)))]
            ops.append((kind, where, unit, off, shape, dt, stride, count))
        elif r < 0.83:
            ops.append(("flush_target", where, unit))
        elif r < 0.88:
            ops.append(("flush",))
        elif r < 0.92:
            ops.append(("flush_pool", where))
        elif r < 0.96:
            ops.append(("resolve",))
        elif teams:
            last_put = None
            if sub_members is None:
                k = int(rng.integers(2, N_UNITS + 1))
                sub_members = sorted(rng.choice(N_UNITS, k,
                                                replace=False).tolist())
                ops.append(("team_create", sub_members))
            else:
                ops.append(("team_destroy",))
                sub_members = None
    ops.append(("resolve",))
    ops.append(("flush",))
    return ops


def _init_pair(ref_impl="ref"):
    rsc.clear_plan_cache()
    tsc.clear_plan_cache()
    cfg = dict(non_collective_pool_bytes=POOL, team_pool_bytes=POOL)
    rc = R.dart_init(n_units=N_UNITS, config=R.DartConfig(**cfg))
    rc.engine.impl = ref_impl
    tc = T.dart_init(n_units=N_UNITS, config=T.DartConfig(**cfg),
                     device="cpu")
    return Side(R, rc), Side(T, tc)


def _assert_same(ref, port, where=""):
    ra, ta = ref.arenas(), port.arenas()
    assert sorted(ra) == sorted(ta), where
    for pid in ra:
        np.testing.assert_array_equal(ta[pid], ra[pid],
                                      err_msg=f"pool {pid} {where}")
    assert port.values == ref.values, where
    assert port.errors == ref.errors, where


@pytest.mark.parametrize("seed", range(5))
def test_op_sequence_matches_reference(seed):
    ref, port = _init_pair()
    try:
        for i, op in enumerate(_make_ops(seed)):
            ref.run(i, op)
            port.run(i, op)
            assert (port.ctx.engine.pending_ops()
                    == ref.ctx.engine.pending_ops()), (i, op[0])
            if op[0] in ("flush", "resolve", "team_destroy"):
                _assert_same(ref, port, f"after op {i} ({op[0]})")
        _assert_same(ref, port, "at the end")
        assert port.counters() == ref.counters()
        assert port.ctx.engine.dispatch_count > 0
    finally:
        R.dart_exit(ref.ctx)
        T.dart_exit(port.ctx)


@pytest.mark.parametrize("seed", [100])
def test_op_sequence_matches_pallas_reference(seed):
    """Against the reference's Pallas engine (interpret mode): same bytes
    and values; plan counts differ by design (its keys carry the
    window buckets)."""
    ref, port = _init_pair("pallas")
    try:
        for i, op in enumerate(_make_ops(seed, n_ops=30, teams=False)):
            ref.run(i, op)
            port.run(i, op)
        _assert_same(ref, port, "at the end")
        assert (port.ctx.engine.dispatch_count
                == ref.ctx.engine.dispatch_count)
    finally:
        R.dart_exit(ref.ctx)
        T.dart_exit(port.ctx)


@pytest.mark.parametrize("split", [10, 25])
def test_heap_carried_across_from_reference(split):
    """A prefix of ops in JAX, the rest in the port on the carried-over
    heap, gives the arenas of staying in JAX all the way."""
    ops = _make_ops(7, n_ops=40, teams=False)
    ref, port = _init_pair()
    try:
        for i, op in enumerate(ops[:split]):
            ref.run(i, op)
        ref.run(split, ("resolve",))
        ref.run(split, ("flush",))
        carried = {pid: np.asarray(a) for pid, a in ref.ctx.state.items()}
        port.ctx.state.update(T.heap_state_from_numpy(carried, "cpu"))
        for i, op in enumerate(ops[split:], start=split):
            ref.run(i, op)
            port.run(i, op)
        ra, ta = ref.arenas(), T.heap_state_to_numpy(port.ctx.state)
        for pid in ra:
            np.testing.assert_array_equal(ta[pid], ra[pid])
    finally:
        R.dart_exit(ref.ctx)
        T.dart_exit(port.ctx)


# ---------------------------------------------------- focused behaviour --

@pytest.fixture()
def ctx():
    c = T.dart_init(n_units=4, config=T.DartConfig(
        non_collective_pool_bytes=8192, team_pool_bytes=8192), device="cpu")
    yield c
    T.dart_exit(c)


def test_completion_ladder_and_coalescing(ctx):
    g = T.dart_team_memalloc_aligned(ctx, T.DART_TEAM_ALL, 1024)
    hs = [T.dart_put(ctx, g.setunit(u) + 64 * j, np.full(64, u + j, np.uint8))
          for u in range(4) for j in range(4)]
    assert all(h.state == "queued" and not T.dart_test(h) for h in hs)
    assert ctx.engine.pending_ops() == 16
    assert ctx.engine.lane_stats()[(1, 2)][:2] == (4, 256)
    d0 = ctx.engine.dispatch_count
    T.dart_waitall(hs)
    assert ctx.engine.dispatch_count - d0 == 1
    assert ctx.engine.ops_coalesced == 16
    assert all(h.state == "complete" and T.dart_test(h) for h in hs)
    assert T.dart_testall(hs)
    v = T.dart_get_blocking(ctx, g.setunit(3) + 64 * 2, (64,), torch.uint8)
    assert v.device == torch.device("cpu") and v.tolist() == [5] * 64


def test_per_target_flush_leaves_other_lanes_queued(ctx):
    g = T.dart_team_memalloc_aligned(ctx, T.DART_TEAM_ALL, 256)
    hs = [T.dart_put(ctx, g.setunit(u), np.arange(8, dtype=np.int32))
          for u in range(4)]
    T.dart_flush(ctx, g, target=2)
    assert [h.state for h in hs] == ["queued", "queued", "complete",
                                     "queued"]
    assert ctx.engine.pending_ops() == 3
    hs[0].wait()                      # flushes only its own lane
    assert ctx.engine.pending_ops() == 2
    with ctx.engine.epoch_scope():
        T.dart_put(ctx, g.setunit(1) + 32, np.ones(4, np.float32))
    assert ctx.engine.pending_ops() == 0


def test_team_destroy_fails_queued_ops(ctx):
    tid = T.dart_team_create(ctx, T.DART_TEAM_ALL, T.DartGroup((1, 3)))
    g = T.dart_team_memalloc_aligned(ctx, tid, 128)
    h = T.dart_put(ctx, g.setunit(3), np.ones(16, np.uint8))
    gh = T.dart_get_nb(ctx, g, (4,), np.float32)
    T.dart_team_destroy(ctx, tid)
    for handle in (h, gh):
        assert handle.state == "failed"
        with pytest.raises(T.WindowDestroyedError) as ei:
            handle.wait()
        assert ei.value.teamid == tid
    with pytest.raises(T.WindowDestroyedError):
        gh.value()
    tid2 = T.dart_team_create(ctx, T.DART_TEAM_ALL, T.DartGroup((0, 2)))
    assert ctx.teams[tid2].slot == 1                 # slot reused
    g2 = T.dart_team_memalloc_aligned(ctx, tid2, 128)
    T.dart_put_blocking(ctx, g2.setunit(2), np.arange(4, dtype=np.int32))
    assert T.dart_get_blocking(ctx, g2.setunit(2), (4,),
                               np.int32).tolist() == [0, 1, 2, 3]


def test_cuda_impl_on_cpu_arena_raises_at_dispatch(ctx):
    g = T.dart_memalloc(ctx, 64, 0)
    ctx.engine.impl = "cuda"
    h = T.dart_put(ctx, g, np.ones(4, np.uint8))
    with pytest.raises(ValueError, match="CUDA arena"):
        T.dart_flush(ctx)
    assert h.state == "queued" and ctx.engine.pending_ops() == 1
    ctx.engine.impl = "auto"
    T.dart_flush(ctx)
    assert h.state == "complete"
    with pytest.raises(ValueError, match="unknown impl"):
        T.CommEngine(impl="pallas")


def test_torch_payloads_and_bf16_values(ctx):
    g = T.dart_memalloc(ctx, 256, 2)
    src = torch.tensor([1.5, -2.25, 3.0, 1e-3], dtype=torch.bfloat16)
    T.dart_put_blocking(ctx, g, src)
    got = T.dart_get_blocking(ctx, g, (4,), torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, src)
    got = T.dart_get_blocking(ctx, g, (2,), "bfloat16")
    assert torch.equal(got, src[:2])
    T.dart_put_blocking(ctx, g + 16, 2.5)              # Python float → f32
    assert T.dart_get_blocking(ctx, g + 16, (), np.float32).item() == 2.5


def test_strided_column_put_get(ctx):
    n = 16
    g = T.dart_memalloc(ctx, 4 * n * n, 1)
    mat = np.arange(n * n, dtype=np.float32).reshape(n, n)
    T.dart_put_blocking(ctx, g, mat)
    col = -np.arange(n, dtype=np.float32)
    T.dart_put_blocking(ctx, g + 4 * 3, col, stride=4 * n, count=n)
    mat[:, 3] = col
    v, _ = T.dart_get(ctx, g + 4 * 3, (n,), np.float32, stride=4 * n,
                      count=n)
    assert v.tolist() == col.tolist()
    full = T.dart_get_blocking(ctx, g, (n, n), np.float32)
    np.testing.assert_array_equal(full.numpy(), mat)
    with pytest.raises(ValueError, match="stride"):
        T.dart_put(ctx, g, np.ones(8, np.uint8), stride=2, count=2)
