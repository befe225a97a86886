"""The reduction plane of the torch port (``dart_accumulate`` /
``dart_get_accumulate``) against the JAX reference: identical host
staging (op identities, ``(kb, 7)`` tables, identity-padded payloads),
plain read-modify-write versions byte-identical to the reference's
``'ref'`` and ``'pallas'`` (interpret mode) plans, and seeded op
sequences through both runtimes on CPU heaps with byte-identical
arenas, identical fetched values and identical engine counters.

Data are denormal-free: XLA on the CPU flushes denormals to zero,
torch and the CUDA kernels do not (ROADMAP queue 3)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

import repro.core as R
from repro.kernels import segmented_copy as rsc

import repro_torch.core as T
from repro_torch.kernels import segmented_copy as tsc

OPS = ("sum", "prod", "min", "max")
ACC_DTYPES = tsc.ACC_DTYPES
N_UNITS = 4
POOL = 2048
COUNTERS = ("dispatch_count", "ops_enqueued", "ops_coalesced",
            "compile_count", "plan_cache_hits")
ARENA = (4, 512)


def _np(dtype):
    return np.dtype(jnp.dtype(dtype))


def _rand_elems(rng, dtype, n):
    """Random elements of ``dtype`` as a numpy array: floats of magnitude
    in [1, 2) with random signs (sums and products stay clear of the
    denormal range), integers over the type's whole range."""
    dt = _np(dtype)
    if dtype in ("float16", "bfloat16", "float32"):
        v = rng.uniform(1.0, 2.0, n) * rng.choice([-1.0, 1.0], n)
        return v.astype(np.float32).astype(dt)
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, n, endpoint=True).astype(dt)


def _bytes(v) -> bytes:
    if isinstance(v, torch.Tensor):
        return v.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.asarray(v).tobytes()


# ------------------------------------------------------------ host layer --

@pytest.mark.parametrize("dtype", ACC_DTYPES)
@pytest.mark.parametrize("op", OPS)
def test_op_identity_and_bytes_match_reference(op, dtype):
    ref = rsc.op_identity(op, jnp.dtype(dtype))
    port = tsc.op_identity(op, dtype)
    assert port.dim() == 0 and str(port.dtype) == f"torch.{dtype}"
    assert _bytes(port) == ref.tobytes()
    np.testing.assert_array_equal(tsc.identity_bytes(op, dtype),
                                  rsc.identity_bytes(op, jnp.dtype(dtype)))


def test_op_identity_rejects_unknown_op_and_types():
    for mod in (rsc, tsc):
        with pytest.raises(ValueError):
            mod.op_identity("xor", "int32")
    with pytest.raises(ValueError):
        tsc.op_identity("min", "bool")
    with pytest.raises(ValueError):
        tsc.op_identity("max", "complex64")


def _case(name):
    """(rows, offs, lens, strides, counts, overlapping): element-aligned
    accumulate tables on a ``ARENA`` heap, lengths in bytes."""
    P = ARENA[1]
    if name == "disjoint":
        return ([0, 1, 2, 3, 0], [0, 16, 32, 96, 192], [16, 16, 16, 16, 16],
                None, None, False)
    if name == "overlapping":
        return ([1] * 6, [8, 16, 8, 0, 12, 4], [24] * 6, None, None, True)
    if name == "mixed":
        return ([0, 0, 2, 3, 1, 2, 3], [0, 8, 40, 4, 300, 200, 380],
                [4, 32, 100, 4, 64, 4, 76], None, None, False)
    if name == "strided":
        return ([0, 1, 2, 3], [4, 0, 8, 48], [4, 8, 4, 16],
                [64, 8, 8, 0], [6, 10, 40, 1], False)
    if name == "pool_end":
        return ([3, 2, 0], [P - 40, P - 4, P - 4 - 3 * 60], [40, 4, 4],
                [0, 0, 60], [1, 1, 4], False)
    if name == "padded":                 # k=5 → kb=8: three padding rows
        return ([2, 0, 1, 3, 2], [4, 100, 248, 0, 380], [4, 8, 12, 100, 32],
                None, None, False)
    raise KeyError(name)


CASES = ["disjoint", "overlapping", "mixed", "strided", "pool_end",
         "padded"]


def _acc_tables(name, dtype, seed):
    """Element-aligned geometry for ``dtype`` (lengths, offsets and
    strides scaled to whole elements), random payloads and arena."""
    isz = _np(dtype).itemsize
    rows, offs, lens, strides, counts, ordered = _case(name)
    scale = lambda xs: None if xs is None else [x // 4 * isz for x in xs]
    offs, lens, strides = scale(offs), scale(lens), scale(strides)
    cnts = counts or [1] * len(rows)
    rng = np.random.default_rng(seed)
    pays = [_rand_elems(rng, dtype, l * c // isz).view(np.uint8)
            for l, c in zip(lens, cnts)]
    arena = _rand_elems(rng, dtype, ARENA[0] * ARENA[1] // isz
                        ).view(np.uint8).reshape(ARENA)
    return arena, pays, (rows, offs, lens, strides, counts), ordered


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("dtype", ["int8", "uint16", "float32", "bfloat16"])
def test_pack_acc_descriptors_identical(name, dtype):
    _, pays, (rows, offs, lens, strides, counts), _ = _acc_tables(
        name, dtype, 1)
    for op in OPS:
        r = rsc.pack_acc_descriptors(rows, offs, lens, pays, op,
                                     jnp.dtype(dtype), strides=strides,
                                     counts=counts)
        t = tsc.pack_acc_descriptors(rows, offs, lens, pays, op, dtype,
                                     strides=strides, counts=counts)
        np.testing.assert_array_equal(t[0], r[0])
        np.testing.assert_array_equal(t[1], r[1])
        assert t[2] == r[2] and t[0].dtype == np.int32
        # the engine's dense table: the put table plus the op column, and
        # the reference's flat length is the plan key's kb*seg
        dense, seg = tsc.pack_acc_table(rows, offs, lens, op,
                                        strides=strides, counts=counts)
        put, _, pseg = tsc.pack_descriptors(rows, offs, lens,
                                            strides=strides, counts=counts)
        assert seg == pseg == r[2]
        np.testing.assert_array_equal(dense[:, :tsc.DESC_COLS], put)
        assert (dense[:, tsc.OPCODE] == tsc.REDUCE_OPS[op]).all()
        assert dense.shape[0] * seg == r[1].shape[0]


def test_accumulate_plan_counts_like_reference():
    reqs = [(4, 16, 64, "sum", "int32", False, False),
            (4, 16, 64, "sum", "int32", False, False),
            (4, 16, 64, "sum", "int32", False, True),
            (4, 16, 64, "sum", "float32", False, False),
            (4, 16, 64, "max", "int32", True, False),
            (4, 16, 64, "max", "int32", True, False),
            (8, 32, 256, "prod", "bfloat16", False, False),
            (4, 16, 64, "sum", "int32", False, True)]
    rsc.clear_plan_cache()
    tsc.clear_plan_cache()
    r_hits = [rsc.accumulate_plan(ARENA, kb, seg, fl, op=op,
                                  dtype=jnp.dtype(dt), fetch=f,
                                  ordered=o)[1]
              for kb, seg, fl, op, dt, f, o in reqs]
    t_hits = [tsc.accumulate_plan(ARENA, kb, seg, fl, op=op, dtype=dt,
                                  fetch=f, ordered=o)[1]
              for kb, seg, fl, op, dt, f, o in reqs]
    assert t_hits == r_hits
    with pytest.raises(ValueError):
        tsc.accumulate_plan((4, 510), 4, 16, 64, op="sum", dtype="int32",
                            fetch=False)
    with pytest.raises(ValueError):
        tsc.accumulate_plan(ARENA, 4, 16, 64, op="xor", dtype="int32",
                            fetch=False)


# --------------------------------------- plain versions vs the reference --

def _ref_acc(arena, desc, flat, seg, op, dtype, fetch, ordered, impl):
    fn, _ = rsc.accumulate_plan(arena.shape, desc.shape[0], seg,
                                flat.shape[0], op=op, dtype=jnp.dtype(dtype),
                                fetch=fetch, ordered=ordered, impl=impl,
                                donate=False)
    out = fn(jnp.asarray(arena), jnp.asarray(desc), jnp.asarray(flat))
    if fetch:
        return np.asarray(out[0]), np.asarray(out[1])
    return np.asarray(out), None


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("dtype", ["int32", "uint8", "int16", "float32",
                                   "bfloat16", "float16"])
@pytest.mark.parametrize("op", OPS)
def test_plain_accumulate_matches_reference(op, dtype, name):
    """The plain versions on the reference's identity-padded layout and
    on the engine's dense layout give the reference's arena (and, for a
    fetch, its pre-update windows) byte for byte."""
    arena, pays, geo, ordered = _acc_tables(name, dtype, seed=7)
    rows, offs, lens, strides, counts = geo
    desc, flat, seg = tsc.pack_acc_descriptors(
        rows, offs, lens, pays, op, dtype, strides=strides, counts=counts)
    dense, dseg = tsc.pack_acc_table(rows, offs, lens, op, strides=strides,
                                     counts=counts)
    dflat = torch.from_numpy(np.concatenate(pays))
    for fetch in ((False,) if ordered else (False, True)):
        ref, old = _ref_acc(arena, desc, flat, seg, op, dtype, fetch,
                            ordered, "ref")
        for d, f in ((desc, torch.from_numpy(flat)), (dense, dflat)):
            port = torch.from_numpy(arena.copy())
            res = tsc.accumulate_ref(port, torch.from_numpy(d), f, seg=seg,
                                     op=op, dtype=dtype, fetch=fetch,
                                     ordered=ordered)
            np.testing.assert_array_equal(port.numpy(), ref)
            if fetch:
                np.testing.assert_array_equal(res[1].numpy(), old)
        contiguous = counts is None or all(c == 1 for c in counts)
        if (contiguous and not fetch
                and rsc.pallas_ok(desc, seg, ARENA[1])):
            pal, _ = _ref_acc(arena, desc, flat, seg, op, dtype, False,
                              ordered, "pallas")
            np.testing.assert_array_equal(port.numpy(), pal)


@pytest.mark.parametrize("op", OPS)
def test_ordered_equals_vectorized_on_disjoint_tables(op):
    arena, pays, geo, _ = _acc_tables("mixed", "float32", seed=3)
    desc, seg = tsc.pack_acc_table(*geo[:3], op)
    flat = torch.from_numpy(np.concatenate(pays))
    a = torch.from_numpy(arena.copy())
    b = torch.from_numpy(arena.copy())
    tsc.accumulate_ref(a, torch.from_numpy(desc), flat, seg=seg, op=op,
                       dtype="float32", fetch=False, ordered=False)
    tsc.accumulate_ref(b, torch.from_numpy(desc), flat, seg=seg, op=op,
                       dtype="float32", fetch=False, ordered=True)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="fetch"):
        tsc.accumulate_ref(a, torch.from_numpy(desc), flat, seg=seg, op=op,
                           dtype="float32", fetch=True, ordered=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_signed_zero_and_nan_min_max_match_jax(dtype):
    """XLA's min/max order -0 < +0 in both argument orders and propagate
    NaN; torch.minimum/maximum return their first operand on a tie."""
    a = np.array([0.0, -0.0, 0.0, -0.0, np.nan, 1.0, -2.0], np.float32)
    b = np.array([-0.0, 0.0, 0.0, -0.0, 1.0, np.nan, -2.0], np.float32)
    ta = torch.from_numpy(a).to(getattr(torch, dtype))
    tb = torch.from_numpy(b).to(getattr(torch, dtype))
    ja, jb = jnp.asarray(a, dtype), jnp.asarray(b, dtype)
    for op, jfn in (("min", jnp.minimum), ("max", jnp.maximum)):
        got = tsc.combine(ta, tb, op)
        want = np.asarray(jfn(ja, jb))
        assert _bytes(got[[0, 1, 2, 3, 6]]) == want[[0, 1, 2, 3, 6]].tobytes()
        assert torch.isnan(got[4:6].float()).all()
        assert np.isnan(want[4:6].astype(np.float32)).all()
    # the ±0 tie in torch's own minimum differs by argument order
    assert _bytes(torch.minimum(ta[:2], tb[:2])) != _bytes(
        tsc.combine(ta[:2], tb[:2], "min"))


@pytest.mark.parametrize("dtype", ["int8", "uint8", "int16", "uint16",
                                   "int32", "uint32"])
def test_integer_sum_and_prod_wrap_like_jax(dtype):
    dt = _np(dtype)
    info = np.iinfo(dt)
    a = np.array([info.max, info.min, info.max, -1 if info.min else 7,
                  info.max // 3 + 5], dt)
    b = np.array([1, info.min or 9, info.max, info.max, 3], dt)
    for op, jfn in (("sum", jnp.add), ("prod", jnp.multiply),
                    ("min", jnp.minimum), ("max", jnp.maximum)):
        got = tsc.combine(torch.from_numpy(a), torch.from_numpy(b), op)
        assert _bytes(got) == np.asarray(jfn(jnp.asarray(a),
                                             jnp.asarray(b))).tobytes()


@settings(deadline=None, max_examples=25)
@given(st.lists(st.tuples(st.integers(0, 3), st.integers(0, 100),
                          st.integers(1, 16)), min_size=1, max_size=6),
       st.sampled_from(OPS), st.sampled_from(["int32", "float32"]),
       st.integers(0, 2**31 - 1))
def test_plain_accumulate_property(ops, op, dtype, seed):
    """Random small overlapping tables: the port's ordered plain version
    against the reference's ordered ref plan, bitwise."""
    rng = np.random.default_rng(seed)
    rows = [o[0] for o in ops]
    offs = [o[1] * 4 for o in ops]
    lens = [o[2] * 4 for o in ops]
    pays = [_rand_elems(rng, dtype, n // 4).view(np.uint8) for n in lens]
    arena = _rand_elems(rng, dtype, ARENA[0] * ARENA[1] // 4
                        ).view(np.uint8).reshape(ARENA)
    desc, flat, seg = tsc.pack_acc_descriptors(rows, offs, lens, pays, op,
                                               dtype)
    ref, _ = _ref_acc(arena, desc, flat, seg, op, dtype, False, True, "ref")
    port = torch.from_numpy(arena.copy())
    tsc.accumulate_ref(port, torch.from_numpy(desc), torch.from_numpy(flat),
                       seg=seg, op=op, dtype=dtype, fetch=False, ordered=True)
    np.testing.assert_array_equal(port.numpy(), ref)


# --------------------------------------------- seeded engine sequences --

def _init_pair(ref_impl="ref", pool=POOL):
    rsc.clear_plan_cache()
    tsc.clear_plan_cache()
    cfg = dict(non_collective_pool_bytes=pool, team_pool_bytes=pool)
    rc = R.dart_init(n_units=N_UNITS, config=R.DartConfig(**cfg))
    rc.engine.impl = ref_impl
    tc = T.dart_init(n_units=N_UNITS, config=T.DartConfig(**cfg),
                     device="cpu")
    return rc, tc


def _arenas(ctx):
    return {pid: (a.numpy() if isinstance(a, torch.Tensor)
                  else np.asarray(a)) for pid, a in ctx.state.items()}


def _counters(ctx):
    return tuple(getattr(ctx.engine, c) for c in COUNTERS)


def _make_sequence(seed, op, dtype, n_epochs=25):
    """Epochs of acc (dominant) / put / gacc / per-target flush over one
    WORLD allocation per unit, each closed by a waitall or a flush —
    ``test_differential_sequences_vs_blocking_oracle``'s mix, with
    random (non-integer) floats."""
    rng = random.Random(f"{seed}/{op}/{dtype}")
    nrng = np.random.default_rng(seed)
    isz = _np(dtype).itemsize
    epochs = []
    for _ in range(n_epochs):
        steps = []
        for _ in range(rng.randint(2, 8)):
            row = rng.randrange(N_UNITS)
            n = rng.randint(1, 12)
            max_e = POOL // isz - n
            e_off = max_e if rng.random() < 0.15 else rng.randint(0, max_e)
            if rng.random() < 0.3:          # revisit: overlapping runs
                e_off = rng.choice([0, 4, 8]) % (max_e + 1)
            vals = _rand_elems(nrng, dtype, n)
            kind = rng.choices(["acc", "put", "gacc", "flush_t"],
                               weights=[6, 2, 1, 1])[0]
            steps.append((kind, row, e_off * isz, vals))
        epochs.append((steps, rng.random() < 0.5))
    return epochs


def _run_epoch(pkg, ctx, g, steps, waitall, op, values):
    handles = []
    for kind, row, off, vals in steps:
        ptr = g[row] + off
        if kind == "acc":
            handles.append(pkg.dart_accumulate(ctx, ptr, vals, op))
        elif kind == "put":
            handles.append(pkg.dart_put(ctx, ptr, vals))
        elif kind == "gacc":
            old, h = pkg.dart_get_accumulate(ctx, ptr, vals, op)
            values.append(_bytes(old))
            handles.append(h)
        else:
            pkg.dart_flush(ctx, g[0], target=row)
    if waitall:
        pkg.dart_waitall(handles)
    else:
        pkg.dart_flush(ctx)


@pytest.mark.parametrize("dtype", ["int32", "float32", "bfloat16"])
@pytest.mark.parametrize("op", OPS)
def test_sequences_match_reference(op, dtype):
    rc, tc = _init_pair()
    try:
        gr = [R.dart_memalloc(rc, POOL, u) for u in range(N_UNITS)]
        gt = [T.dart_memalloc(tc, POOL, u) for u in range(N_UNITS)]
        rv, tv = [], []
        for i, (steps, waitall) in enumerate(_make_sequence(5, op, dtype)):
            _run_epoch(R, rc, gr, steps, waitall, op, rv)
            _run_epoch(T, tc, gt, steps, waitall, op, tv)
            ra, ta = _arenas(rc), _arenas(tc)
            for pid in ra:
                np.testing.assert_array_equal(ta[pid], ra[pid],
                                              err_msg=f"epoch {i}")
            assert tv == rv, f"epoch {i}"
        assert _counters(tc) == _counters(rc)
        assert tc.engine.dispatch_count > 0 and tc.engine.ops_coalesced > 0
    finally:
        R.dart_exit(rc)
        T.dart_exit(tc)


@pytest.mark.parametrize("op", OPS)
def test_sequences_match_pallas_reference(op):
    """Against the reference's Pallas engine (interpret mode): the same
    bytes, values and dispatches; plan counts differ by design (its
    pool-end runs fall back to ref plans)."""
    rc, tc = _init_pair("pallas")
    try:
        gr = [R.dart_memalloc(rc, POOL, u) for u in range(N_UNITS)]
        gt = [T.dart_memalloc(tc, POOL, u) for u in range(N_UNITS)]
        rv, tv = [], []
        for steps, waitall in _make_sequence(9, op, "int32", n_epochs=8):
            _run_epoch(R, rc, gr, steps, waitall, op, rv)
            _run_epoch(T, tc, gt, steps, waitall, op, tv)
        for pid, a in _arenas(rc).items():
            np.testing.assert_array_equal(_arenas(tc)[pid], a)
        assert tv == rv
        assert tc.engine.dispatch_count == rc.engine.dispatch_count
    finally:
        R.dart_exit(rc)
        T.dart_exit(tc)


@pytest.mark.parametrize("split", [6, 15])
def test_heap_carried_across_from_reference(split):
    """The first epochs in JAX, the rest in the port on the carried-over
    heap: the arenas of staying in JAX all the way."""
    epochs = _make_sequence(11, "sum", "float32")
    rc, tc = _init_pair()
    try:
        gr = [R.dart_memalloc(rc, POOL, u) for u in range(N_UNITS)]
        gt = [T.dart_memalloc(tc, POOL, u) for u in range(N_UNITS)]
        rv, tv = [], []
        for steps, waitall in epochs[:split]:
            _run_epoch(R, rc, gr, steps, waitall, "sum", rv)
        tc.state.update(T.heap_state_from_numpy(_arenas(rc), "cpu"))
        for steps, waitall in epochs[split:]:
            _run_epoch(R, rc, gr, steps, waitall, "sum", [])
            _run_epoch(T, tc, gt, steps, waitall, "sum", tv)
        ra, ta = _arenas(rc), T.heap_state_to_numpy(tc.state)
        for pid in ra:
            np.testing.assert_array_equal(ta[pid], ra[pid])
    finally:
        R.dart_exit(rc)
        T.dart_exit(tc)


@pytest.mark.parametrize("dtype", ["int8", "uint16", "uint32", "float16"])
def test_strided_and_narrow_types_match_reference(dtype):
    """Strided accumulates (one descriptor per column) and the narrower
    element types through both runtimes."""
    rc, tc = _init_pair()
    rng = np.random.default_rng(4)
    isz = _np(dtype).itemsize
    try:
        gr = R.dart_memalloc(rc, 1024, 1)
        gt = T.dart_memalloc(tc, 1024, 1)
        base = _rand_elems(rng, dtype, 256 // isz)
        R.dart_put_blocking(rc, gr, base)
        T.dart_put_blocking(tc, gt, base)
        for op in OPS:
            col = _rand_elems(rng, dtype, 8)
            kw = dict(stride=8 * isz, count=8)
            R.dart_accumulate(rc, gr + isz, col, op, **kw)
            T.dart_accumulate(tc, gt + isz, col, op, **kw)
            ro, _ = R.dart_get_accumulate(rc, gr + 2 * isz, col, op, **kw)
            to, _ = T.dart_get_accumulate(tc, gt + 2 * isz, col, op, **kw)
            assert _bytes(to) == _bytes(np.asarray(ro))
            assert to.dtype == getattr(torch, dtype)
        R.dart_flush(rc)
        T.dart_flush(tc)
        for pid, a in _arenas(rc).items():
            np.testing.assert_array_equal(_arenas(tc)[pid], a)
        assert _counters(tc) == _counters(rc)
    finally:
        R.dart_exit(rc)
        T.dart_exit(tc)


# -------------------------------- run splits, pool end, initiation checks --

@pytest.fixture()
def pair():
    rc, tc = _init_pair()
    yield rc, tc
    R.dart_exit(rc)
    T.dart_exit(tc)


def _both(pair, fn):
    """Run ``fn(pkg, ctx)`` on both runtimes; their results, the port's
    as numpy."""
    rc, tc = pair
    r, t = fn(R, rc), fn(T, tc)
    conv = (lambda v: v.numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v))
    if isinstance(r, tuple):
        return tuple(map(np.asarray, r)), tuple(map(conv, t))
    return np.asarray(r), conv(t)


def _i32(n, v):
    return np.full((n,), v, np.int32)


def test_same_op_accumulates_one_dispatch(pair):
    def fn(pkg, ctx):
        g = pkg.dart_memalloc(ctx, 1024, unit=0)
        d0 = ctx.engine.dispatch_count
        hs = [pkg.dart_accumulate(ctx, g + 8 * (i % 3), _i32(4, 1))
              for i in range(8)]
        pkg.dart_flush(ctx)
        assert ctx.engine.dispatch_count - d0 == 1
        pkg.dart_waitall(hs)
        return pkg.dart_get_blocking(ctx, g, (10,), np.int32)
    r, t = _both(pair, fn)
    np.testing.assert_array_equal(t, [3, 3, 6, 6, 5, 5, 2, 2, 0, 0])
    np.testing.assert_array_equal(t, r)


def test_mixed_op_overlap_splits_runs(pair):
    def fn(pkg, ctx):
        g = pkg.dart_memalloc(ctx, 512, unit=1)
        pkg.dart_put_blocking(ctx, g, _i32(4, 2))
        d0 = ctx.engine.dispatch_count
        pkg.dart_accumulate(ctx, g, _i32(4, 3), "sum")
        pkg.dart_accumulate(ctx, g, _i32(4, 4), "prod")
        pkg.dart_accumulate(ctx, g, _i32(4, 10), "min")
        pkg.dart_flush(ctx)
        assert ctx.engine.dispatch_count - d0 == 3
        return pkg.dart_get_blocking(ctx, g, (4,), np.int32)
    r, t = _both(pair, fn)
    np.testing.assert_array_equal(t, [10] * 4)
    np.testing.assert_array_equal(t, r)


def test_accumulate_vs_put_overlap_splits(pair):
    def fn(pkg, ctx):
        g = pkg.dart_memalloc(ctx, 256, unit=2)
        pkg.dart_put(ctx, g, _i32(4, 5))
        pkg.dart_accumulate(ctx, g, _i32(4, 1), "sum")
        pkg.dart_put(ctx, g + 8, _i32(2, 9))
        pkg.dart_flush(ctx)
        return pkg.dart_get_blocking(ctx, g, (4,), np.int32)
    r, t = _both(pair, fn)
    np.testing.assert_array_equal(t, [6, 6, 9, 9])
    np.testing.assert_array_equal(t, r)


def test_mixed_dtype_accumulates_split(pair):
    def fn(pkg, ctx):
        g = pkg.dart_memalloc(ctx, 256, unit=0)
        d0 = ctx.engine.dispatch_count
        pkg.dart_accumulate(ctx, g, _i32(2, 1), "sum")
        pkg.dart_accumulate(ctx, g + 64, np.full((2,), 1.5, np.float32),
                            "sum")
        pkg.dart_flush(ctx)
        assert ctx.engine.dispatch_count - d0 == 2
        return (pkg.dart_get_blocking(ctx, g, (2,), np.int32),
                pkg.dart_get_blocking(ctx, g + 64, (2,), np.float32))
    r, t = _both(pair, fn)
    np.testing.assert_array_equal(t[0], [1, 1])
    np.testing.assert_array_equal(t[1], [1.5, 1.5])


def test_get_accumulate_overlap_splits_and_orders(pair):
    def fn(pkg, ctx):
        g = pkg.dart_memalloc(ctx, 256, unit=3)
        pkg.dart_put_blocking(ctx, g, _i32(4, 10))
        h1 = ctx.engine.get_accumulate(ctx.heap, ctx.teams_by_slot, g,
                                       _i32(4, 1), "sum")
        h2 = ctx.engine.get_accumulate(ctx.heap, ctx.teams_by_slot, g,
                                       _i32(4, 2), "sum")
        d0 = ctx.engine.dispatch_count
        pkg.dart_flush(ctx)
        assert ctx.engine.dispatch_count - d0 == 2
        return (h1.value(), h2.value(),
                pkg.dart_get_blocking(ctx, g, (4,), np.int32))
    r, t = _both(pair, fn)
    for want, got in zip(([10] * 4, [11] * 4, [13] * 4), t):
        np.testing.assert_array_equal(got, want)


def test_disjoint_get_accumulates_share_one_dispatch(pair):
    def fn(pkg, ctx):
        g = pkg.dart_memalloc(ctx, 512, unit=0)
        for i in range(4):
            pkg.dart_put_blocking(ctx, g + 32 * i, _i32(4, i + 1))
        hs = [ctx.engine.get_accumulate(ctx.heap, ctx.teams_by_slot,
                                        g + 32 * i, _i32(4, 10), "sum")
              for i in range(4)]
        d0 = ctx.engine.dispatch_count
        pkg.dart_flush(ctx)
        assert ctx.engine.dispatch_count - d0 == 1
        return tuple(h.value() for h in hs) + tuple(
            pkg.dart_get_blocking(ctx, g + 32 * i, (4,), np.int32)
            for i in range(4))
    r, t = _both(pair, fn)
    for i in range(4):
        np.testing.assert_array_equal(t[i], [i + 1] * 4)
        np.testing.assert_array_equal(t[4 + i], [i + 11] * 4)


def test_accumulate_pool_end_headroom(pair):
    def fn(pkg, ctx):
        pool = ctx.config.non_collective_pool_bytes
        g = pkg.dart_memalloc(ctx, pool, unit=1)
        pkg.dart_put_blocking(ctx, g + pool - 16,
                              np.full((4,), 0xCD, np.uint8))
        pkg.dart_accumulate_blocking(ctx, g + pool - 12, _i32(3, 7), "sum")
        return (pkg.dart_get_blocking(ctx, g + pool - 16, (4,), np.uint8),
                pkg.dart_get_blocking(ctx, g + pool - 12, (3,), np.int32))
    r, t = _both(pair, fn)
    np.testing.assert_array_equal(t[0], [0xCD] * 4)
    np.testing.assert_array_equal(t[1], [7, 7, 7])


@pytest.mark.parametrize("bad", ["op", "misaligned", "bounds",
                                 "strided_misaligned"])
def test_rejected_at_initiation(pair, bad):
    def fn(pkg, ctx):
        pool = ctx.config.non_collective_pool_bytes
        g = pkg.dart_memalloc(ctx, 256, unit=0)
        args = {"op": (g, _i32(2, 1), "xor"),
                "misaligned": (g + 2, _i32(2, 1), "sum"),
                "bounds": (g + (pool - 4 - g.addr), _i32(4, 0), "sum")}
        kw = {}
        if bad == "strided_misaligned":
            args[bad] = (g, _i32(4, 1), "sum")
            kw = dict(stride=10, count=2)
        with pytest.raises(ValueError):
            pkg.dart_accumulate(ctx, *args[bad], **kw)
        assert ctx.engine.pending_ops() == 0
    _both(pair, fn)


@pytest.mark.parametrize("value", [np.ones(4, bool),
                                   np.ones(2, np.complex64),
                                   torch.ones(2, dtype=torch.complex64),
                                   torch.ones(3, dtype=torch.bool)])
def test_bool_and_complex_rejected_at_initiation(value):
    """The reference accepts these at initiation and fails at dispatch
    (its failed op then stays queued); the port refuses them up front."""
    tc = T.dart_init(n_units=2, config=T.DartConfig(
        non_collective_pool_bytes=256, team_pool_bytes=256), device="cpu")
    try:
        g = T.dart_memalloc(tc, 64, 0)
        for fn in (T.dart_accumulate, T.dart_get_accumulate):
            with pytest.raises(ValueError, match="not supported"):
                fn(tc, g, value, "max")
        assert tc.engine.pending_ops() == 0
    finally:
        T.dart_exit(tc)


def test_64_bit_payloads_are_narrowed_like_the_reference(pair):
    def fn(pkg, ctx):
        g = pkg.dart_memalloc(ctx, 256, unit=1)
        pkg.dart_accumulate_blocking(ctx, g, np.arange(4, dtype=np.int64))
        pkg.dart_accumulate_blocking(ctx, g + 16, np.full(2, 0.25))
        pkg.dart_accumulate_blocking(ctx, g + 16, 1.5)
        return pkg.dart_get_blocking(ctx, g, (8,), np.int32)
    r, t = _both(pair, fn)
    np.testing.assert_array_equal(t, r)
    rc, tc = pair
    assert _counters(tc) == _counters(rc)


def test_torch_tensor_payloads():
    tc = T.dart_init(n_units=2, config=T.DartConfig(
        non_collective_pool_bytes=256, team_pool_bytes=256), device="cpu")
    try:
        g = T.dart_memalloc(tc, 64, 1)
        src = torch.tensor([1.5, -2.25, 3.0, 0.5], dtype=torch.bfloat16)
        T.dart_put_blocking(tc, g, src)
        T.dart_accumulate_blocking(tc, g, src, "prod")
        old, _ = T.dart_get_accumulate(tc, g, torch.ones(4, dtype=torch.float64
                                                         ).to(torch.bfloat16),
                                       "sum")
        assert old.dtype == torch.bfloat16 and torch.equal(old, src * src)
        old, _ = T.dart_get_accumulate(tc, g + 16,
                                       torch.arange(2, dtype=torch.int64))
        assert old.dtype == torch.int32 and old.tolist() == [0, 0]
    finally:
        T.dart_exit(tc)


def test_accumulate_zero_recompiles_steady_state(pair):
    def fn(pkg, ctx):
        g = pkg.dart_memalloc(ctx, 2048, unit=0)

        def epoch(k, n):
            hs = [pkg.dart_accumulate(ctx, g + 64 * i, _i32(n, 1))
                  for i in range(k)]
            pkg.dart_flush(ctx)
            pkg.dart_waitall(hs)

        epoch(8, 16)                  # warm the (8, 64 B) and (4, 64 B)
        epoch(4, 16)                  # buckets
        c0 = ctx.engine.compile_count
        for k, n in [(5, 16), (7, 9), (8, 12), (6, 10), (4, 16), (8, 13)]:
            epoch(k, n)
        assert ctx.engine.compile_count == c0
        return np.asarray(_counters(ctx))
    r, t = _both(pair, fn)
    np.testing.assert_array_equal(t, r)


def test_queued_accumulate_dropped_by_destroy_fails_handle(pair):
    _, tc = pair
    tid = T.dart_team_create(tc, T.DART_TEAM_ALL, T.DartGroup((0, 1)))
    gt = T.dart_team_memalloc_aligned(tc, tid, 128)
    h = T.dart_accumulate(tc, gt, _i32(2, 1))
    gh = tc.engine.get_accumulate(tc.heap, tc.teams_by_slot, gt.setunit(1),
                                  _i32(2, 1), "max")
    T.dart_team_destroy(tc, tid)
    for handle in (h, gh):
        assert handle.state == "failed"
        with pytest.raises(RuntimeError, match="window destroyed"):
            handle.wait()


def test_accumulate_handle_state_machine(pair):
    _, tc = pair
    g = T.dart_memalloc(tc, 256, unit=0)
    h = T.dart_accumulate(tc, g, _i32(4, 1))
    assert h.state == "queued" and not h.test()
    T.dart_flush(tc)
    assert h.state in ("issued", "complete")
    h.wait()
    assert h.state == "complete" and T.dart_test(h)


def test_cuda_impl_on_cpu_arena_raises_for_accumulate(pair):
    _, tc = pair
    g = T.dart_memalloc(tc, 64, 0)
    tc.engine.impl = "cuda"
    h = T.dart_accumulate(tc, g, _i32(4, 1))
    with pytest.raises(ValueError, match="CUDA arena"):
        T.dart_flush(tc)
    assert h.state == "queued"
    tc.engine.impl = "auto"
    T.dart_flush(tc)
    assert T.dart_get_blocking(tc, g, (4,), np.int32).tolist() == [1] * 4


def test_accumulate_cuda_refuses_cpu_tensors():
    arena = torch.zeros(ARENA, dtype=torch.uint8)
    desc, seg = tsc.pack_acc_table([0], [0], [4], "sum")
    before = dict(tsc.launch_counts)
    with pytest.raises(ValueError, match="CUDA arena"):
        tsc.accumulate_cuda(arena, torch.from_numpy(desc),
                            torch.ones(4, dtype=torch.uint8), seg=seg,
                            op="sum", dtype="int32", fetch=False,
                            ordered=False)
    fn, _ = tsc.accumulate_plan(ARENA, desc.shape[0], seg, 64, op="sum",
                                dtype="int32", fetch=False)
    fn(arena, torch.from_numpy(desc),
       torch.from_numpy(np.ones(1, np.int32).view(np.uint8)))
    assert tsc.launch_counts == before
    assert arena[0, :4].tolist() == [1, 0, 0, 0]
