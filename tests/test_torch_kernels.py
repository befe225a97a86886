"""The hand-written CUDA segmented-copy kernels against their plain
torch versions, on a card.  These tests are marked ``gpu`` and skip
without a CUDA device; on one, run

    python -m pytest -m gpu tests/test_torch_kernels.py

The module imports torch and the port only (no JAX), so it runs where
the reference package cannot be installed.  Its descriptor tables are
shared with ``test_torch_segmented_copy``, which holds the plain
versions against the JAX reference."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import segmented_copy as tsc

ARENA = (4, 512)


def _case(name):
    """(rows, offs, lens, strides, counts, overlapping) of one table."""
    P = ARENA[1]
    if name == "disjoint":
        return ([0, 1, 2, 3, 0], [0, 16, 33, 100, 200], [16, 16, 16, 16, 16],
                None, None, False)
    if name == "overlapping":
        return ([1] * 6, [10, 14, 10, 0, 12, 11], [24] * 6, None, None,
                True)
    if name == "mixed":
        return ([0, 0, 2, 3, 1, 2, 3], [0, 5, 40, 7, 300, 200, 380],
                [5, 30, 100, 1, 64, 3, 77], None, None, False)
    if name == "strided":
        return ([0, 1, 2, 3], [4, 0, 3, 50], [4, 8, 1, 16],
                [64, 8, 5, 0], [6, 10, 40, 1], False)
    if name == "pool_end":
        return ([3, 2, 0], [P - 40, P - 4, P - 1 - 3 * 60], [40, 4, 1],
                [0, 0, 60], [1, 1, 4], False)
    if name == "padded":                 # k=5 → kb=8: three padding rows
        return ([2, 0, 1, 3, 2], [1, 100, 250, 0, 380], [2, 7, 13, 100, 32],
                None, None, False)
    raise KeyError(name)


CASES = ["disjoint", "overlapping", "mixed", "strided", "pool_end",
         "padded"]


def _tables(name, seed=0):
    rows, offs, lens, strides, counts, ordered = _case(name)
    rng = np.random.default_rng(seed)
    cnts = counts or [1] * len(rows)
    pays = [rng.integers(0, 256, l * c, dtype=np.uint8)
            for l, c in zip(lens, cnts)]
    arena = rng.integers(0, 256, ARENA, dtype=np.uint8)
    return arena, pays, (rows, offs, lens, strides, counts), ordered


# -------------------------------------------------- kernels on the card --

@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", CASES)
def test_cuda_scatter_matches_plain(cuda_device, name):
    arena, pays, geo, ordered = _tables(name, seed=21)
    desc, flat, seg = tsc.pack_descriptors(*geo[:3], pays, strides=geo[3],
                                           counts=geo[4])
    d = torch.from_numpy(desc).to(cuda_device)
    f = torch.from_numpy(flat).to(cuda_device)
    for mode in {ordered, True}:
        k = torch.from_numpy(arena.copy()).to(cuda_device)
        p = k.clone()
        before = tsc.launch_counts["scatter_ordered" if mode else "scatter"]
        tsc.scatter_cuda(k, d, f, seg=seg, ordered=mode)
        tsc.scatter_ref(p, d, f, seg=seg, ordered=mode)
        torch.cuda.synchronize()
        assert torch.equal(k, p), f"{name} ordered={mode}"
        assert tsc.launch_counts[
            "scatter_ordered" if mode else "scatter"] == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("name", CASES)
def test_cuda_gather_matches_plain(cuda_device, name):
    arena, _, geo, _ = _tables(name, seed=22)
    desc, _, seg = tsc.pack_descriptors(*geo[:3], strides=geo[3],
                                        counts=geo[4])
    a = torch.from_numpy(arena).to(cuda_device)
    d = torch.from_numpy(desc).to(cuda_device)
    k = tsc.gather_cuda(a, d, seg=seg)
    torch.cuda.synchronize()
    assert torch.equal(k, tsc.gather_ref(a, d, seg=seg))


# ---------------------------------------- accumulate kernels on the card --

ACC_KINDS = ["disjoint", "ordered", "fetch", "strided", "pool_end",
             "padded"]


def _special(rng, dtype, n):
    """Random elements of ``dtype`` with the edge cases mixed in: NaN,
    ±0, ±inf, denormals and the largest finite values for floats (so
    sums overflow and products underflow); the type's min, max, 0 and
    -1 for integers (so sums and products wrap)."""
    tdt = getattr(torch, dtype)
    if tdt.is_floating_point:
        info = torch.finfo(tdt)
        v = torch.from_numpy(rng.standard_normal(n).astype(np.float32) * 3)
        sp = torch.tensor([0.0, -0.0, float("inf"), float("-inf"),
                           float("nan"), info.tiny / 4, -info.tiny / 2,
                           info.max, -info.max, info.tiny])
        pick = torch.from_numpy(rng.random(n) < 0.4)
        v[pick] = sp[torch.from_numpy(rng.integers(0, len(sp),
                                                   int(pick.sum())))]
        return v.to(tdt)
    info = torch.iinfo(tdt)
    v = rng.integers(info.min, info.max, n, endpoint=True, dtype=np.int64)
    ext = np.array([info.min, info.max, 0, -1 if info.min < 0 else 1])
    pick = rng.random(n) < 0.3
    v[pick] = rng.choice(ext, int(pick.sum()))
    return torch.from_numpy(v).to(torch.int64).view(torch.uint8).reshape(
        n, 8)[:, :tdt.itemsize].reshape(-1).view(tdt)


def _acc_geometry(kind, isz, k, rng):
    """(rows, offs, lens, strides, counts) of ``k`` element-aligned ops,
    lengths in bytes."""
    P = ARENA[1]
    rows, offs, lens, strides, counts = [], [], [], [], []
    cursor = [0] * ARENA[0]
    for j in range(k):
        n = int(rng.integers(1, 6 if kind == "strided" else 24))
        if kind == "ordered":                   # overlapping, one row
            rows.append(1)
            offs.append(int(rng.integers(0, 16)) * isz)
            lens.append(n * isz)
            strides.append(0)
            counts.append(1)
            continue
        r = j % ARENA[0]
        c = int(rng.integers(2, 5)) if kind == "strided" else 1
        st = (n + int(rng.integers(0, 3))) * isz if c > 1 else 0
        span = (c - 1) * st + n * isz
        off = cursor[r] + int(rng.integers(0, 3)) * isz
        if kind == "pool_end" and j < ARENA[0]:
            off = P - span                        # hard against the end
        cursor[r] = off + span
        rows.append(r)
        offs.append(off)
        lens.append(n * isz)
        strides.append(st)
        counts.append(c)
    return rows, offs, lens, strides, counts


def _acc_case(kind, dtype, op, seed):
    """(arena, desc, flat, seg, fetch, ordered) as the engine stages an
    accumulate run: dense payloads, the (kb, 7) table."""
    rng = np.random.default_rng(seed)
    isz = getattr(torch, dtype).itemsize
    k = {"padded": 5, "pool_end": 4}.get(kind, int(rng.integers(2, 12)))
    rows, offs, lens, strides, counts = _acc_geometry(kind, isz, k, rng)
    desc, seg = tsc.pack_acc_table(rows, offs, lens, op, strides=strides,
                                   counts=counts)
    flat = torch.cat([_special(rng, dtype, l * c // isz).view(torch.uint8)
                      for l, c in zip(lens, counts)])
    arena = _special(rng, dtype, ARENA[0] * ARENA[1] // isz).view(
        torch.uint8).reshape(ARENA)
    return arena, desc, flat, seg, kind == "fetch", kind == "ordered"


@pytest.mark.parametrize("kind", ACC_KINDS)
@pytest.mark.parametrize("dtype", tsc.ACC_DTYPES)
def test_acc_tables_are_element_aligned_and_in_range(kind, dtype):
    """The tables the card tests use, checked on the host: every op lies
    inside the arena and the payload, element-aligned."""
    for op in tsc.REDUCE_OPS:
        arena, desc, flat, seg, fetch, ordered = _acc_case(kind, dtype, op,
                                                           seed=31)
        isz = getattr(torch, dtype).itemsize
        live = desc[:, tsc.LEN] > 0
        d = desc[live].astype(np.int64)
        assert (d[:, [tsc.OFF, tsc.LEN, tsc.STRIDE, tsc.START]] % isz
                == 0).all()
        last = d[:, tsc.OFF] + (d[:, tsc.COUNT] - 1) * d[:, tsc.STRIDE] \
            + d[:, tsc.LEN]
        assert (last <= ARENA[1]).all()
        assert (d[:, tsc.START] + d[:, tsc.LEN] * d[:, tsc.COUNT]
                <= flat.numel()).all()


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ACC_KINDS)
@pytest.mark.parametrize("dtype", tsc.ACC_DTYPES)
def test_cuda_accumulate_matches_plain(cuda_device, kind, dtype):
    """Bitwise equal to the plain version on the card, NaN, ±0,
    denormal, overflow and wrap-around cases included."""
    name = ("get_accumulate" if kind == "fetch" else
            "accumulate_ordered" if kind == "ordered" else "accumulate")
    for op in tsc.REDUCE_OPS:
        arena, desc, flat, seg, fetch, ordered = _acc_case(kind, dtype, op,
                                                           seed=41)
        d = torch.from_numpy(desc).to(cuda_device)
        f = flat.to(cuda_device)
        k = arena.to(cuda_device)
        p = k.clone()
        before = tsc.launch_counts[name]
        got = tsc.accumulate_cuda(k, d, f, seg=seg, op=op, dtype=dtype,
                                  fetch=fetch, ordered=ordered)
        want = tsc.accumulate_ref(p, d, f, seg=seg, op=op, dtype=dtype,
                                  fetch=fetch, ordered=ordered)
        torch.cuda.synchronize()
        assert torch.equal(k, p), f"{kind} {dtype} {op}"
        if fetch:
            assert torch.equal(got[1], want[1]), f"{kind} {dtype} {op} old"
        assert tsc.launch_counts[name] == before + 1
