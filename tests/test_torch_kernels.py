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
