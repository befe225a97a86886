"""Differential tests of the torch port's symmetric heap against the JAX
reference: byte layout of typed values, the 64-bit canonicalization of
staged payloads, the allocator, carrying a heap across, and the
package's import and device guards."""

import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

import repro.core as R
from repro.core import onesided as R_os

import repro_torch.core as T
from repro_torch.core import onesided as T_os

ROOT = pathlib.Path(__file__).resolve().parents[1]

# (numpy bits dtype, jax dtype, torch dtype) for each heap dtype under test
DTYPES = {
    "uint8": (np.uint8, jnp.uint8, torch.uint8),
    "int32": (np.int32, jnp.int32, torch.int32),
    "float32": (np.uint32, jnp.float32, torch.float32),
    "float16": (np.uint16, jnp.float16, torch.float16),
    "bfloat16": (np.uint16, jnp.bfloat16, torch.bfloat16),
}


def _random_pair(name, shape, seed):
    """The same random bit patterns as a jax array and a torch tensor."""
    bits_dt, jdt, tdt = DTYPES[name]
    rng = np.random.default_rng(seed)
    info = np.iinfo(bits_dt)
    bits = rng.integers(info.min, info.max, size=shape, dtype=bits_dt,
                        endpoint=True)
    if name in ("uint8", "int32"):
        return jnp.asarray(bits), torch.from_numpy(bits.copy())
    host = bits.view(jnp.dtype(jdt))
    return jnp.asarray(host), torch.from_numpy(bits.copy()).view(tdt)


@pytest.mark.parametrize("name", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (2, 3, 4)])
def test_to_bytes_matches_reference(name, shape):
    ref, port = _random_pair(name, shape, seed=len(shape) * 31 + len(name))
    rb = np.asarray(R.to_bytes(ref))
    pb = T.to_bytes(port).numpy()
    assert pb.dtype == np.uint8
    np.testing.assert_array_equal(pb, rb)


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_from_bytes_matches_reference(name):
    ref, port = _random_pair(name, (4, 6), seed=7)
    raw = np.asarray(R.to_bytes(ref))
    back_ref = R.from_bytes(jnp.asarray(raw), (4, 6), DTYPES[name][1])
    back = T.from_bytes(torch.from_numpy(raw.copy()), (4, 6),
                        DTYPES[name][2])
    assert back.dtype == DTYPES[name][2] and back.shape == (4, 6)
    np.testing.assert_array_equal(T.to_bytes(back).numpy(),
                                  np.asarray(R.to_bytes(back_ref)))
    assert T.nbytes_of((4, 6), name) == R.nbytes_of((4, 6),
                                                    DTYPES[name][1])


@settings(deadline=None, max_examples=25)
@given(st.integers(1, 40), st.sampled_from(sorted(DTYPES)),
       st.integers(0, 2**31 - 1))
def test_bytes_roundtrip_property(n, name, seed):
    ref, port = _random_pair(name, (n,), seed)
    raw = T.to_bytes(port)
    np.testing.assert_array_equal(raw.numpy(), np.asarray(R.to_bytes(ref)))
    back = T.from_bytes(raw, (n,), DTYPES[name][2])
    assert torch.equal(back.view(torch.uint8), port.view(torch.uint8))


@pytest.mark.parametrize("value", [
    1.5, -3, True, [1.0, 2.0, 3.5], [7, 8, 9],
    np.arange(5, dtype=np.float64) / 3, np.arange(6, dtype=np.int64) - 3,
    np.arange(4, dtype=np.uint64) * 2**33, np.arange(3, dtype=np.complex128),
    np.arange(5, dtype=np.float32), np.arange(5, dtype=np.int8),
    np.asarray(2.5, np.float64),
], ids=lambda v: type(v).__name__ + str(np.asarray(v).dtype))
def test_host_staging_canonicalizes_like_reference(value):
    """x64-off canonicalization: 64-bit host values become 32-bit before
    the bitcast in both packages."""
    np.testing.assert_array_equal(T_os._to_host_bytes(value),
                                  R_os._to_host_bytes(value))


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float16,
                                torch.float64, torch.int64])
def test_torch_payloads_keep_their_dtype(dt):
    t = (torch.arange(6) * 3 - 5).to(dt)
    got = T_os._to_host_bytes(t)
    assert got.dtype == np.uint8 and got.size == 6 * t.element_size()
    assert torch.equal(torch.from_numpy(got.copy()).view(dt), t)


@pytest.mark.parametrize("seed", range(4))
def test_allocator_offsets_match_reference(seed):
    rng = np.random.default_rng(seed)
    ra, ta = R.BlockAllocator(1 << 16), T.BlockAllocator(1 << 16)
    live = []
    for _ in range(200):
        if live and rng.random() < 0.4:
            off = live.pop(int(rng.integers(len(live))))
            ra.free(off)
            ta.free(off)
        else:
            n = int(rng.integers(1, 2000))
            try:
                ro = ra.alloc(n)
            except R.OutOfGlobalMemory:
                with pytest.raises(T.OutOfGlobalMemory):
                    ta.alloc(n)
                continue
            assert ta.alloc(n) == ro
            live.append(ro)
        assert ta._free == ra._free
        assert (ta.bytes_live(), ta.bytes_free(), ta.largest_free()) == (
            ra.bytes_live(), ra.bytes_free(), ra.largest_free())


def test_heap_layout_matches_reference():
    cfg = dict(non_collective_pool_bytes=1000, team_pool_bytes=3000)
    rc = R.dart_init(n_units=4, config=R.DartConfig(**cfg))
    tc = T.dart_init(n_units=4, config=T.DartConfig(**cfg), device="cpu")
    try:
        assert sorted(tc.state) == sorted(rc.state)
        for pid in rc.state:
            assert tuple(tc.state[pid].shape) == rc.state[pid].shape
            assert tc.state[pid].dtype == torch.uint8
            assert tc.state[pid].device == torch.device("cpu")
            assert not tc.state[pid].any()
        for u in range(4):
            for n in (1, 129, 300):
                assert (T.dart_memalloc(tc, n, u).addr
                        == R.dart_memalloc(rc, n, u).addr)
        for n in (10, 500, 128):
            assert (T.dart_team_memalloc_aligned(tc, T.DART_TEAM_ALL, n)
                    .pack() == R.dart_team_memalloc_aligned(
                        rc, R.DART_TEAM_ALL, n).pack())
    finally:
        R.dart_exit(rc)
        T.dart_exit(tc)


def test_heap_state_numpy_roundtrip():
    rng = np.random.default_rng(3)
    state = {0: rng.integers(0, 256, (4, 256), dtype=np.uint8),
             1: rng.integers(0, 256, (2, 128), dtype=np.uint8)}
    heap = T.heap_state_from_numpy(state, "cpu")
    assert all(t.dtype == torch.uint8 for t in heap.values())
    back = T.heap_state_to_numpy(heap)
    for pid in state:
        np.testing.assert_array_equal(back[pid], state[pid])
    state[0][0, 0] ^= 1                  # the port holds its own copy
    assert heap[0][0, 0].item() != state[0][0, 0]
    with pytest.raises(ValueError):
        T.heap_state_from_numpy({0: np.zeros((4,), np.uint8)}, "cpu")


def test_import_pulls_in_neither_jax_nor_reference():
    code = ("import sys, repro_torch.core, repro_torch.kernels."
            "segmented_copy, repro_torch.kernels._build, "
            "repro_torch.kernels.flash_attention, repro_torch.models.api, "
            "repro_torch.configs; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')); print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_dart_init_defaults_to_cuda_and_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.dart_init(n_units=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.dart_init(n_units=2, device="cuda")
    ctx = T.dart_init(n_units=2, device="cpu")
    assert ctx.device == torch.device("cpu")
    T.dart_exit(ctx)
