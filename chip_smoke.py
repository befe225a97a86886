#!/usr/bin/env python3
"""Drive the torch port's one-sided put/get path, its reduction plane,
its host-plane collectives, its flash attention and its dense model
(llama3-8b) on one CUDA card.

    python3 chip_smoke.py

Needs one CUDA card (Hopper, sm_90a) and nvcc; exits non-zero without
them, and prints no result.  It

1. prints the card's name and power limit, builds the kernels of
   ``src/repro_torch/kernels/csrc`` (segmented copy and read-modify-write;
   flash attention), one nvcc per source, all at once, and prints the
   build times and ``-Xptxas -v``;
2. brings the runtime up through ``repro_torch.core`` at the scale of
   the reference's paper benchmark: 16 units, a 48 MiB per-unit WORLD
   pool and a 48 MiB per-member DART_TEAM_ALL pool (two 768 MiB arenas
   on the card);
3. runs three paths, each with the kernels' launch counts set to 0
   just before it and read just after, and compares both arenas byte
   for byte with a numpy shadow heap after every phase:
   - put/get: blocking sweep 1 B … 2 MiB, coalesced epoch, overlapping
     epoch, mixed-size epoch, per-target flush, strided put/get,
     non-blocking get run;
   - the reduction plane: blocking f32 accumulate sweep 4 B … 2 MiB, a
     coalesced accumulate epoch, an overlapping one, every op x
     {int32, float32, bfloat16} with its run splits, a fused
     get_accumulate run, a strided column accumulate;
   - collectives: bcast, gather, scatter, allreduce and reduce;
4. holds every kernel against its plain torch version on the card
   (``torch.equal`` on clones of the arena, and for the accumulate
   kernels on edge-value tables of every op and element type);
5. times the kernels warm and cold beside their bounds and yardsticks,
   the blocking and coalesced µs/op of puts, gets and accumulates, and
   where a blocking op's host time goes (a split of each op, PyTorch's
   per-call costs and a cProfile), and prints the kernels' launch
   counts from step 3 with their times as one JSON line;
6. runs two more counted paths, each with the launch counts set to 0
   just before it and read just after:
   - attention: ``flash_attention`` at llama3-8b's head geometry (B=1,
     S=T=4096, Hq=32, Hkv=8, hd=128), causal, float32 and bfloat16,
     and S=1024 over T=4096, causal and not; each result held against
     the plain version and the model's ``gqa_scores_and_mix`` (2e-5
     float32, 2e-2 bfloat16, TF32 off), the kernel timed warm and cold
     beside its bound, the plain version and PyTorch's
     ``scaled_dot_product_attention`` (timed only);
   - the dense model: llama3-8b at full width and depth with seeded
     random float32 parameters on the card; in float32 compute, the
     reference's prefill/decode consistency check on a 512-token
     prompt; in the config's bfloat16 compute, a timed 512-token
     prefill and 16 greedy decode steps, and one of each under
     ``torch.profiler`` (device time by kernel, busy share);
7. prints the kernels' launch counts and times as one JSON line, then
   ``{"ok": true, "device": {...}}`` as its last line.
"""

from __future__ import annotations

import cProfile
import json
import pathlib
import pstats
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

N_UNITS = 16
POOL_BYTES = 48 << 20
TEAM_ALLOC = 16 << 20
WORLD_ALLOC = 40 << 20
SWEEP = [1 << e for e in range(0, 22, 3)]       # 1 B … 2 MiB
HBM_BYTES_PER_S = 3.35e12                       # H100 SXM
SOURCE = "src/repro_torch/kernels/csrc/segmented_copy.cu"
ACC_SWEEP = [4 << (3 * e) for e in range(7)] + [2 << 20]   # 4 B … 2 MiB
REPLACES = {"scatter": "src/repro/kernels/segmented_copy.py:482",
            "scatter_ordered": "src/repro/kernels/segmented_copy.py:482",
            "gather": "src/repro/kernels/segmented_copy.py:505",
            "accumulate": "src/repro/kernels/segmented_copy.py:529",
            "accumulate_ordered": "src/repro/kernels/segmented_copy.py:529",
            "get_accumulate": "src/repro/kernels/segmented_copy.py:529"}
KERNELS = tuple(REPLACES)
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention.py:32"
#: llama3-8b's attention geometry (src/repro_torch/configs/llama3_8b.py)
ATTN = dict(b=1, s=4096, hq=32, hkv=8, hd=128, rect_s=1024)
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: H100 SXM peaks: IEEE float32 on the CUDA cores, dense bf16 tensor cores
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
MODEL_ARCH = "llama3-8b"
PROMPT = 512
DECODE_STEPS = 16


class SmokeFailure(AssertionError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ----------------------------------------------------------------------------
# shadow heap: the same ops applied in program order on the host
# ----------------------------------------------------------------------------

class Shadow:
    def __init__(self, ctx):
        self.ctx = ctx
        self.pools = {pid: np.zeros(tuple(a.shape), np.uint8)
                      for pid, a in ctx.state.items()}

    def put(self, gptr, payload: np.ndarray, stride: int = 0,
            count: int = 1) -> None:
        from repro_torch.core import deref
        pid, row, off = deref(self.ctx.heap, self.ctx.teams_by_slot, gptr)
        seg = payload.size // count
        if count == 1:
            self.pools[pid][row, off:off + seg] = payload
            return
        for j in range(count):
            at = off + j * stride
            self.pools[pid][row, at:at + seg] = payload[j * seg:(j + 1) * seg]

    def read(self, gptr, nbytes: int) -> np.ndarray:
        from repro_torch.core import deref
        pid, row, off = deref(self.ctx.heap, self.ctx.teams_by_slot, gptr)
        return self.pools[pid][row, off:off + nbytes].copy()

    def accumulate(self, gptr, vals: np.ndarray, dtype: str, op: str,
                   stride: int = 0, count: int = 1) -> np.ndarray:
        """Apply one accumulate in program order; returns the pre-update
        bytes (the get_accumulate value)."""
        from repro_torch.core import deref
        pid, row, off = deref(self.ctx.heap, self.ctx.teams_by_slot, gptr)
        n = vals.size // count
        nb = n * vals.itemsize
        old = []
        for j in range(count):
            at = off + j * stride
            cell = self.pools[pid][row, at:at + nb]
            old.append(cell.copy())
            cur = cell.view(vals.dtype)
            cell[:] = np_combine(cur, vals[j * n:(j + 1) * n], op,
                                 dtype).view(np.uint8)
        return np.concatenate(old)

    def pool_rows(self, gptr) -> np.ndarray:
        from repro_torch.core import deref
        pid, _, _ = deref(self.ctx.heap, self.ctx.teams_by_slot, gptr)
        return self.pools[pid]

    def compare(self, phase: str) -> None:
        for pid, arena in self.ctx.state.items():
            got = arena.cpu().numpy()
            same = np.array_equal(got, self.pools[pid])
            if not same:
                bad = np.argwhere(got != self.pools[pid])
                raise SmokeFailure(
                    f"{phase}: pool {pid} differs from the shadow heap at "
                    f"{len(bad)} bytes, first {bad[:4].tolist()}")
        print(f"phase {phase}: arenas match the shadow heap byte for byte")


def as_bytes(value: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(value).reshape(-1).view(np.uint8)


# ----------------------------------------------------------------------------
# the reduction plane's oracle: numpy IEEE arithmetic, bfloat16 as its bits
# (uint16) computed in float32 and rounded to nearest even
# ----------------------------------------------------------------------------

def bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def f32_to_bf16(f: np.ndarray) -> np.ndarray:
    u = np.ascontiguousarray(f, np.float32).view(np.uint32)
    return ((u + np.uint32(0x7FFF) + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def np_combine(a: np.ndarray, b: np.ndarray, op: str, dtype: str):
    """The sequential oracle's ``a op b`` (no NaN or signed zeros in the
    data it sees; int32 wraps)."""
    if dtype == "bfloat16":
        return f32_to_bf16(np_combine(bf16_to_f32(a), bf16_to_f32(b), op,
                                      "float32"))
    with np.errstate(over="ignore"):
        if op == "sum":
            return a + b
        if op == "prod":
            return a * b
    return np.minimum(a, b) if op == "min" else np.maximum(a, b)


def rand_vals(rng, dtype: str, n: int) -> np.ndarray:
    """Random elements: int32 over its whole range; floats of magnitude
    in [1, 2) with random signs and all mantissa bits (bf16 as bits)."""
    if dtype == "int32":
        return rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32)
    f = (rng.uniform(1.0, 2.0, n) * rng.choice([-1.0, 1.0], n)
         ).astype(np.float32)
    return f if dtype == "float32" else f32_to_bf16(f)


def as_payload(vals: np.ndarray, dtype: str):
    """What a caller hands the port: numpy, or a torch bf16 tensor."""
    import torch
    if dtype == "bfloat16":
        return torch.from_numpy(vals.copy()).view(torch.bfloat16)
    return vals


# ----------------------------------------------------------------------------
# the main path
# ----------------------------------------------------------------------------

def bring_up(device, n_units: int, pool_bytes: int, world_alloc: int,
             team_alloc: int):
    import repro_torch.core as dart
    ctx = dart.dart_init(n_units=n_units, config=dart.DartConfig(
        non_collective_pool_bytes=pool_bytes, team_pool_bytes=pool_bytes),
        device=device)
    gw = [dart.dart_memalloc(ctx, world_alloc, u) for u in range(n_units)]
    gt = dart.dart_team_memalloc_aligned(ctx, dart.DART_TEAM_ALL, team_alloc)
    return ctx, gw, gt


def run_phases(ctx, gw, gt, rng, *, sweep, epoch_ops: int, epoch_bytes: int,
               overlap_ops: int, overlap_bytes: int, mixed_max: int,
               block: int, mb: int = 1 << 20) -> None:
    """Every traffic phase once, each checked against the shadow heap.
    Phases use separate regions of each unit's WORLD allocation, laid
    out in units of ``mb`` bytes (the allocation is ``40 * mb``)."""
    import torch
    import repro_torch.core as dart
    eng = ctx.engine
    sh = Shadow(ctx)
    n = ctx.n_units

    # -- A: blocking put + get sweep to several units ----------------------
    targets = sorted({0, n // 3, (2 * n) // 3, n - 1})
    for size in sweep:
        for u in targets:
            pay = rng.integers(0, 256, size, dtype=np.uint8)
            dart.dart_put_blocking(ctx, gw[u], pay)
            sh.put(gw[u], pay)
            got = dart.dart_get_blocking(ctx, gw[u], (size,), torch.uint8)
            check(np.array_equal(got.numpy(), pay),
                  f"blocking get of {size} B from unit {u} differs")
    sh.compare("blocking-sweep")

    # -- B: coalesced epoch of puts over every unit -----------------------
    d0 = eng.dispatch_count
    hs, locs = [], []
    for i in range(epoch_ops):
        u = i % n
        g = gt.setunit(u) + (i // n) * epoch_bytes
        pay = rng.integers(0, 256, epoch_bytes, dtype=np.uint8)
        hs.append(dart.dart_put(ctx, g, pay))
        sh.put(g, pay)
        locs.append(g)
    check(all(h.state == "queued" for h in hs), "epoch ops not queued")
    dart.dart_flush(ctx)
    dart.dart_waitall(hs)
    check(eng.dispatch_count - d0 == 1,
          f"coalesced epoch took {eng.dispatch_count - d0} dispatches")
    check(all(h.state == "complete" for h in hs), "epoch handles incomplete")
    sh.compare("coalesced-epoch")

    # -- C: overlapping epoch to one offset: last writer wins --------------
    d0 = eng.dispatch_count
    g = gw[1 % n] + 8 * mb
    hs = []
    for i in range(overlap_ops):
        pay = rng.integers(0, 256, overlap_bytes, dtype=np.uint8)
        hs.append(dart.dart_put(ctx, g, pay))
        sh.put(g, pay)
    dart.dart_waitall(hs)
    check(eng.dispatch_count - d0 == 1,
          f"overlapping epoch took {eng.dispatch_count - d0} dispatches")
    sh.compare("overlapping-epoch")

    # -- D: mixed-size disjoint epoch, 8 B … mixed_max, unaligned too -------
    d0 = eng.dispatch_count
    cursor = {u: 12 * mb for u in range(n)}
    hs = []
    size = 8
    i = 0
    while size <= mixed_max:
        for extra in (0, 3):
            u = i % n
            i += 1
            nbytes = size + extra
            off = cursor[u] + int(rng.integers(0, 17))
            cursor[u] = off + nbytes
            g = gw[u] + off
            pay = rng.integers(0, 256, nbytes, dtype=np.uint8)
            hs.append(dart.dart_put(ctx, g, pay))
            sh.put(g, pay)
        size *= 2
    dart.dart_flush(ctx)
    dart.dart_waitall(hs)
    check(eng.dispatch_count - d0 == 1,
          f"mixed-size epoch took {eng.dispatch_count - d0} dispatches")
    sh.compare("mixed-size-epoch")

    # -- E: per-target flush leaves the other lanes queued ----------------
    d0 = eng.dispatch_count
    hs = []
    for u in range(n):
        g = gw[u] + 20 * mb
        pay = rng.integers(0, 256, 4096, dtype=np.uint8)
        hs.append(dart.dart_put(ctx, g, pay))
        sh.put(g, pay)
    tgt = n // 2
    dart.dart_flush(ctx, gw[0], target=tgt)
    check(eng.dispatch_count - d0 == 1, "per-target flush dispatch count")
    check(eng.pending_ops() == n - 1,
          f"per-target flush left {eng.pending_ops()} ops, want {n - 1}")
    check(hs[tgt].state != "queued" and all(
        h.state == "queued" for u, h in enumerate(hs) if u != tgt),
        "per-target flush issued the wrong lanes")
    dart.dart_flush(ctx)
    dart.dart_waitall(hs)
    sh.compare("per-target-flush")

    # -- F: strided put + get: a column of a block x block f32 matrix ------
    u = 2 % n
    base = gw[u] + 24 * mb
    mat = rng.standard_normal((block, block)).astype(np.float32)
    dart.dart_put_blocking(ctx, base, mat)
    sh.put(base, as_bytes(mat))
    col = rng.standard_normal(block).astype(np.float32)
    c = 5 % block
    gcol = base + 4 * c
    dart.dart_put_blocking(ctx, gcol, col, stride=4 * block, count=block)
    sh.put(gcol, as_bytes(col), stride=4 * block, count=block)
    mat[:, c] = col
    c2 = 7 % block
    got, _ = dart.dart_get(ctx, base + 4 * c2, (block,),
                           torch.float32, stride=4 * block, count=block)
    check(np.array_equal(got.numpy(), mat[:, c2]), "strided get differs")
    got, _ = dart.dart_get(ctx, gcol, (block,), torch.float32,
                           stride=4 * block, count=block)
    check(np.array_equal(got.numpy(), col), "strided put/get round trip")
    sh.compare("strided")

    # -- G: one non-blocking get run over the coalesced epoch's data -------
    d0 = eng.dispatch_count
    hs = [dart.dart_get_nb(ctx, g, (epoch_bytes,), torch.uint8)
          for g in locs]
    dart.dart_waitall(hs)
    check(eng.dispatch_count - d0 == 1,
          f"get_nb run took {eng.dispatch_count - d0} dispatches")
    for g, h in zip(locs, hs):
        check(np.array_equal(h.value().numpy(), sh.read(g, epoch_bytes)),
              "get_nb value differs from the shadow heap")
    sh.compare("get-nb-run")


ACC_DTYPES = ("int32", "float32", "bfloat16")
OPS = ("sum", "prod", "min", "max")


def run_acc_phases(ctx, gw, gt, rng, *, sweep, epoch_ops: int,
                   epoch_bytes: int, overlap_ops: int, overlap_bytes: int,
                   block: int, mb: int = 1 << 20) -> None:
    """The reduction plane's phases, each checked against the shadow
    heap, which applies every accumulate in program order.  Regions:
    WORLD 28-33 ``mb`` and the strided matrix of phase F (24 ``mb``);
    DART_TEAM_ALL 2-5 ``mb``."""
    import torch
    import repro_torch.core as dart
    eng = ctx.engine
    sh = Shadow(ctx)
    for pid, arena in ctx.state.items():          # start from the device
        sh.pools[pid] = arena.cpu().numpy().copy()
    n = ctx.n_units

    # -- H: blocking f32 sum sweep, 4 B ... 2 MiB, to several units ---------
    targets = sorted({0, n // 3, n - 1})
    for size in sweep:
        for u in targets:
            g = gw[u] + 28 * mb
            vals = rand_vals(rng, "float32", size // 4)
            dart.dart_accumulate_blocking(ctx, g, vals, "sum")
            sh.accumulate(g, vals, "float32", "sum")
            got = dart.dart_get_blocking(ctx, g, (size // 4,), torch.float32)
            check(np.array_equal(got.numpy().view(np.uint8),
                                 sh.read(g, size)),
                  f"blocking accumulate of {size} B on unit {u} differs")
    sh.compare("acc-blocking-sweep")

    # -- I: coalesced disjoint f32 sum epoch, one dispatch (parallel) -------
    d0 = eng.dispatch_count
    hs = []
    for i in range(epoch_ops):
        g = gt.setunit(i % n) + 2 * mb + (i // n) * epoch_bytes
        vals = rand_vals(rng, "float32", epoch_bytes // 4)
        hs.append(dart.dart_accumulate(ctx, g, vals, "sum"))
        sh.accumulate(g, vals, "float32", "sum")
    dart.dart_flush(ctx)
    dart.dart_waitall(hs)
    check(eng.dispatch_count - d0 == 1,
          f"accumulate epoch took {eng.dispatch_count - d0} dispatches")
    sh.compare("acc-coalesced-epoch")

    # -- J: overlapping f32 sum epoch to one offset (ordered), random
    #       non-integer floats so that another order changes bits ---------
    g = gw[3 % n] + 31 * mb
    base = rand_vals(rng, "float32", overlap_bytes // 4)
    dart.dart_put_blocking(ctx, g, base)
    sh.put(g, as_bytes(base))
    d0 = eng.dispatch_count
    hs = []
    for i in range(overlap_ops):
        vals = rand_vals(rng, "float32", overlap_bytes // 4)
        hs.append(dart.dart_accumulate(ctx, g, vals, "sum"))
        sh.accumulate(g, vals, "float32", "sum")
    dart.dart_waitall(hs)
    check(eng.dispatch_count - d0 == 1,
          f"overlapping accumulate epoch took {eng.dispatch_count - d0}")
    sh.compare("acc-overlapping-epoch")

    # -- K: every op x {int32, float32, bfloat16}, overlapping within each
    #       (op, dtype) group: one ordered dispatch per group -------------
    d0 = eng.dispatch_count
    hs = []
    for di, dt in enumerate(ACC_DTYPES):
        for op in OPS:
            for j in range(3):
                u = (di + 1) % n
                g = gw[u] + 32 * mb + di * 8192 + 256 * j
                vals = rand_vals(rng, dt, 1024 // (2 if dt == "bfloat16"
                                                   else 4))
                hs.append(dart.dart_accumulate(ctx, g, as_payload(vals, dt),
                                               op))
                sh.accumulate(g, vals, dt, op)
    dart.dart_waitall(hs)
    groups = len(ACC_DTYPES) * len(OPS)
    check(eng.dispatch_count - d0 == groups,
          f"mixed op/dtype epoch took {eng.dispatch_count - d0} dispatches,"
          f" want {groups}")
    sh.compare("acc-mixed-op-dtype")

    # -- L: a run of get_accumulates in one fused dispatch ------------------
    d0 = eng.dispatch_count
    hs, want = [], []
    for i in range(epoch_ops):
        g = gt.setunit(i % n) + 4 * mb + (i // n) * epoch_bytes
        vals = rand_vals(rng, "float32", epoch_bytes // 4)
        hs.append(eng.get_accumulate(ctx.heap, ctx.teams_by_slot, g, vals,
                                     "sum"))
        want.append(sh.accumulate(g, vals, "float32", "sum"))
    dart.dart_flush(ctx)
    check(eng.dispatch_count - d0 == 1,
          f"get_accumulate run took {eng.dispatch_count - d0} dispatches")
    for h, w in zip(hs, want):
        check(np.array_equal(h.value().numpy().view(np.uint8), w),
              "get_accumulate value differs from the shadow heap")
    sh.compare("get-accumulate-run")

    # -- M: strided column accumulate + get_accumulate (len 4, stride
    #       4*block, count block) on phase F's matrix ----------------------
    base = gw[2 % n] + 24 * mb
    for c, op in ((3, "sum"), (11 % block, "max")):
        col = rand_vals(rng, "float32", block)
        kw = dict(stride=4 * block, count=block)
        dart.dart_accumulate_blocking(ctx, base + 4 * c, col, op, **kw)
        sh.accumulate(base + 4 * c, col, "float32", op, **kw)
    col = rand_vals(rng, "float32", block)
    old, _ = dart.dart_get_accumulate(ctx, base + 4 * 5, col, "prod",
                                      stride=4 * block, count=block)
    w = sh.accumulate(base + 4 * 5, col, "float32", "prod",
                      stride=4 * block, count=block)
    check(np.array_equal(old.numpy().view(np.uint8), w),
          "strided get_accumulate value differs")
    sh.compare("acc-strided")


def run_coll_phases(ctx, gt, rng, *, nbytes: int, mb: int = 1 << 20) -> int:
    """Host-plane collectives on the DART_TEAM_ALL pool (8-14 ``mb``),
    each checked against the shadow heap; returns how many ran (each
    counts one dispatch of its own)."""
    import torch
    import repro_torch.core as dart
    sh = Shadow(ctx)
    for pid, arena in ctx.state.items():
        sh.pools[pid] = arena.cpu().numpy().copy()
    rows = sh.pool_rows(gt)
    n = ctx.n_units
    count = 0

    root = 5 % n
    g = gt + 8 * mb
    pay = rng.integers(0, 256, nbytes, dtype=np.uint8)
    dart.dart_put_blocking(ctx, g.setunit(root), pay)
    dart.dart_bcast(ctx, g.setunit(root), nbytes).wait()
    rows[:, g.addr:g.addr + nbytes] = pay
    out, _ = dart.dart_gather(ctx, g, nbytes)
    count += 2
    check(np.array_equal(out.numpy(), rows[:, g.addr:g.addr + nbytes]),
          "dart_gather after dart_bcast differs")
    sh.compare("coll-bcast-gather")

    g = gt + 10 * mb
    vals = rng.integers(0, 256, (n, nbytes // 16), dtype=np.uint8)
    dart.dart_scatter(ctx, g, vals).wait()
    rows[:, g.addr:g.addr + vals.shape[1]] = vals
    count += 1
    sh.compare("coll-scatter")

    for k, (goff, root_unit) in enumerate(((12 * mb, None), (13 * mb, 3))):
        g = gt + goff
        data = rand_vals(rng, "float32", n * (nbytes // 4)).reshape(n, -1)
        dart.dart_scatter_typed(ctx, g, data).wait()
        red = np.zeros(data.shape[1], np.float32)
        for r in range(n):
            red = red + data[r]                   # the fold from +0, in order
        if root_unit is None:
            got = dart.dart_allreduce(ctx, g, (data.shape[1],),
                                      torch.float32, "sum")
            rows[:, g.addr:g.addr + nbytes] = red.view(np.uint8)
        else:
            got = dart.dart_reduce(ctx, g, (data.shape[1],), torch.float32,
                                   "sum", root=root_unit)
            rows[:, g.addr:g.addr + nbytes] = data.view(np.uint8)
            rows[root_unit, g.addr:g.addr + nbytes] = red.view(np.uint8)
        count += 2
        check(np.array_equal(got.numpy(), red),
              f"{'allreduce' if root_unit is None else 'reduce'} result "
              "differs from the sequential float32 sum")
    dart.dart_barrier(ctx)
    sh.compare("coll-allreduce-reduce")
    return count


# ----------------------------------------------------------------------------
# kernel vs plain version, timing
# ----------------------------------------------------------------------------

def tables(rng, n_rows: int, pool_bytes: int, *, epoch_ops: int,
           epoch_bytes: int, overlap_ops: int, overlap_bytes: int,
           mixed_max: int, block: int, mb: int = 1 << 20):
    """Descriptor tables at the main path's shapes, built by the same
    host packer the engine uses."""
    from repro_torch.kernels import segmented_copy as sc

    def pays(sizes):
        return [rng.integers(0, 256, s, dtype=np.uint8) for s in sizes]

    out = {}
    rows = [i % n_rows for i in range(epoch_ops)]
    offs = [(i // n_rows) * epoch_bytes for i in range(epoch_ops)]
    out["disjoint"] = sc.pack_descriptors(rows, offs, [epoch_bytes] *
                                          epoch_ops,
                                          pays([epoch_bytes] * epoch_ops))
    out["ordered"] = sc.pack_descriptors([1] * overlap_ops,
                                         [4096] * overlap_ops,
                                         [overlap_bytes] * overlap_ops,
                                         pays([overlap_bytes] * overlap_ops))
    # the mixed-size epoch's geometry (phase D): sizes 8 B … mixed_max
    # and 3 B more, offsets 0-16 B past the previous op on the same row
    rows, offs, sizes = [], [], []
    cursor = [12 * mb] * n_rows
    size = 8
    while size <= mixed_max:
        for extra in (0, 3):
            u = len(rows) % n_rows
            rows.append(u)
            offs.append(cursor[u] + int(rng.integers(0, 17)))
            sizes.append(size + extra)
            cursor[u] = offs[-1] + sizes[-1]
        size *= 2
    out["mixed"] = sc.pack_descriptors(rows, offs, sizes, pays(sizes))
    out["strided"] = sc.pack_descriptors([2], [20], [4], pays([4 * block]),
                                         strides=[4 * block], counts=[block])
    big = min(1 << 20, pool_bytes // 4)
    sizes = [8, 35, 4096, 7001, big]                    # k=5 → kb=8: padded
    offs = [3, 1000, 9000, 20000, pool_bytes - big]     # the last at pool end
    out["padded"] = sc.pack_descriptors([0, 3, 5, 7, n_rows - 1], offs,
                                        sizes, pays(sizes))
    return out


HOLD_CYCLES = 200_000      # ~0.1 ms of spinning at the H100's clock


def time_ms(fn, reps: int, flush=None) -> float:
    """Mean device ms of ``fn`` (CUDA events).  Warm: ``reps`` calls
    back to back between one pair of events.  Cold (``flush`` given):
    ``flush()`` evicts the L2 before each call, and each call is timed
    alone.  A spin kernel holds the stream first, long enough for the
    host to queue the calls behind it, so the events time the device
    and not the wrapper's host cost per call (tens of µs, more than a
    small kernel takes).  A function that waits on the device itself
    (the plain versions do) is timed with its host gaps."""
    import torch
    fn()
    torch.cuda.synchronize()
    if flush is None:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOLD_CYCLES * reps)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps
    pairs = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOLD_CYCLES)
        flush()
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def kernel_checks(arena, tabs) -> dict:
    """Every kernel against its plain version on clones of ``arena``,
    with times.  Kernel launches here go through the wrappers and so
    count; the caller reads the main path's counts before this runs."""
    import torch
    from repro_torch.kernels import segmented_copy as sc
    dev = arena.device
    res = {}

    def lanes(desc_np, seg, P):
        """Each valid lane's arena byte and flat byte, in queue order,
        and for each distinct arena byte the lane that writes it last
        (the only write an overlapping run needs: last writer wins)."""
        d = torch.from_numpy(desc_np.astype(np.int64)).to(dev)
        lane = torch.arange(seg, device=dev, dtype=torch.int64)[None, :]
        valid = lane < (d[:, sc.LEN] * d[:, sc.COUNT])[:, None]
        safe = d[:, sc.LEN].clamp(min=1)[:, None]
        dst = (d[:, sc.ROW][:, None] * P + d[:, sc.OFF][:, None]
               + (lane // safe) * d[:, sc.STRIDE][:, None] + lane % safe)
        src = d[:, sc.START][:, None] + lane
        dst, src = dst[valid], src[valid]
        uniq, inv = torch.unique(dst, return_inverse=True)
        last = torch.full((uniq.numel(),), -1, dtype=torch.int64,
                          device=dev).scatter_reduce_(
            0, inv, torch.arange(dst.numel(), device=dev), reduce="amax")
        return dst, src, last

    for name, (desc_np, flat_np, seg) in tabs.items():
        desc = torch.from_numpy(desc_np).to(dev)
        flat = torch.from_numpy(flat_np).to(dev)
        ordered = name == "ordered"
        a_k, a_r = arena.clone(), arena.clone()
        sc.scatter_cuda(a_k, desc, flat, seg=seg, ordered=ordered)
        sc.scatter_ref(a_r, desc, flat, seg=seg, ordered=ordered)
        g_k = sc.gather_cuda(a_k, desc, seg=seg)
        g_r = sc.gather_ref(a_k, desc, seg=seg)
        torch.cuda.synchronize()
        err_s = int((a_k.view(-1).int() - a_r.view(-1).int()).abs().max())
        err_g = int((g_k.int() - g_r.int()).abs().max())
        check(torch.equal(a_k, a_r),
              f"{name}: scatter kernel differs from its plain version")
        check(torch.equal(g_k, g_r),
              f"{name}: gather kernel differs from its plain version")
        print(f"kernel check {name}: kb={desc_np.shape[0]} seg={seg} "
            f"scatter{'(ordered)' if ordered else ''} == plain, "
            f"gather == plain")
        res[name] = {"scatter_err": err_s, "gather_err": err_g,
                     "desc": desc, "flat": flat, "seg": seg,
                     "desc_np": desc_np}
        del a_k, a_r, g_k, g_r

    # times at the main path's shapes: the coalesced epoch (disjoint
    # scatter, gather; 16-byte aligned), the overlapping epoch (ordered
    # scatter) and the mixed-size epoch (unaligned offsets and starts).
    # Warm: back to back, the working set left in the L2.  Cold: the L2
    # flushed before each call by writing a buffer 4x its size.
    P = arena.shape[1]
    l2 = getattr(torch.cuda.get_device_properties(dev), "L2_cache_size",
                 50 << 20)
    evict = torch.empty(4 * l2, dtype=torch.uint8, device=dev)
    timing = {}
    for kname, tab, ordered in (("scatter", "disjoint", False),
                                ("scatter_ordered", "ordered", True),
                                ("gather", "disjoint", None),
                                ("scatter@mixed", "mixed", False),
                                ("gather@mixed", "mixed", None)):
        r = res[tab]
        desc, flat, seg, desc_np = r["desc"], r["flat"], r["seg"], r["desc_np"]
        dst, src, last = lanes(desc_np, seg, P)
        distinct = last.numel()
        work = arena.clone()
        reps = 20 if ordered is not True else 5
        if ordered is None:
            def kern():
                return sc.gather_cuda(work, desc, seg=seg)

            def plain():
                return sc.gather_ref(work, desc, seg=seg)

            def lib():
                return torch.take(work.view(-1), dst)
            nbytes = desc_np.nbytes + distinct + desc_np.shape[0] * seg
            err = r["gather_err"]
        else:
            ldst, lvals = dst[last], flat[src[last]]

            def kern():
                return sc.scatter_cuda(work, desc, flat, seg=seg,
                                       ordered=ordered)

            def plain():
                return sc.scatter_ref(work, desc, flat, seg=seg,
                                      ordered=ordered)

            def lib():
                return work.view(-1).index_put_((ldst,), lvals)
            nbytes = desc_np.nbytes + 2 * distinct
            err = r["scatter_err"]
        timing[kname] = {"ms": time_ms(kern, reps),
                         "cold_ms": time_ms(kern, reps, flush=evict.zero_),
                         "plain_ms": time_ms(plain, reps),
                         "library_ms": time_ms(lib, reps),
                         "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                         "max_abs_err": err, "bytes": nbytes,
                         "shape": f"kb={desc_np.shape[0]} seg={seg} "
                                  f"lanes={dst.numel()} distinct={distinct}"}
        del work
    del evict
    return timing


def acc_tables(rng, n_rows: int, *, epoch_ops: int, epoch_bytes: int,
               overlap_ops: int, overlap_bytes: int, block: int,
               mb: int = 1 << 20):
    """The accumulate runs of the main path as the engine stages them
    (dense payloads, the (kb, 7) table): ``name -> (desc, flat, seg,
    fetch, ordered)``, float32 sum."""
    from repro_torch.kernels import segmented_copy as sc

    def flat(nbytes):
        return as_bytes(rand_vals(rng, "float32", nbytes // 4))

    rows = [i % n_rows for i in range(epoch_ops)]
    offs = [2 * mb + (i // n_rows) * epoch_bytes for i in range(epoch_ops)]
    desc, seg = sc.pack_acc_table(rows, offs, [epoch_bytes] * epoch_ops,
                                  "sum")
    pay = flat(epoch_bytes * epoch_ops)
    out = {"disjoint": (desc, pay, seg, False, False),
           "fetch": (desc, pay, seg, True, False)}
    desc, seg = sc.pack_acc_table([3 % n_rows] * overlap_ops,
                                  [31 * mb] * overlap_ops,
                                  [overlap_bytes] * overlap_ops, "sum")
    out["ordered"] = (desc, flat(overlap_bytes * overlap_ops), seg, False,
                      True)
    desc, seg = sc.pack_acc_table([2 % n_rows], [24 * mb + 12], [4], "sum",
                                  strides=[4 * block], counts=[block])
    out["strided"] = (desc, flat(4 * block), seg, False, False)
    return out


def special_case(rng, dtype: str, op: str, kind: str, shape):
    """A small accumulate run whose arena and payloads mix in NaN, ±0,
    ±inf, denormals and the largest finite values (floats), or the
    type's min, max, 0 and -1 (integers, so sums and products wrap):
    ``(arena, desc, flat, seg, fetch, ordered)``."""
    import torch
    from repro_torch.kernels import segmented_copy as sc
    tdt = getattr(torch, dtype)
    isz = tdt.itemsize

    def elems(n):
        if tdt.is_floating_point:
            info = torch.finfo(tdt)
            v = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
            sp = torch.tensor([0.0, -0.0, float("inf"), float("-inf"),
                               float("nan"), info.tiny / 4, -info.tiny / 2,
                               info.tiny, info.max, -info.max])
            pick = torch.from_numpy(rng.random(n) < 0.4)
            v[pick] = sp[torch.from_numpy(
                rng.integers(0, len(sp), int(pick.sum())))]
            return v.to(tdt).view(torch.uint8)
        info = torch.iinfo(tdt)
        v = rng.integers(info.min, info.max, n, endpoint=True)
        ext = np.array([info.min, info.max, 0, -1 if info.min < 0 else 1])
        pick = rng.random(n) < 0.3
        v[pick] = rng.choice(ext, int(pick.sum()))
        return torch.from_numpy(v.astype(np.int64)).view(torch.uint8).reshape(
            n, 8)[:, :isz].reshape(-1)

    k = int(rng.integers(3, 12))
    rows, offs, lens = [], [], []
    cursor = [0] * shape[0]
    for j in range(k):
        ne = int(rng.integers(1, 300))
        if kind == "ordered":
            rows.append(1)
            offs.append(int(rng.integers(0, 64)) * isz)
        else:
            r = j % shape[0]
            rows.append(r)
            offs.append(cursor[r] + int(rng.integers(0, 5)) * isz)
            cursor[r] = offs[-1] + ne * isz
        lens.append(ne * isz)
    desc, seg = sc.pack_acc_table(rows, offs, lens, op)
    flat = torch.cat([elems(n // isz) for n in lens])
    arena = elems(shape[0] * shape[1] // isz).reshape(shape)
    return arena, desc, flat, seg, kind == "fetch", kind == "ordered"


def acc_kernel_checks(arena, tabs, rng) -> dict:
    """Each accumulate kernel against its plain version on the card:
    the main path's tables on clones of ``arena``, then edge-value
    tables for every op x element type; times at the main path's
    shapes."""
    import torch
    from repro_torch.kernels import segmented_copy as sc
    dev = arena.device

    def both(a, desc, flat, seg, op, dtype, fetch, ordered):
        d = torch.from_numpy(desc).to(dev)
        f = (flat if isinstance(flat, torch.Tensor)
             else torch.from_numpy(flat)).to(dev)
        a_k, a_r = a.clone(), a.clone()
        k = sc.accumulate_cuda(a_k, d, f, seg=seg, op=op, dtype=dtype,
                               fetch=fetch, ordered=ordered)
        r = sc.accumulate_ref(a_r, d, f, seg=seg, op=op, dtype=dtype,
                              fetch=fetch, ordered=ordered)
        torch.cuda.synchronize()
        err = int((a_k.view(-1).int() - a_r.view(-1).int()).abs().max())
        same = torch.equal(a_k, a_r)
        if fetch:
            same = same and torch.equal(k[1], r[1])
            err = max(err, int((k[1].int() - r[1].int()).abs().max()))
        return same, err, d, f

    res = {}
    for name, (desc, flat, seg, fetch, ordered) in tabs.items():
        same, err, d, f = both(arena, desc, flat, seg, "sum", "float32",
                               fetch, ordered)
        check(same, f"accumulate table {name}: kernel differs from plain")
        print(f"kernel check acc {name}: kb={desc.shape[0]} seg={seg} "
              f"fetch={fetch} ordered={ordered}: kernel == plain")
        res[name] = (d, f, seg, err, desc)

    n_special = 0
    for dtype in sc.ACC_DTYPES:
        for op in OPS:
            for kind in ("disjoint", "ordered", "fetch"):
                a, desc, flat, seg, fetch, ordered = special_case(
                    rng, dtype, op, kind, (4, 1 << 16))
                same, err, _, _ = both(a.to(dev), desc, flat, seg, op, dtype,
                                       fetch, ordered)
                check(same, f"edge-value table {dtype} {op} {kind}: kernel "
                      f"differs from plain (max byte diff {err})")
                n_special += 1
    print(f"kernel check acc edge values: {n_special} tables (NaN, ±0, "
          f"±inf, denormals, overflow; every op x {len(sc.ACC_DTYPES)} "
          "element types) kernel == plain")

    P = arena.shape[1]
    l2 = getattr(torch.cuda.get_device_properties(dev), "L2_cache_size",
                 50 << 20)
    evict = torch.empty(4 * l2, dtype=torch.uint8, device=dev)
    timing = {}
    for kname, tab in (("accumulate", "disjoint"),
                       ("accumulate_ordered", "ordered"),
                       ("get_accumulate", "fetch"),
                       ("accumulate@strided", "strided")):
        d, f, seg, err, desc = res[tab]
        fetch, ordered = tabs[tab][3], tabs[tab][4]
        work = arena.clone()
        kw = dict(seg=seg, op="sum", dtype="float32", fetch=fetch,
                  ordered=ordered)
        dd = torch.from_numpy(desc.astype(np.int64)).to(dev)
        lane = torch.arange(0, seg, 4, device=dev, dtype=torch.int64)[None]
        valid = lane < (dd[:, sc.LEN] * dd[:, sc.COUNT])[:, None]
        safe = dd[:, sc.LEN].clamp(min=1)[:, None]
        dst = (dd[:, sc.ROW][:, None] * P + dd[:, sc.OFF][:, None]
               + (lane // safe) * dd[:, sc.STRIDE][:, None] + lane % safe)
        elems = (dst[valid] // 4)
        pay_b = int(valid.sum()) * 4
        distinct = int(torch.unique(elems).numel()) * 4
        nbytes = desc.nbytes + pay_b + 2 * distinct + (
            desc.shape[0] * seg if fetch else 0)
        lib_ms = None
        if not (fetch or ordered):
            vals = f.view(torch.float32)[
                ((dd[:, sc.START][:, None] + lane)[valid]) // 4]
            cells = work.view(-1).view(torch.float32)
            lib_ms = time_ms(lambda: cells.index_add_(0, elems, vals), 20)
        reps = 5 if ordered else 20
        timing[kname] = {
            "ms": time_ms(lambda: sc.accumulate_cuda(work, d, f, **kw), reps),
            "cold_ms": time_ms(lambda: sc.accumulate_cuda(work, d, f, **kw),
                               reps, flush=evict.zero_),
            "plain_ms": time_ms(lambda: sc.accumulate_ref(work, d, f, **kw),
                                reps),
            "library_ms": lib_ms,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "max_abs_err": err, "bytes": nbytes,
            "shape": f"kb={desc.shape[0]} seg={seg} "
                     f"payload={pay_b} B distinct={distinct} B"}
        del work
    del evict
    return timing


def host_timings(ctx, gw, gt, rng, sweep, epoch_ops, epoch_bytes,
                 mb: int = 1 << 20):
    """Host-clock µs/op of blocking put/get per size and of a coalesced
    epoch (each call ends in completion, so the clock covers the
    device work)."""
    import torch
    import repro_torch.core as dart
    n = ctx.n_units
    out = {"put_us": {}, "get_us": {}}
    for size in sweep:
        reps = 50 if size < (1 << 18) else 10
        pay = rng.integers(0, 256, size, dtype=np.uint8)
        g = gw[n - 1]
        dart.dart_put_blocking(ctx, g, pay)
        dart.dart_get_blocking(ctx, g, (size,), torch.uint8)
        t0 = time.perf_counter()
        for _ in range(reps):
            dart.dart_put_blocking(ctx, g, pay)
        out["put_us"][size] = (time.perf_counter() - t0) / reps * 1e6
        t0 = time.perf_counter()
        for _ in range(reps):
            dart.dart_get_blocking(ctx, g, (size,), torch.uint8)
        out["get_us"][size] = (time.perf_counter() - t0) / reps * 1e6
    pays = [rng.integers(0, 256, epoch_bytes, dtype=np.uint8)
            for _ in range(epoch_ops)]
    ptrs = [gt.setunit(i % n) + (i // n) * epoch_bytes
            for i in range(epoch_ops)]

    def epoch():
        hs = [dart.dart_put(ctx, p, v) for p, v in zip(ptrs, pays)]
        dart.dart_flush(ctx)
        dart.dart_waitall(hs)

    epoch()
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        epoch()
    out["coalesced_us_per_op"] = ((time.perf_counter() - t0) / reps
                                  / epoch_ops * 1e6)

    # the reduction plane: blocking f32 sum accumulate at the sweep's ends
    # and a coalesced epoch of epoch_ops accumulates (one dispatch)
    out["acc_us"] = {}
    for size in (4, sweep[-1]):
        reps = 50 if size < (1 << 18) else 10
        vals = rand_vals(rng, "float32", size // 4)
        g = gw[n - 1] + 28 * mb
        dart.dart_accumulate_blocking(ctx, g, vals)
        t0 = time.perf_counter()
        for _ in range(reps):
            dart.dart_accumulate_blocking(ctx, g, vals)
        out["acc_us"][size] = (time.perf_counter() - t0) / reps * 1e6
    accs = [rand_vals(rng, "float32", epoch_bytes // 4)
            for _ in range(epoch_ops)]

    def acc_epoch():
        hs = [dart.dart_accumulate(ctx, p, v) for p, v in zip(ptrs, accs)]
        dart.dart_flush(ctx)
        dart.dart_waitall(hs)

    acc_epoch()
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        acc_epoch()
    out["acc_coalesced_us_per_op"] = ((time.perf_counter() - t0) / reps
                                      / epoch_ops * 1e6)

    # self time per op of the two coalesced epochs, by function (cProfile
    # adds its own cost to every Python call it sees)
    out["epoch_profile"] = {}
    for name, fn in (("put", epoch), ("accumulate", acc_epoch)):
        prof = cProfile.Profile()
        prof.enable()
        for _ in range(3):
            fn()
        prof.disable()
        stats = pstats.Stats(prof).stats
        top = sorted(stats.items(), key=lambda kv: kv[1][2], reverse=True)
        per_op = 3 * epoch_ops
        out["epoch_profile"][name] = (
            sum(v[2] for v in stats.values()) / per_op * 1e6,
            [(f"{pathlib.Path(f).name}:{line}({fname})", nc / per_op,
              tt / per_op * 1e6)
             for (f, line, fname), (_, nc, tt, _, _) in top[:10]])
    return out


def host_breakdown(ctx, g, sizes, reps: int = 200) -> dict:
    """Where a blocking put and get spend their host time: each op split
    into enqueue, the lane's flush (pack, stage, launch, event) and the
    wait (for a get: wait, device→host copy and decode) at each size,
    then the PyTorch calls a dispatch makes, each timed alone.  µs per
    call on the host clock."""
    import torch
    import repro_torch.core as dart
    from repro_torch.kernels import segmented_copy as sc
    eng, dev = ctx.engine, ctx.device

    def split(start, finish, n):
        t = np.zeros(3)
        for _ in range(n):
            t0 = time.perf_counter()
            h = start()
            t1 = time.perf_counter()
            eng.flush(h.poolid, h.row)
            t2 = time.perf_counter()
            finish(h)
            t += (t1 - t0, t2 - t1, time.perf_counter() - t2)
        return t / n * 1e6                       # enqueue, flush, wait

    out = {"split": {}, "calls": {}}
    for size in sizes:
        n = reps if size < (1 << 18) else max(reps // 10, 1)
        pay = np.zeros(size, np.uint8)
        out["split"][("put", size)] = split(
            lambda: dart.dart_put(ctx, g, pay), lambda h: h.wait(), n)
        out["split"][("get", size)] = split(
            lambda: dart.dart_get_nb(ctx, g, (size,), torch.uint8),
            lambda h: h.value(), n)
        vals = np.zeros(max(size, 4) // 4, np.float32)
        out["split"][("accumulate", vals.nbytes)] = split(
            lambda: dart.dart_accumulate(ctx, g, vals), lambda h: h.wait(),
            n)

    pinned = torch.zeros(256, dtype=torch.uint8, pin_memory=True)
    small = torch.zeros(64, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev)
    done = torch.cuda.Event()
    done.record(stream)
    desc, _, seg = sc.pack_descriptors([0], [0], [1])
    d_dev = torch.from_numpy(desc).to(dev)
    f_dev = torch.zeros(1, dtype=torch.uint8, device=dev)
    target = torch.zeros((1, 4096), dtype=torch.uint8, device=dev)

    def guard():
        with torch.cuda.device(dev):
            pass

    def event():
        torch.cuda.Event().record(stream)

    calls = {
        "pack_descriptors (1 op)": lambda: sc.pack_descriptors([0], [0], [1]),
        "pinned H2D 96 B non_blocking":
            lambda: pinned[:96].to(dev, non_blocking=True),
        "torch.cuda.current_stream": lambda: torch.cuda.current_stream(dev),
        "torch.cuda.device guard": guard,
        "torch.empty (4, 16) uint8": lambda: torch.empty(
            (4, 16), dtype=torch.uint8, device=dev),
        "scatter_cuda launch (1 B)": lambda: sc.scatter_cuda(
            target, d_dev, f_dev, seg=seg, ordered=False),
        "gather_cuda launch (1 B)": lambda: sc.gather_cuda(
            target, d_dev, seg=seg),
        "Event() + record": event,
        "Event.synchronize (done)": done.synchronize,
        "D2H 64 B": small.cpu,
    }
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out["calls"][name] = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()

    # self time of each function over blocking 1 B put + get pairs
    # (cProfile adds its own cost to every Python call it sees)
    pay = np.zeros(1, np.uint8)
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(reps):
        dart.dart_put_blocking(ctx, g, pay)
        dart.dart_get_blocking(ctx, g, (1,), torch.uint8)
    prof.disable()
    stats = pstats.Stats(prof).stats
    top = sorted(stats.items(), key=lambda kv: kv[1][2], reverse=True)
    out["profile"] = [(f"{pathlib.Path(f).name}:{line}({fn})", nc / reps,
                       tt / reps * 1e6)
                      for (f, line, fn), (_, nc, tt, _, _) in top[:14]]
    out["profile_total"] = sum(v[2] for v in stats.values()) / reps * 1e6
    return out


# ----------------------------------------------------------------------------
# attention: flash_attention at llama3-8b's head geometry
# ----------------------------------------------------------------------------

def attention_cases(*, b: int, s: int, hq: int, hkv: int, hd: int,
                    rect_s: int):
    """``(name, dtype, S, T, causal)`` of the attention path."""
    return [("causal", "float32", s, s, True),
            ("causal_bf16", "bfloat16", s, s, True),
            ("rect", "float32", rect_s, s, False),
            ("rect_causal", "float32", rect_s, s, True)]


def attention_inputs(device, seed: int, case, *, b: int, hq: int, hkv: int,
                     hd: int, **_):
    """q, k, v of one case, standard normal, made on the device."""
    import torch
    _, dt, sq, t, _ = case
    g = torch.Generator(device=device)
    g.manual_seed(seed)

    def mk(*shape):
        return torch.randn(shape, generator=g, device=device).to(
            getattr(torch, dt))
    return mk(b, sq, hq, hd), mk(b, t, hkv, hd), mk(b, t, hkv, hd)


def run_attention_path(cases, inputs) -> dict:
    """The attention path: ``flash_attention`` on every case, through
    the entry point a caller uses."""
    from repro_torch.kernels import flash_attention as fa
    return {c[0]: fa.flash_attention(*inputs[c[0]], causal=c[4])
            for c in cases}


def check_close(got, want, tol: float, what: str) -> float:
    """``got`` finite and ``|got - want| <= tol + tol*|want|`` everywhere;
    returns the max abs error."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    bad = int((diff > tol + tol * w.abs()).sum())
    err = float(diff.max())
    check(torch_isfinite(g) and bad == 0,
          f"{what}: {bad} elements outside {tol} (max abs err {err})")
    return err


def torch_isfinite(x) -> bool:
    import torch
    return bool(torch.isfinite(x).all())


def attention_checks(cases, inputs, outs) -> dict:
    """Each result against the plain version and against the model's
    ``gqa_scores_and_mix`` (mask: ``causal_mask(S, T, 0)``, top-left)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers as L
    errs = {}
    for name, dt, sq, t, causal in cases:
        q, k, v = inputs[name]
        out = outs[name]
        check(out.shape == q.shape and out.dtype == q.dtype,
              f"attention {name}: {tuple(out.shape)} {out.dtype}")
        tol = ATTN_TOL[dt]
        plain = fa.flash_attention_ref(q, k, v, causal=causal)
        e_plain = check_close(out, plain, tol, f"attention {name} vs plain")
        del plain
        mask = L.causal_mask(sq, t, 0, device=q.device) if causal else None
        model = L.gqa_scores_and_mix(q, k, v, mask)
        e_model = check_close(out, model, tol,
                              f"attention {name} vs gqa_scores_and_mix")
        del model
        errs[name] = (e_plain, e_model)
        print(f"attention check {name} ({dt}, S={sq}, T={t}, causal="
              f"{causal}): kernel vs plain max abs err {e_plain:.3e}, vs "
              f"gqa_scores_and_mix {e_model:.3e} (tolerance {tol})")
    return errs


def attention_work(case, *, b: int, hq: int, hkv: int, hd: int, **_):
    """(FLOP, bytes) the inputs need: 4*hd FLOP per visible (query, key)
    pair and head; q, k, v read once, o written once."""
    _, dt, sq, t, causal = case
    pairs = (sum(min(i + 1, t) for i in range(sq)) if causal else sq * t)
    elt = 4 if dt == "float32" else 2
    return (4 * b * hq * hd * pairs,
            elt * (2 * b * sq * hq * hd + 2 * b * t * hkv * hd))


def attention_timing(cases, inputs, shape, reps: int = 10) -> dict:
    """Warm and cold device ms of the kernel, the plain version and
    ``scaled_dot_product_attention`` (the library yardstick, never
    called by the port) on each case's inputs, beside the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size",
                 50 << 20)
    evict = torch.empty(4 * l2, dtype=torch.uint8, device="cuda")
    out = {}
    for case in cases:
        name, dt, sq, t, causal = case
        q, k, v = inputs[name]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        flops, nbytes = attention_work(case, **shape)
        out[name] = {
            "ms": time_ms(lambda: fa.flash_attention_cuda(
                q, k, v, causal=causal), reps),
            "cold_ms": time_ms(lambda: fa.flash_attention_cuda(
                q, k, v, causal=causal), max(reps // 2, 1),
                flush=evict.zero_),
            "plain_ms": time_ms(lambda: fa.flash_attention_ref(
                q, k, v, causal=causal), 3),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True), reps),
            "bound_ms": max(flops / PEAK_FLOPS[dt],
                            nbytes / HBM_BYTES_PER_S) * 1e3,
            "flops": flops, "bytes": nbytes,
            "bound_by": ("operations" if flops / PEAK_FLOPS[dt]
                         >= nbytes / HBM_BYTES_PER_S else "bytes")}
    del evict
    return out


# ----------------------------------------------------------------------------
# the dense model: llama3-8b
# ----------------------------------------------------------------------------

def run_model_path(cfg, *, prompt: int, steps: int, seed: int,
                   device=None) -> dict:
    """The dense family's entry points at ``cfg``'s width and depth with
    seeded random parameters: in float32 compute, the reference's
    prefill/decode consistency check (tests/test_arch_smoke.py:66-95);
    in the config's own compute dtype, a timed prefill of ``prompt``
    tokens and ``steps`` greedy decode steps."""
    import dataclasses
    import torch
    from repro_torch.models import api
    res = {}
    t0 = time.perf_counter()
    params = api.init_params(cfg, seed, device=device)
    dev = params["embed"]["tok"].device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    res["init_s"] = time.perf_counter() - t0
    res["params"] = sum(x.numel() for _, x in api.tree_leaves(params))
    check(res["params"] == api.param_count(cfg),
          "initialised parameters differ from the schema's count")
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 1)
    tok = torch.randint(0, cfg.vocab, (1, prompt), generator=g, device=dev)
    max_seq = prompt + steps + 1

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    logits, _ = api.forward_train(cfg32, params, {"tokens": tok})
    check(logits.shape == (1, prompt, cfg.vocab) and torch_isfinite(logits),
          f"forward_train logits {tuple(logits.shape)} not finite")
    pre, cache = api.forward_prefill(cfg32, params, {"tokens": tok}, max_seq)
    check(cache["pos"] == prompt, "prefill cache position")
    res["prefill_err"] = check_close(pre[:, 0], logits[:, -1], 2e-4,
                                     "prefill vs forward_train logits")
    nxt = pre[:, 0].argmax(-1)[:, None]
    dec, _ = api.forward_decode(cfg32, params, nxt, cache)
    ext, _ = api.forward_train(cfg32, params,
                               {"tokens": torch.cat([tok, nxt], 1)})
    res["decode_err"] = check_close(dec[:, 0], ext[:, -1], 2e-3,
                                    "decode vs forward_train logits")
    del logits, pre, cache, dec, ext

    def prefill():
        return api.forward_prefill(cfg, params, {"tokens": tok}, max_seq)

    prefill()                                   # warm-up
    sync()
    t0 = time.perf_counter()
    pre, cache = prefill()
    sync()
    res["prefill_s"] = time.perf_counter() - t0
    check(torch_isfinite(pre), f"{cfg.compute_dtype} prefill logits")
    nxt = pre[:, 0].argmax(-1)[:, None]
    t0 = time.perf_counter()
    for _ in range(steps):
        logits, cache = api.forward_decode(cfg, params, nxt, cache)
        nxt = logits[:, 0].argmax(-1)[:, None]
    sync()
    res["decode_s"] = time.perf_counter() - t0
    check(torch_isfinite(logits) and cache["pos"] == prompt + steps,
          f"{cfg.compute_dtype} decode logits or cache position")
    if dev.type == "cuda":
        res["prefill_profile"] = device_profile(prefill)
        res["decode_profile"] = device_profile(
            lambda: api.forward_decode(cfg, params, nxt, cache))
    return res


def device_profile(fn, top: int = 8):
    """One call of ``fn`` under ``torch.profiler``: (wall ms, device ms
    summed over kernels, the ``top`` kernels as (device ms, calls,
    name)).  Kernels run one at a time on the one stream, so device ms
    over wall ms is the card's busy share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = (getattr(e, "self_device_time_total", None)
              or getattr(e, "self_cuda_time_total", 0))
        rows.append((us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    return wall, sum(r[0] for r in rows), rows[:top]


def card_line() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip().splitlines()[0]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    try:
        import repro_torch.core as dart
        from repro_torch.kernels import _build
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import segmented_copy as sc
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is missing ({e})",
              file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}")
    t0 = time.perf_counter()
    _build.load_all()
    print(f"build: {time.perf_counter() - t0:.2f} s, one nvcc per source "
          "in parallel")
    for name, info in _build.build_infos.items():
        print(f"build {name}: nvcc {info.get('seconds', 0.0):.2f} s")
        print(str(info.get("log", "")).strip())
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    rng = np.random.default_rng(20150707)
    ctx, gw, gt = bring_up("cuda:0", N_UNITS, POOL_BYTES, WORLD_ALLOC,
                           TEAM_ALLOC)
    check(ctx.device == torch.device("cuda", 0), "heap not on cuda:0")
    print(f"heap: {N_UNITS} units x {POOL_BYTES >> 20} MiB per pool, "
          f"{len(ctx.state)} pools on {ctx.device}")
    shapes = dict(epoch_ops=256, epoch_bytes=64 << 10, overlap_ops=64,
                  overlap_bytes=4 << 10)

    sc.clear_plan_cache()
    sc.reset_launch_counts()
    t0 = time.perf_counter()
    run_phases(ctx, gw, gt, rng, sweep=SWEEP, mixed_max=1 << 20,
               block=1024, **shapes)
    launches = dict(sc.launch_counts)
    print(f"main path: {time.perf_counter() - t0:.2f} s, "
          f"{ctx.engine.dispatch_count} dispatches, "
          f"{ctx.engine.compile_count} plans built, "
          f"{ctx.engine.plan_cache_hits} plan hits, launches {launches}")
    for k in ("scatter", "scatter_ordered", "gather"):
        check(launches[k] > 0, f"kernel {k} never launched on the main path")
    check(sum(launches[k] for k in KERNELS) == ctx.engine.dispatch_count,
          "kernel launches do not account for every dispatch")
    print(f"ref launches on CUDA arenas: {launches['ref_on_cuda']}")
    check(launches["ref_on_cuda"] == 0, "a plain version ran on a CUDA arena")

    # the reduction plane's path, counted on its own
    d0 = ctx.engine.dispatch_count
    sc.reset_launch_counts()
    t0 = time.perf_counter()
    run_acc_phases(ctx, gw, gt, rng, sweep=ACC_SWEEP, block=1024, **shapes)
    acc_launches = dict(sc.launch_counts)
    acc_dispatches = ctx.engine.dispatch_count - d0
    print(f"reduction plane: {time.perf_counter() - t0:.2f} s, "
          f"{acc_dispatches} dispatches, launches {acc_launches}")
    for k in ("accumulate", "accumulate_ordered", "get_accumulate"):
        check(acc_launches[k] > 0,
              f"kernel {k} never launched on the reduction plane's path")
    check(sum(acc_launches[k] for k in KERNELS) == acc_dispatches,
          "kernel launches do not account for every accumulate dispatch")
    check(acc_launches["ref_on_cuda"] == 0,
          "a plain version ran on a CUDA arena")

    # the host-plane collectives: plain torch ops like the reference's XLA
    # ops, each one counted dispatch; the flushes before them launch kernels
    d0 = ctx.engine.dispatch_count
    sc.reset_launch_counts()
    t0 = time.perf_counter()
    n_coll = run_coll_phases(ctx, gt, rng, nbytes=1 << 20)
    coll_launches = dict(sc.launch_counts)
    coll_dispatches = ctx.engine.dispatch_count - d0
    print(f"collectives: {time.perf_counter() - t0:.2f} s, {n_coll} "
          f"collectives, {coll_dispatches} dispatches, launches "
          f"{coll_launches}")
    check(sum(coll_launches[k] for k in KERNELS) + n_coll == coll_dispatches,
          "collective dispatches are not the collectives plus their flushes")
    check(coll_launches["ref_on_cuda"] == 0,
          "a plain version ran on a CUDA arena")
    for k in KERNELS + ("ref_on_cuda",):
        launches[k] += acc_launches[k] + coll_launches[k]

    tabs = tables(rng, N_UNITS, POOL_BYTES, block=1024, mixed_max=1 << 20,
                  **shapes)
    timing = kernel_checks(ctx.state[0], tabs)
    timing.update(acc_kernel_checks(
        ctx.state[0], acc_tables(rng, N_UNITS, block=1024, **shapes), rng))
    host = host_timings(ctx, gw, gt, rng, SWEEP, shapes["epoch_ops"],
                        shapes["epoch_bytes"])
    parts = host_breakdown(ctx, gw[N_UNITS - 1], (SWEEP[0], SWEEP[-1]))

    for k, t in timing.items():
        lib = ("none" if t["library_ms"] is None
               else f"{t['library_ms']:.6f} ms")
        print(f"time {k} [{t['shape']}]: kernel {t['ms']:.6f} ms warm, "
              f"{t['cold_ms']:.6f} ms cold, plain {t['plain_ms']:.6f} ms, "
              f"library {lib}, bound {t['bound_ms']:.6f}"
              f" ms ({t['bytes']} B at 3.35 TB/s) on {card}")
    for size in SWEEP:
        print(f"blocking {size} B: put {host['put_us'][size]:.2f} us/op, "
              f"get {host['get_us'][size]:.2f} us/op on {card}")
    print(f"coalesced epoch {shapes['epoch_ops']} x "
          f"{shapes['epoch_bytes']} B: {host['coalesced_us_per_op']:.3f} "
          f"us/op on {card}")
    for size, us in host["acc_us"].items():
        print(f"blocking accumulate (f32 sum) {size} B: {us:.2f} us/op on "
              f"{card}")
    print(f"coalesced accumulate epoch {shapes['epoch_ops']} x "
          f"{shapes['epoch_bytes']} B (f32 sum): "
          f"{host['acc_coalesced_us_per_op']:.3f} us/op on {card}")
    for name, (total, top) in host["epoch_profile"].items():
        print(f"host profile of the coalesced {name} epoch, self time per "
              f"op (total {total:.2f} us under cProfile) on {card}:")
        for fname, calls, us in top:
            print(f"  {us:9.2f} us  {calls:5.2f} calls  {fname}")
    for key, (enq, fl, wt) in parts["split"].items():
        print(f"host {key[0]} {key[1]} B: enqueue {enq:.2f} us, flush "
              f"{fl:.2f} us, wait {wt:.2f} us, total {enq + fl + wt:.2f} us"
              f" on {card}")
    for name, us in parts["calls"].items():
        print(f"host call {name}: {us:.2f} us on {card}")
    print(f"host profile of a blocking 1 B put + get, self time per pair "
          f"(total {parts['profile_total']:.2f} us under cProfile) on {card}:")
    for name, calls, us in parts["profile"]:
        print(f"  {us:9.2f} us  {calls:5.1f} calls  {name}")
    dart.dart_exit(ctx)
    del ctx, gw, gt
    torch.cuda.empty_cache()

    # the attention path, counted on its own
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cases = attention_cases(**ATTN)
    inputs = {c[0]: attention_inputs("cuda", 1000 + i, c, **ATTN)
              for i, c in enumerate(cases)}
    fa.reset_launch_counts()
    t0 = time.perf_counter()
    outs = run_attention_path(cases, inputs)
    torch.cuda.synchronize()
    attn_launches = dict(fa.launch_counts)
    print(f"attention path: {time.perf_counter() - t0:.2f} s, "
          f"{len(cases)} calls, launches {attn_launches}")
    check(attn_launches["flash"] == len(cases),
          "flash attention did not launch its kernel on every call")
    check(attn_launches["ref_on_cuda"] == 0,
          "a plain version ran on CUDA tensors")
    attn_errs = attention_checks(cases, inputs, outs)
    del outs
    attn_time = attention_timing(cases, inputs, ATTN)
    del inputs
    for (name, dt, sq, t, causal), tm in zip(cases, attn_time.values()):
        print(f"time flash_attention {name} [{dt} B={ATTN['b']} S={sq} T={t} "
              f"Hq={ATTN['hq']} Hkv={ATTN['hkv']} hd={ATTN['hd']} causal="
              f"{causal}]: kernel {tm['ms']:.6f} ms warm, {tm['cold_ms']:.6f}"
              f" ms cold, plain {tm['plain_ms']:.6f} ms, sdpa "
              f"{tm['library_ms']:.6f} ms, bound {tm['bound_ms']:.6f} ms "
              f"({tm['flops']} FLOP at {PEAK_FLOPS[dt] / 1e12:.0f} TFLOP/s, "
              f"{tm['bytes']} B at 3.35 TB/s; {tm['bound_by']}) on {card}")
    torch.cuda.empty_cache()

    # the dense model's path, counted on its own: its attention is plain
    # torch, as in the reference, so it launches no kernel of the port
    from repro_torch.configs import get_config
    cfg = get_config(MODEL_ARCH)
    fa.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = run_model_path(cfg, prompt=PROMPT, steps=DECODE_STEPS,
                           seed=20240723)
    model_launches = dict(fa.launch_counts)
    print(f"model path {MODEL_ARCH}: {time.perf_counter() - t0:.2f} s, "
          f"{model['params']} parameters ({cfg.param_dtype}, {cfg.n_layers} "
          f"layers, d_model {cfg.d_model}) initialised in "
          f"{model['init_s']:.2f} s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, "
          f"launches {model_launches}")
    check(model_launches == {"flash": 0, "ref_on_cuda": 0},
          "the model's attention went through the flash wrapper")
    print(f"model consistency (float32 compute, {PROMPT}-token prompt): "
          f"prefill vs forward_train max abs err {model['prefill_err']:.3e}"
          f" (tolerance 2e-4), decode vs forward_train "
          f"{model['decode_err']:.3e} (tolerance 2e-3)")
    print(f"model timing ({cfg.compute_dtype} compute, B=1): prefill "
          f"{PROMPT} tokens in {model['prefill_s'] * 1e3:.3f} ms = "
          f"{PROMPT / model['prefill_s']:.1f} tokens/s; {DECODE_STEPS} greedy"
          f" decode steps {model['decode_s'] / DECODE_STEPS * 1e3:.3f} "
          f"ms/token on {card}")
    for name in ("prefill", "decode"):
        wall, dev_ms, top = model[f"{name}_profile"]
        print(f"model {name} under torch.profiler: wall {wall:.3f} ms, "
              f"kernels {dev_ms:.3f} ms (busy share "
              f"{dev_ms / wall if wall else 0.0:.3f}) on {card}; top kernels:")
        for ms, calls, kname in top:
            print(f"  {ms:9.3f} ms {calls:5d} calls  {kname[:90]}")

    kernels = [{"name": f"segmented_{k}", "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[k], "launches": launches[k],
                "max_abs_err": timing[k]["max_abs_err"],
                "ms": timing[k]["ms"], "plain_ms": timing[k]["plain_ms"],
                "bound_ms": timing[k]["bound_ms"], "bound_by": "bytes",
                "library_ms": timing[k]["library_ms"]}
               for k in KERNELS]
    tm = attn_time["causal"]
    kernels.append({"name": "flash_attention", "route": "cuda",
                    "source": FLASH_SOURCE, "replaces": FLASH_REPLACES,
                    "launches": attn_launches["flash"],
                    "max_abs_err": attn_errs["causal"][0], "ms": tm["ms"],
                    "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
                    "bound_by": tm["bound_by"],
                    "library_ms": tm["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
