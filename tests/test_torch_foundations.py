"""The port's pure-Python foundations (global pointers, groups, teams,
teamlists, atomics, the MCS lock) against the JAX reference's, on the
same seeded inputs."""

import threading

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

import repro.core as R

import repro_torch.core as T
from repro_torch.core.gptr import ADDR_MAX, SEG_MAX, UNIT_MAX

gptr_fields = st.tuples(st.integers(0, UNIT_MAX), st.integers(0, SEG_MAX),
                        st.integers(0, (1 << 16) - 1),
                        st.integers(0, ADDR_MAX))


@settings(deadline=None, max_examples=50)
@given(gptr_fields, st.integers(-(1 << 20), 1 << 20))
def test_gptr_encoding_and_arithmetic_match(fields, n):
    r, t = R.GlobalPtr(*fields), T.GlobalPtr(*fields)
    assert t.pack() == r.pack()
    np.testing.assert_array_equal(t.to_words(), r.to_words())
    assert T.GlobalPtr.unpack(r.pack()) == t
    assert (t.is_collective, t.is_shm, t.is_null) == (
        r.is_collective, r.is_shm, r.is_null)
    try:
        want = r.incaddr(n).pack()
    except ValueError:
        with pytest.raises(ValueError):
            t.incaddr(n)
    else:
        assert t.incaddr(n).pack() == want
    assert t.setunit(3).pack() == r.setunit(3).pack()


@pytest.mark.parametrize("seed", range(4))
def test_group_algebra_matches(seed):
    rng = np.random.default_rng(seed)
    a = sorted(set(rng.integers(0, 32, 10).tolist()))
    b = sorted(set(rng.integers(0, 32, 10).tolist()))
    ra, rb = R.group_from_units(a), R.group_from_units(b)
    ta, tb = T.group_from_units(a), T.group_from_units(b)
    assert T.dart_group_union(ta, tb).members == R.dart_group_union(
        ra, rb).members
    assert T.dart_group_intersect(ta, tb).members == R.dart_group_intersect(
        ra, rb).members
    assert T.dart_group_addmember(ta, 40).members == R.dart_group_addmember(
        ra, 40).members
    assert T.dart_group_delmember(ta, a[0]).members == (
        R.dart_group_delmember(ra, a[0]).members)
    u = R.dart_group_union(ra, rb)
    for n in (1, 2, len(u.members)):
        if len(u.members) % n:
            continue
        got = T.dart_group_split(T.dart_group_union(ta, tb), n)
        assert [g.members for g in got] == [
            g.members for g in R.dart_group_split(u, n)]


@pytest.mark.parametrize("impl", ["TeamList", "FreeListTeamList"])
def test_teamlist_slots_match(impl):
    rng = np.random.default_rng(5)
    rl, tl = getattr(R, impl)(16), getattr(T, impl)(16)
    live, next_id = [], 0
    for _ in range(200):
        if live and (len(live) == 16 or rng.random() < 0.45):
            tid = live.pop(int(rng.integers(len(live))))
            assert tl.free(tid) == rl.free(tid)
        else:
            assert tl.alloc(next_id) == rl.alloc(next_id)
            live.append(next_id)
            next_id += 1
        assert tl.live() == rl.live()
    with pytest.raises(T.TeamListFullError):
        full = T.TeamList(1)
        full.alloc(0)
        full.alloc(1)


def test_team_translation_matches():
    members = (1, 4, 5, 9)
    rt = R.Team(teamid=3, group=R.DartGroup(members), slot=2)
    tt = T.Team(teamid=3, group=T.DartGroup(members), slot=2)
    for u in range(11):
        assert tt.myid(u) == rt.myid(u)
        assert tt.contains(u) == rt.contains(u)
    assert [tt.unit_at(i) for i in range(4)] == [rt.unit_at(i)
                                                 for i in range(4)]
    teams = tuple(T.Team(teamid=i, group=T.group_from_units(range(2 * i,
                                                                  2 * i + 2)),
                         slot=i) for i in range(3))
    part = T.TeamPartition(teams)
    assert part.axis_index_groups == [[0, 1], [2, 3], [4, 5]]
    assert part.team_of(3).teamid == 1


def test_atomics_and_mcs_lock():
    n = 6
    atomics = T.ThreadedAtomics(n)
    cell = atomics.make_cell("c", 2, 10)
    assert atomics.fetch_and_add(cell, 5) == 10
    assert atomics.fetch_and_store(cell, 1) == 15
    assert atomics.compare_and_swap(cell, 1, 7) == 1
    assert atomics.load(cell) == 7
    svc = T.LockService(atomics)
    lock = svc.create_lock(T.Team(teamid=0, group=T.group_from_units(
        range(n)), slot=0))
    count = {"v": 0, "in": 0, "max": 0}

    def worker(u):
        for _ in range(30):
            svc.acquire(lock, u)
            count["in"] += 1
            count["max"] = max(count["max"], count["in"])
            count["v"] += 1
            count["in"] -= 1
            svc.release(lock, u)

    threads = [threading.Thread(target=worker, args=(u,)) for u in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    assert count == {"v": n * 30, "in": 0, "max": 1}
    assert lock.is_free_hint(atomics)


def test_runtime_builds_atomics_and_locks():
    ctx = T.dart_init(n_units=4, device="cpu")
    try:
        assert isinstance(ctx.atomics, T.ThreadedAtomics)
        assert isinstance(ctx.locks, T.LockService)
        part = T.dart_team_split(ctx, T.DART_TEAM_ALL, 2)
        assert [t.group.members for t in part.teams] == [(0, 1), (2, 3)]
        tid = part.teams[1].teamid
        assert T.dart_team_size(ctx, tid) == 2
        assert T.dart_team_myid(ctx, tid, 3) == 1
        assert T.dart_team_get_group(ctx, tid).members == (2, 3)
        with pytest.raises(ValueError):
            T.dart_team_destroy(ctx, T.DART_TEAM_ALL)
    finally:
        T.dart_exit(ctx)
