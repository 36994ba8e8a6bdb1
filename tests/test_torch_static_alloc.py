"""The port's static lifetime allocator (paper §V-A) against the JAX
package's: ``allocate_static``, ``spill_order`` and ``plan_placement`` on
seeded random symbol sets must give identical offsets, peaks, spill
orders and placements, at two alignments and at HBM capacities from tight
to loose. Then the port's own counterparts of ``tests/test_coe_core.py``'s
allocator properties, on the same seeded sets (a numpy loop, not
Hypothesis, whose deadlines fail under load), and the quickstart's four
symbols."""
import numpy as np
import pytest

from repro.core import Symbol as JaxSymbol
from repro.core import allocate_static as jax_allocate_static
from repro.core import plan_placement as jax_plan_placement
from repro.core import spill_order as jax_spill_order
from repro_torch.core import (Allocation, Symbol, allocate_static,
                              plan_placement, spill_order)

N_SETS = 240
ALIGNS = (512, 4096)


def _sets(seed=0, n=N_SETS):
    """``n`` symbol sets: 1-24 symbols of 1 B-1 MiB, lifetimes of 0-30
    steps starting at 0-30, footprints up to 4 MiB, read-only at random;
    every tenth set draws its sizes from a few values, so ties in size and
    in (footprint, size) occur."""
    rs = np.random.RandomState(seed)
    out = []
    for k in range(n):
        m = int(rs.randint(1, 25))
        sizes = (rs.choice([512, 4096, 1 << 20], m) if k % 10 == 9
                 else rs.randint(1, (1 << 20) + 1, m))
        first = rs.randint(0, 31, m)
        span = rs.randint(0, 31, m)
        foot = (rs.choice([0, 1 << 20], m) if k % 10 == 9
                else rs.randint(0, (1 << 22) + 1, m))
        ro = rs.rand(m) < 0.3
        out.append([dict(name=f"s{i}", size=int(sizes[i]),
                         first_use=int(first[i]),
                         last_use=int(first[i] + span[i]),
                         read_only=bool(ro[i]),
                         transfer_footprint=int(foot[i]))
                    for i in range(m)])
    return out


SETS = _sets()


def _both(fields):
    return [Symbol(**f) for f in fields], [JaxSymbol(**f) for f in fields]


def _rnd(x, align):
    return (x + align - 1) // align * align


@pytest.mark.parametrize("align", ALIGNS)
def test_allocate_static_matches_jax(align):
    for fields in SETS:
        syms, jsyms = _both(fields)
        got, want = allocate_static(syms, align), \
            jax_allocate_static(jsyms, align)
        assert isinstance(got, Allocation)
        assert got.offsets == want.offsets, fields
        assert got.peak == want.peak, fields


def test_spill_order_matches_jax():
    for fields in SETS:
        syms, jsyms = _both(fields)
        assert [s.name for s in spill_order(syms)] == \
            [s.name for s in jax_spill_order(jsyms)]


@pytest.mark.parametrize("align", ALIGNS)
def test_plan_placement_matches_jax(align):
    """Capacities from below the largest symbol (everything spills) to the
    unspilled peak (nothing does)."""
    spilled_some = spilled_none = 0
    for fields in SETS:
        syms, jsyms = _both(fields)
        peak = allocate_static(syms, align).peak
        big = max(_rnd(f["size"], align) for f in fields)
        for cap in sorted({0, big - 1, big, peak // 3, peak // 2,
                           (3 * peak) // 4, peak - 1, peak}):
            (got, sp), (want, jsp) = plan_placement(syms, cap, align), \
                jax_plan_placement(jsyms, cap, align)
            assert sp == jsp, (fields, cap)
            assert (got.offsets, got.peak) == (want.offsets, want.peak)
            spilled_some += bool(sp)
            spilled_none += not sp
    assert spilled_some and spilled_none


@pytest.mark.parametrize("align", ALIGNS)
def test_no_live_overlap_and_peak_bounded(align):
    """Symbols whose inclusive lifetimes overlap never share an address,
    every symbol sits inside the peak, and the peak is at most the aligned
    sum."""
    for fields in SETS:
        syms, _ = _both(fields)
        alloc = allocate_static(syms, align)
        span = {s.name: (alloc.offsets[s.name],
                         alloc.offsets[s.name] + _rnd(s.size, align))
                for s in syms}
        assert all(o % align == 0 and e <= alloc.peak
                   for o, e in span.values())
        for i, a in enumerate(syms):
            for b in syms[i + 1:]:
                if a.last_use < b.first_use or b.last_use < a.first_use:
                    continue
                ra, rb = span[a.name], span[b.name]
                assert ra[1] <= rb[0] or rb[1] <= ra[0], (a, b, ra, rb)
        assert alloc.peak <= sum(_rnd(s.size, align) for s in syms)


def test_spill_order_is_bandwidth_ascending():
    for fields in SETS:
        syms, _ = _both(fields)
        keys = [(s.transfer_footprint, s.size) for s in spill_order(syms)]
        assert keys == sorted(keys)


def test_plan_placement_spills_until_fit():
    syms = [Symbol(f"w{i}", 1000, 0, 10, transfer_footprint=i * 100)
            for i in range(10)]
    alloc, spilled = plan_placement(syms, hbm_capacity=3 * 1024)
    assert alloc.peak <= 3 * 1024
    assert spilled == [f"w{i}" for i in range(len(spilled))]
    assert len(spilled) == 7 and set(alloc.offsets) == \
        {f"w{i}" for i in range(7, 10)}
    # the seeded sets: what stays fits, and a spill stops as soon as it does
    for fields in SETS[:60]:
        syms, _ = _both(fields)
        peak = allocate_static(syms).peak
        alloc, spilled = plan_placement(syms, peak // 2)
        assert alloc.peak <= peak // 2 or len(spilled) == len(syms)
        if spilled:
            rest = [s for s in syms if s.name not in spilled[:-1]]
            assert allocate_static(rest).peak > peak // 2


def test_quickstart_symbols():
    """The quickstart's four symbols: act_a (steps 1-2) and act_b (3-4)
    never live together and share an address; in a 10 MiB tier both are
    spilled (each is among the cheapest to move), as in JAX."""
    syms = [Symbol("weights", 6 << 20, 0, 100, read_only=True,
                   transfer_footprint=600 << 20),
            Symbol("kv_cache", 3 << 20, 0, 100, transfer_footprint=300 << 20),
            Symbol("act_a", 2 << 20, 1, 2, transfer_footprint=2 << 20),
            Symbol("act_b", 2 << 20, 3, 4, transfer_footprint=2 << 20)]
    alloc = allocate_static(syms)
    assert alloc.offsets["act_a"] == alloc.offsets["act_b"]
    assert alloc.peak == 11 << 20
    placed, spilled = plan_placement(syms, hbm_capacity=10 << 20)
    assert spilled == ["act_a", "act_b"] and placed.peak == 9 << 20
    jplaced, jspilled = jax_plan_placement(
        [JaxSymbol(s.name, s.size, s.first_use, s.last_use, s.read_only,
                   s.transfer_footprint) for s in syms], 10 << 20)
    assert (placed.offsets, placed.peak, spilled) == \
        (jplaced.offsets, jplaced.peak, jspilled)
