"""The work counts, on shapes worked by hand."""

from __future__ import annotations

import pytest

from portbench import work


def test_ps_split():
    # degree 20: s = 7, r = 3 costs 6 + 3 * 2 = 12 products (s = 5, r = 5
    # would cost 16)
    assert work.ps_split(20) == (7, 3)
    assert work.ps_split(0) == (1, 1)


def test_taylor_work_by_hand():
    # n = 2, B = 1, 3 terms: ps_split(3) = (4, 1) (3 products; (2, 2)
    # costs 4); products 1 + 3 + 0 + 4 = 8 of 8 n^3 = 64 flops; power terms
    # k = 1, 2, 3 in 3 series = 9 at 4 flops an entry, no Horner step;
    # n^2 = 4 entries
    assert work.ps_split(3) == (4, 1)
    flops, nbytes = work.taylor_work(2, 1, 3)
    assert flops == 8 * 64 + 4 * 9 * 4
    assert nbytes == 6 * 8 * 4 + 3 * 4 * 4


def test_taylor_bound_of_the_bench_batch():
    # n = 100, B = 1024, 20 terms: 2.113 ms (the kernel table's bound)
    assert work.bound_ms(*work.taylor_work(100, 1024, 20)) == \
        pytest.approx(2.113, abs=5e-4)


def test_inverse_work_and_bound():
    assert work.inverse_work(3, 2) == (8 * 27 * 2, 2 * 8 * 9 * 2)
    assert work.bound_ms(*work.inverse_work(50, 1024)) == \
        pytest.approx(0.0153, abs=5e-5)
    assert work.bound_ms(*work.inverse_work(100, 1024)) == \
        pytest.approx(0.1223, abs=5e-5)
    assert work.cell_solve_inverses(50, 4) == [(50, 2), (100, 5)]
    assert work.cell_solve_inverses(50, 1, nv=False) == [(50, 1), (100, 3)]


def test_bound_takes_the_larger_side():
    assert work.bound_ms(67e12, 0) == pytest.approx(1e3)
    assert work.bound_ms(0, 3.35e12) == pytest.approx(1e3)


def test_solve_cell_takes_the_ports_schedule():
    """The solve cell runs the order set and slab schedule that the port
    picks for its configuration in complex64, as the port's callers do."""
    from portbench import harness
    from portbench.reference.rcwa import select_orders
    cell = harness.Cell("solve.deflector.b1024")
    orders, n_slabs, terms = cell.driver().schedule(cell.config)
    assert (orders == select_orders(1.2e-6, 3.2e-7, 50)).all()
    assert (n_slabs, terms) == (4, 20)
