"""The trace's arithmetic: busy time is the union of a card's operations,
idle gaps are what is left of the window, named by the host's span."""
import pytest

from portbench.lib import trace
from portbench.lib.trace import Op, Span

OPS = [Op("a", 0, 10, 20), Op("b", 0, 15, 30), Op("c", 0, 50, 60), Op("d", 1, 0, 100)]
SPANS = [Span("window", 0, 100), Span("submit", 28, 45), Span("wait", 45, 70)]


def test_busy_is_the_union_of_overlapping_operations_in_the_window():
    assert trace.busy_us(OPS, 0, 0, 100) == 30.0
    assert trace.busy_us(OPS, 0, 12, 55) == 23.0
    assert trace.busy_us(OPS, 1, 0, 100) == 100.0


def test_gaps_fill_the_rest_of_the_window():
    assert trace.gaps(OPS, 0, 0, 100) == [(0, 10), (30, 50), (60, 100)]
    assert sum(b - a for a, b in trace.gaps(OPS, 0, 0, 100)) + trace.busy_us(OPS, 0, 0, 100) == 100


def test_idle_gaps_are_named_by_the_innermost_host_span():
    got = trace.idle_gaps(OPS, SPANS, [0, 1], 0, 100)
    assert got == [["wait (cuda:0)", pytest.approx(40e-6)], ["submit (cuda:0)", pytest.approx(20e-6)],
                   ["host (cuda:0)", pytest.approx(10e-6)]]


def test_window_is_the_one_window_span():
    assert trace.window(SPANS) == (0, 100)
    with pytest.raises(ValueError):
        trace.window(SPANS + [Span("window", 0, 1)])


def test_window_starts_at_its_first_device_operation():
    """The gap before the first frame's first kernel, while the host submits
    it to an empty queue, is not the loop's idle time."""
    ops = [Op("a", 0, 12, 20), Op("early", 0, -5, 3), Op("b", 1, 15, 99)]
    assert trace.window(SPANS, ops) == (12, 100)
    assert trace.window(SPANS, []) == (0, 100)


def test_the_steady_window_starts_once_the_queue_is_full():
    """After the host's `after`-th submit in the window has ended, at the
    first device operation that starts then."""
    spans = SPANS + [Span("submit", 50, 55), Span("submit", -9, -8)]
    ops = [Op("a", 0, 12, 20), Op("b", 0, 52, 58), Op("c", 1, 60, 90), Op("d", 0, 95, 99)]
    window = trace.window(spans, ops)
    assert window == (12, 100)
    assert trace.steady(spans, ops, window, 1) == (52, 100)
    assert trace.steady(spans, ops, window, 2) == (60, 100)
    assert trace.steady(spans, ops, window, 3) == (12, 100)  # fewer submits: the whole
    assert trace.steady(spans, ops, window, 0) == (12, 100)


def test_top_ops_sum_by_name_over_cards():
    ops = OPS + [Op("a", 1, 0, 5)]
    assert trace.top_ops(ops, 2) == [["d", pytest.approx(100e-6)], ["a", pytest.approx(15e-6)]]
