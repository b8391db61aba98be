"""The window's arithmetic: all the work over all the window's time."""

import pytest
from harness import window


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def run(costs, seconds=1.0):
    clock = Clock()

    def call(i):
        clock.t += costs(i)
        return i

    return window.run_window(call, seconds, lambda: None, clock=clock)


def test_per_call_ms_divides_the_whole_window():
    t0, out = run(lambda i: 0.125)
    assert len(out) == 8
    assert window.per_call_ms(t0, out) == pytest.approx(125.0)
    assert window.call_ms(t0, out) == pytest.approx([125.0] * 8)


def test_an_injected_stall_raises_solve_ms():
    t0, out = run(lambda i: 0.125)
    t0s, outs = run(lambda i: 0.125 + (0.375 if i == 3 else 0.0))
    assert window.per_call_ms(t0s, outs) > window.per_call_ms(t0, out) * 1.3
    assert max(window.call_ms(t0s, outs)) == pytest.approx(500.0)


def test_the_window_ends_with_the_call_in_flight():
    t0, out = run(lambda i: 0.3)
    # 0.3, 0.6, 0.9 are under a second; the fourth call ends at 1.2
    assert len(out) == 4
    assert out[-1][0] == pytest.approx(1.2)
