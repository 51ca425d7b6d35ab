"""The measured window's whole-step rule."""
from portbench.lib import window


class Clock:
    def __init__(self, step_s):
        self.t, self.step_s, self.i = 100.0, step_s, 0

    def __call__(self):
        return self.t

    def step(self):
        self.t += self.step_s[self.i % len(self.step_s)]
        self.i += 1


def test_the_window_ends_with_the_first_step_past_the_time():
    clock = Clock([3.0])
    steps, secs, ends = window.run(clock.step, 10.0, clock)
    assert steps == 4 and secs == 12.0 and ends == [3.0, 6.0, 9.0, 12.0]


def test_a_step_ending_on_the_time_ends_the_window():
    clock = Clock([2.5])
    steps, secs, _ = window.run(clock.step, 10.0, clock)
    assert (steps, secs) == (4, 10.0)


def test_a_stall_counts_whole():
    clock = Clock([1.0, 1.0, 30.0])
    steps, secs, ends = window.run(clock.step, 10.0, clock)
    assert (steps, secs) == (3, 32.0)
    assert window.intervals(ends) == [1.0, 1.0, 30.0]

