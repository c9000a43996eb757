"""The window's arithmetic: the rate is all frames over all the time, and a
frame stalled mid-window moves both the rate and the tail."""
import pytest

from portbench.lib import window


def test_intervals_add_up_to_the_window():
    ends = [10.0, 21.0, 30.5, 52.0]
    iv = window.intervals_ms(0.0, ends)
    assert iv == [10.0, 11.0, 9.5, 21.5]
    assert sum(iv) == ends[-1]
    assert window.frame_ms(iv) == pytest.approx(52.0 / 4)


def test_rate_is_all_frames_over_all_time_not_a_median_of_chunks():
    iv = [10.0] * 50 + [30.0] * 10
    # chunks of 10 would give a median of 10; the window's rate counts all
    assert window.frame_ms(iv) == pytest.approx((500 + 300) / 60)


@pytest.mark.parametrize("n", [10, 19])
def test_a_stall_mid_window_moves_frame_ms_and_p95(n):
    steady = [16.0] * n
    stalled = list(steady)
    stalled[n // 2] = 120.0
    assert window.frame_ms(stalled) > window.frame_ms(steady)
    assert window.frame_ms_p95(stalled) > window.frame_ms_p95(steady)


def test_stalls_in_more_than_a_twentieth_of_frames_move_p95():
    iv = [10.0] * 190 + [40.0] * 10
    assert window.frame_ms_p95(iv) == 10.0  # 5% of frames: the 95th is still steady
    iv = [10.0] * 189 + [40.0] * 11
    assert window.frame_ms_p95(iv) == 40.0


def test_percentile_nearest_rank():
    assert window.percentile([3.0, 1.0, 2.0, 4.0], 50) == 2.0
    assert window.percentile(list(range(1, 101)), 95) == 95
    with pytest.raises(ValueError):
        window.percentile([], 95)
