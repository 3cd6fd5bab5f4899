"""The roofline count against a count by hand."""

import pytest

from pvbench import roofline


def test_windows_and_work_by_hand():
    # Frame 40 x 50, template 8 x 6 (th x tw), radii (3, 2): map 33 x 45.
    frame, templ, radii = (40, 50), (8, 6), (3, 2)
    start = (10, 12, 6, 8)  # center (13, 16)
    boxes = [(11, 12, 6, 8), (11, 12, 6, 8)]
    used_global = [False, True]
    w = roofline.scored_windows(start, boxes, used_global, frame, templ, radii)
    # Local window: x 13-3-3 .. 13+3-3 = 7..13, y 16-2-4 .. 16+2-4 = 10..14.
    assert w[0] == (7, 10, 13 - 7 + 6, 14 - 10 + 8)
    assert w[1] == (0, 0, 50, 40)  # the global frame reads all of it
    fma, n_bytes = roofline.chunk_work([w], templ, shared_frame=False)
    positions = 7 * 5 + 45 * 33
    assert fma == 48 * positions
    assert n_bytes == 12 * 12 + 50 * 40 + 2 * 48 * 4 + 2 * 40


def test_shared_frame_reads_the_union_once():
    a = [(0, 0, 10, 10)]
    b = [(5, 5, 10, 10)]
    assert roofline.union_pixels(a + b) == 175
    fma, n_bytes = roofline.chunk_work([a, b], (4, 4), shared_frame=True)
    assert fma == 2 * 16 * 49
    assert n_bytes == 175 + 2 * 2 * 16 * 4 + 2 * 40


def test_bound_takes_the_larger_and_the_tiers():
    ms, by = roofline.bound_ms(67e9, 1.0)
    assert by == "operations" and ms == pytest.approx(2.0)
    ms, by = roofline.bound_ms(1.0, 3.35e9)
    assert by == "bytes" and ms == pytest.approx(1.0)
    assert roofline.bound_ms(989e9, 0.0, passes=3)[0] == pytest.approx(6.0)
