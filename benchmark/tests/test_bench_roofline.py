"""The byte counts of the roofline shares, from the shapes."""

import pytest

from benchmark.roofline import boxgame, digest, peaks

BOX = {"players": 2}


def test_boxgame_row():
    assert boxgame.state_bytes(BOX) == 40
    assert boxgame.input_bytes(BOX) == 2
    assert boxgame.advance_bytes(BOX, 16384) == 16384 * (40 + 2 + 40)


@pytest.mark.parametrize("sessions,d,row,want", [
    (16384, 8, 40, 16384 * 9 * 56),
    (262144, 8, 40, 262144 * 9 * 56),
    (1, 8, 40, 9 * 56),
])
def test_digest_bytes_a_tick(sessions, d, row, want):
    assert digest.digest_bytes(digest.rows_per_tick(sessions, d), row) == want


def test_state_bytes_match_the_reference_state():
    """The roofline's row is the reference state's own size, 4 B a value."""
    from benchmark.reference import boxgame as ref_box

    for config in (BOX, {"players": 4}):
        words = sum(v.numel() for v in ref_box.init_state(config).values())
        assert boxgame.state_bytes(config) == 4 * words


def test_peaks():
    assert peaks.hbm_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
    assert peaks.hbm_bytes_per_s("cpu") is None
