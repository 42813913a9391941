"""The ``vectorwar4-d8`` configuration on the CPU: its bytes, its rules as
the configuration file states them, and its cell's run reading correct, with
the control and each fault reading not correct."""

import json
import time

import pytest
import torch

from benchmark import harness, spec, variants
from benchmark.reference import vectorwar as ref
from benchmark.roofline import vectorwar as roof
from benchmark.tests.conftest import ROOT

CELL = "vectorwar4-d8-host"
CONFIG = json.loads((ROOT / "benchmark" / "configs" / "vectorwar4-d8.json").read_text())


def test_bytes_are_the_reference_states_words():
    words = sum(v.numel() for v in ref.init_state(CONFIG).values())
    assert roof.state_bytes(CONFIG) == 4 * words == 2528
    assert roof.input_bytes(CONFIG) == 4
    assert roof.advance_bytes(CONFIG, 10) == 10 * (2 * 2528 + 4)


def test_rules_are_the_configurations():
    rules = CONFIG["rules"]
    assert (rules["MAX_BULLETS"], rules["STARTING_HEALTH"], rules["ROTATE_INCREMENT"]) == \
        (ref.SLOTS, ref.HEALTH, ref.ROTATE)
    assert (rules["SHIP_RADIUS"], rules["BULLET_SPEED"], rules["BULLET_COOLDOWN"],
            rules["BULLET_DAMAGE"]) == (ref.RADIUS, ref.BULLET_SPEED, ref.COOLDOWN, ref.DAMAGE)
    assert ref.THRUST == int(rules["SHIP_THRUST"] * ref.ONE)
    assert ref.MAX_THRUST == rules["SHIP_MAX_THRUST"] * ref.ONE
    assert rules["MAX_SHIPS"] == CONFIG["players"] == ref.players(CONFIG)
    bits = rules["inputs"]
    assert (bits["THRUST"], bits["BREAK"], bits["ROTATE_LEFT"], bits["ROTATE_RIGHT"],
            bits["FIRE"]) == (ref.THRUST_BIT, ref.BRAKE_BIT, ref.LEFT_BIT, ref.RIGHT_BIT,
                              ref.FIRE_BIT)


def test_float32_control_departs_from_the_integers():
    st = {k: v.expand(8, *v.shape).clone() for k, v in ref.init_state(CONFIG).items()}
    wide = {k: v.to(torch.float32) for k, v in st.items()}
    gen = torch.Generator().manual_seed(5)
    for _ in range(30):
        inp = torch.randint(0, 32, (8, 4), dtype=torch.uint8, generator=gen)
        st = ref.advance(st, inp, CONFIG)
        wide = ref.advance(wide, inp, CONFIG, torch.float32)
    assert any(not torch.equal(wide[k].to(torch.int64), st[k]) for k in ("pos", "bullet_pos"))


def _run(advance=None, sessions=4):
    cell = spec.load_cell(CELL)
    return harness.run_cell(cell, 2**33 + 23, 0.3, False, "cpu", time.perf_counter(),
                            sessions=sessions, advance=advance)


def test_the_cell_reads_correct():
    line, lines = _run()
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == {"resim_frames_per_s", "tick_ms_p95", "setup_s"}
    assert all(v["value"] == 0 for v in line["checks"].values())
    assert lines[-1] == "check correct true"


@pytest.mark.parametrize("name", variants.NAMES)
def test_the_control_and_the_faults_read_not_correct(name):
    with variants.variant(name, spec.load_cell(CELL)) as step:
        line, lines = _run(advance=step)
    assert line["correct"] is False and lines[-1] == "check correct false"
    off = {k for k, v in line["checks"].items() if v["value"] > v["limit"]}
    # the control and a step that does nothing leave every session's state
    # wrong; half the batch leaves half; an altered digest only the digests
    want = {"control": {"live_rows_off", "ring_rows_off", "digest_rows_off"},
            "unchanged": {"live_rows_off", "ring_rows_off", "digest_rows_off"},
            "half": {"live_rows_off", "ring_rows_off", "digest_rows_off"},
            "altered": {"ring_rows_off", "digest_rows_off"}}[name]
    assert off == want


def test_the_sweep_prints_a_line_a_batch(capsys):
    from benchmark import sweep

    argv = ["--workload", CELL, "--seed", str(2**33 + 7), "--seconds", "0.2",
            "--sessions", "2,4", "--device", "cpu"]
    assert sweep.main(argv) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["sessions"] for x in lines] == [2, 4]
    assert all(x["calls"] > 0 and x["p95_ms"] >= x["p50_ms"] > 0 for x in lines)
    assert all(x["resim_frames_per_s"] > 0 for x in lines)
