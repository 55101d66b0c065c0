"""The check fails what it must: a run driven with the timed path broken
underneath comes out not correct, once for each fault the cell can have
(a one-chip cell has no exchange between chips to leave out)."""

import pytest

from conftest import run_cell


def test_a_sound_run_is_correct(tiny):
    r = run_cell(tiny, "dla34_detect_bulk")
    assert r["rc"] == 0 and r["line"]["correct"], r["stderr"][-3000:]
    assert r["line"]["attempted"] >= 1 and r["line"]["failed"] == 0


@pytest.mark.parametrize("workload,fault", [
    ("dla34_detect_bulk", "detect_half"), ("dla34_detect_bulk", "detect_altered"),
    ("resnet18_detect_bulk", "detect_nonms"),
    ("resnet18_detect_stream", "detect_altered"),
    ("dla34_train", "train_unchanged"), ("dla34_train", "train_half"),
])
def test_a_broken_timed_path_is_not_correct(tiny, workload, fault):
    r = run_cell(tiny, workload, fault=fault)
    assert r["rc"] == 0, r["stderr"][-3000:]
    assert r["line"]["correct"] is False, r["line"]["checks"]


def test_the_train_cell_is_correct_when_sound(tiny):
    r = run_cell(tiny, "dla34_train")
    assert r["rc"] == 0 and r["line"]["correct"], r["stderr"][-3000:]
    assert set(r["line"]["metrics"]) == {"train_img_per_s", "train_peak_gib", "setup_s"}
