"""The ``film-5.1-48k-24bit`` configuration on the CPU at a small mix:
``correct`` true for the program and false for the control (the first
window alone). The program's bytes against the configuration's reference
at 3, 6 and 8 channels are held in ``tests/test_torch_apodization.py``."""

from harness import spec
from helpers import run_cell

BENCH = spec.load()
ENCODE = spec.workload(BENCH, "film-reels-encode")


def test_program_is_correct_at_a_small_mix(capsys):
    rc, res, err = run_cell(capsys, ENCODE, spec.traffic(ENCODE["traffic"]))
    assert rc == 0 and res is not None, err
    assert res["correct"] is True, res["checks"]


def test_control_is_not_correct(capsys):
    """The control, the first window alone, writes other frames."""
    rc, res, err = run_cell(capsys, ENCODE, spec.traffic(ENCODE["traffic"]),
                            extra=("--control", "1"))
    assert rc == 0 and res is not None, err
    assert res["correct"] is False and res["checks"]["frames_wrong"]["value"] > 0
