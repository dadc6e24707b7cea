"""Whole runs of the harness on the CPU at a tiny size, in a copy of the
benchmark with a configuration, traffic mixes (a sweep among them), their
cells, their checks and a metric added as files and entries only: the
harness finds them by name, and its check comes out correct on the sound
program."""

import pytest
import torch

from perfbench import harness, run
from perfbench.tests import tiny

torch.set_num_threads(1)
SEED = 2 ** 31 + 977


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    root, base = tiny.make(tmp_path_factory.mktemp("bench"))
    return harness.Spec(root=root, base=base)


@pytest.mark.parametrize("cell", tiny.CELLS + tiny.GAUSS)
def test_added_files_run_and_come_out_correct(spec, cell):
    out = run.drive(cell, SEED, 0.3, False, spec=spec, device="cpu")
    assert out["correct"] and out["failed"] == 0
    assert list(out)[-1] == "checks"
    unit = tiny.RATE[cell.split(".")[1]]
    assert set(out["metrics"]) == {"setup_s", unit, "runs_in_window"}
    assert out["metrics"]["runs_in_window"]["value"] == out["attempted"]
    gap = out["checks"]["power_gap"]
    assert 0 < gap["value"] < gap["limit"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_flagship_cell_on_card(cuda_device):
    out = run.drive("flagship256.iid", SEED, 2.0, False)
    assert out["correct"] and out["device"]["platform"] == "gpu"
