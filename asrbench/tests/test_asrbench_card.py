"""On the card only (marked ``cuda``; each test decides inside itself and
skips without a card): the control, the reference computed in TF32 in
the program's place, fails the cells' limits at a size a test run holds,
the flagship's widths with fewer and shorter utterances."""

import dataclasses
import json
import os
import sys

import pytest

from asrbench import cells

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(ROOT, "asrbench"))
import control  # noqa: E402

sys.path.remove(os.path.join(ROOT, "asrbench"))


def _need_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _cell(name, **traffic):
    cell = cells.find_cell(cells.load_benchmark(ROOT), ROOT, name)
    return dataclasses.replace(cell, traffic=dict(cell.traffic, **traffic))


def _recognize_cell(**traffic):
    """The recognize cell from its files (BENCHMARK.json does not run it
    yet)."""
    def load(*parts):
        with open(os.path.join(cells.HERE, *parts)) as f:
            return json.load(f)
    path = os.path.join(cells.HERE, "traffic", "test_clean_poisson.json")
    return cells.Cell("blstm5x320.recognize", 1, "blstm5x320",
                      load("configs", "blstm5x320.json"), "test_clean_poisson",
                      dict(load("traffic", "test_clean_poisson.json"),
                           **traffic), path, [], [],
                      load("limits", "blstm5x320.recognize.json"),
                      cells.HERE)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["blstm5x320.train", "bigru5x320.train"])
def test_train_control_fails(name):
    _need_card()
    cell = _cell(name, utterances=96, length_bins_s=[[3.0, 6.0, 1.0]])
    cell.traffic["train_flags"] = dict(cell.traffic["train_flags"],
                                       **{"minibatch-size": 16})
    for seed in (1, 2, 3):
        readings = control.control_train(cell, seed)
        assert any(readings[k] > cell.limits[k] for k in readings), readings


@pytest.mark.cuda
def test_recognize_control_fails():
    _need_card()
    cell = _recognize_cell(rate_per_s=2.0)
    for seed in (1, 2, 3):
        readings = control.control_recognize(cell, seed, 4.0)
        assert readings["label_gap"] > cell.limits["label_gap"], readings
