"""A run with its timed path broken underneath comes out not correct: the
harness's look for a chip skipped, the rest of the run driven on the CPU
at a tiny size, the port's step made to give a wrong answer where it
produces it, or to leave out half of its batch."""

import time

import pytest
import torch

from benchmark import run
import longreadmapper_tpu_torch.models.mapper as mapper_mod


def _meta_words(blob):
    return blob[:, :32].view(torch.int32)


def _shift_positions(out):
    _meta_words(out["blob"])[:, 4] += 1          # off, int32 layout


def _drop_second_half(out):
    words = _meta_words(out["blob"])
    words[words.shape[0] // 2:, 1] = 0           # found


@pytest.mark.parametrize("fault", [_shift_positions, _drop_second_half])
def test_broken_step_is_not_correct(tiny_cell, monkeypatch, fault):
    def broken(fn):
        def step(*a, **k):
            out = fn(*a, **k)
            fault(out)
            return out
        return step

    monkeypatch.setattr(mapper_mod, "map_step", broken(mapper_mod.map_step))
    monkeypatch.setattr(mapper_mod, "raw_map_step",
                        broken(mapper_mod.raw_map_step))
    parts = run.run_cell(tiny_cell, 31, 12.0, False, "cpu",
                         time.perf_counter())
    line = run.result_line(tiny_cell, parts, False, "cpu", 1)
    assert parts["counts"]["sampled"] > 0
    assert line["correct"] is False
    assert line["compared"]["records_wrong"]["value"] > 0
