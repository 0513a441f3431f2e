"""``memory_step.live_at_peak``: the replay of an allocation history that
names what holds the train step at its peak device memory (the history
itself is recorded on the card, ``python -m mdn_sfm_tpu_torch.memory_step``)."""

import os

import pytest

from mdn_sfm_tpu_torch import memory_step as M


def _frames(name: str, line: int) -> list[dict]:
    return [{"filename": os.path.join(M._PORT, name), "line": line, "name": "f"},
            {"filename": os.path.join(M._PORT, "training.py"), "line": 7, "name": "g"},
            {"filename": "/elsewhere/torch/nn/module.py", "line": 1, "name": "h"}]


def _alloc(addr, size, name="losses.py", line=1):
    return {"action": "alloc", "addr": addr, "size": size, "frames": _frames(name, line)}


def _free(addr, size, action="free_requested"):
    return {"action": action, "addr": addr, "size": size, "frames": []}


def test_peak_and_live_allocations_by_source_line():
    trace = [_alloc(1, 100), _alloc(2, 50, "ops/epipolar.py", 9), _free(1, 100), _free(1, 100, "free_completed"),
             _alloc(3, 120, line=2), _free(3, 120), _free(2, 50)]
    peak, by_where = M.live_at_peak(trace, before=1000)
    assert peak == 1170  # 1000 + 50 + 120
    assert by_where == {"before the step": [1000, 0],
                        "ops/epipolar.py:9 < training.py:7": [50, 1],
                        "losses.py:2 < training.py:7": [120, 1]}


def test_blocks_from_before_the_step_freed_during_it():
    """A block allocated before the history began and freed in it lowers
    what counts as before the step; its free_completed is not counted twice."""
    trace = [_free(77, 400), _free(77, 400, "free_completed"), _alloc(5, 300), _free(5, 300)]
    peak, by_where = M.live_at_peak(trace, before=1000)
    assert peak == 1000 and by_where == {"before the step": [1000, 0]}
    trace = [_alloc(5, 300), _free(77, 400), _alloc(6, 500, line=3)]
    peak, by_where = M.live_at_peak(trace, before=1000)
    assert peak == 1400 and by_where["before the step"] == [600, 0]
    assert by_where["losses.py:3 < training.py:7"] == [500, 1]


@pytest.mark.parametrize("frames,want", [
    ([], "outside the port"),
    ([{"filename": "/elsewhere/x.py", "line": 3, "name": "f"}], "outside the port"),
    (_frames("models/resnet.py", 40)[:1], "models/resnet.py:40"),
])
def test_where_names_the_port_frames(frames, want):
    assert M._where(frames) == want
