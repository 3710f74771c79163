"""What decides ``correct``: a sound run passes, and the control and each fault a cell can have fail.

The runs skip the look for a card and drive the rest of a run on the CPU
(the port's plain versions) at the sizes of ``conftest.tiny_files``.
"""

import time

import pytest
import torch

from portbench import harness, readings

CPU = torch.device("cpu")
MAP_CELLS = ("xl_map_o2", "urban24_hybrid_o1", "urban24_cov_o2")
SEED = 2**33 + 12_345


def run(workload: str, tiny):
    result, checks = harness.run(workload, SEED, 0.2, False, time.perf_counter(), device=CPU, files=tiny(workload))
    assert result is not None
    return result, checks


def test_a_sound_run_is_correct(workload, tiny):
    result, checks = run(workload, tiny)
    assert result["correct"], checks
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert list(result)[-1] == "checks"


def test_the_control_fails(workload, tiny):
    """The reference in bfloat16, in the program's place, fails one of the cell's limits."""
    files = tiny(workload)
    entry = harness.make_entry(files, CPU)
    entry.setup(SEED)
    numbers = readings.control_numbers(entry, torch.bfloat16)
    assert any(numbers[name] > limit for name, limit in files["limits"]["compare"].items()), numbers


def _altered_tile(original):
    def tile(*args, **kwargs):
        return 1.1 * original(*args, **kwargs)  # every amplitude 10% high

    return tile


def _half_the_tiles(original):
    def tile(*args, **kwargs):
        part = original(*args, **kwargs).clone()
        part[..., 1::2] = 0.0  # every other receiver of each tile left out
        return part

    return tile


def _from_call(first: int, fault, original, calls=None):
    """``original`` with ``fault`` planted from its ``first``-th call on (counting from 0):
    what a cache or a replay that starts after the first calls would break.
    ``calls``, a list of one, counts the calls."""
    broken, calls = fault(original), [0] if calls is None else calls

    def call(*args, **kwargs):
        calls[0] += 1
        return (broken if calls[0] > first else original)(*args, **kwargs)

    return call


@pytest.mark.parametrize("late", [False, True], ids=["from_the_start", "after_the_warm_up"])
@pytest.mark.parametrize("cell", MAP_CELLS)
@pytest.mark.parametrize("fault", [_altered_tile, _half_the_tiles], ids=["answer_altered", "half_the_batch"])
def test_a_broken_map_is_not_correct(cell, fault, late, monkeypatch, tiny):
    from differt_tpu_torch import coverage

    tiles = coverage._coverage_tile
    first = [0]
    if late:  # the warm-up map's tiles, counted on an entry of its own with the same seed
        monkeypatch.setattr(coverage, "_coverage_tile", _from_call(0, lambda f: f, tiles, first))
        entry = harness.make_entry(tiny(cell), CPU)
        entry.setup(SEED)
        entry.warm()
    monkeypatch.setattr(coverage, "_coverage_tile", _from_call(first[0], fault, tiles))
    result, checks = run(cell, tiny)
    assert not result["correct"], checks


def _unchanged(original):
    def step(scene, frequency, mesh=None, **kw):
        _, _, loss = original(scene, frequency, mesh, **kw)
        return kw["tx"], kw["eta_r"], loss

    return step


def _half_the_receivers(original):
    import dataclasses

    def step(scene, frequency, mesh=None, **kw):
        half = dataclasses.replace(scene, receivers=scene.receivers.reshape(-1, 3)[::2].contiguous())
        return original(half, frequency, mesh, **kw)  # the loss is the mean over the rest

    return step


def _altered_update(original):
    def step(scene, frequency, mesh=None, **kw):
        tx, eta_r, loss = original(scene, frequency, mesh, **kw)
        return kw["tx"] + 1.1 * (tx - kw["tx"]), eta_r, loss

    return step


@pytest.mark.parametrize("late", [False, True], ids=["from_the_start", "after_the_checked_steps"])
@pytest.mark.parametrize(
    "fault", [_unchanged, _half_the_receivers, _altered_update], ids=["state_unchanged", "half_the_batch", "answer_altered"]
)
def test_a_broken_step_is_not_correct(fault, late, monkeypatch, tiny):
    from differt_tpu_torch import parallel

    first = tiny("xl_step")["traffic"]["checked_steps"] if late else 0
    monkeypatch.setattr(parallel, "streamed_placement_step", _from_call(first, fault, parallel.streamed_placement_step))
    result, checks = run("xl_step", tiny)
    assert not result["correct"], checks
