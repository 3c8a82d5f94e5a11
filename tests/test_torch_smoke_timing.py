"""chip_smoke.py's device times from the profiler's trace, held on the CPU.

A trace that lost some of a kernel's launches gives a time below the
truth, so ``_device_ms`` takes a trace of the repeated calls only when it
shows ``repeats`` times the launches that a trace of one call shows, and
otherwise traces again, up to ``PROFILE_ATTEMPTS`` times. The profiler is
replaced here by a script of traces.
"""

import pytest

pytest.importorskip("torch")

import chip_smoke  # noqa: E402

KERNELS = ("gradient_pairs_kernel", "gradient_finish_kernel")
REPEATS = 20


def _scripted(monkeypatch, traces):
    """``_profile_device_us`` answering from ``traces``, a list of
    (microseconds, launches) in the order of the calls; the traces lost
    are collected afresh."""
    answers = iter(traces)
    monkeypatch.setattr(chip_smoke, "_profile_device_us", lambda torch, fn, names=None: next(answers))
    monkeypatch.setattr(chip_smoke, "LOST_TRACES", [])


def test_device_ms_of_a_whole_trace(monkeypatch):
    _scripted(monkeypatch, [(700.0, 2), (13_000.0, 2 * REPEATS)])
    assert chip_smoke._device_ms(None, None, KERNELS, REPEATS) == pytest.approx(13.0 / REPEATS)
    assert chip_smoke.LOST_TRACES == []


def test_device_ms_retakes_a_trace_that_lost_launches(monkeypatch):
    # 6 of the 20 calls' pairs kernel in the trace: a time below the bound
    _scripted(monkeypatch, [(700.0, 2), (3_756.0, 26), (700.0, 2), (13_000.0, 2 * REPEATS)])
    assert chip_smoke._device_ms(None, None, KERNELS, REPEATS) == pytest.approx(13.0 / REPEATS)
    assert chip_smoke.LOST_TRACES == [{"kernels": list(KERNELS), "launches": 26, "expected": 40}]


@pytest.mark.parametrize("lost", [(3_756.0, 26), (14_000.0, 41)])
def test_device_ms_is_not_measured_when_every_trace_disagrees(monkeypatch, lost):
    _scripted(monkeypatch, [(700.0, 2), lost] * chip_smoke.PROFILE_ATTEMPTS)
    assert chip_smoke._device_ms(None, None, KERNELS, REPEATS) is None
    assert len(chip_smoke.LOST_TRACES) == chip_smoke.PROFILE_ATTEMPTS


def test_device_ms_retakes_a_one_call_trace_that_lost_its_launch(monkeypatch):
    _scripted(monkeypatch, [(0.0, 0), (13_000.0, 2 * REPEATS), (700.0, 2), (13_000.0, 2 * REPEATS)])
    assert chip_smoke._device_ms(None, None, KERNELS, REPEATS) == pytest.approx(13.0 / REPEATS)
    assert len(chip_smoke.LOST_TRACES) == 1


def test_device_ms_holds_the_most_launches_a_one_call_trace_showed(monkeypatch):
    # a one-call trace and a trace of the calls that lost in proportion
    # do not pass for a whole trace
    _scripted(monkeypatch, [(700.0, 2), (6_500.0, 20), (350.0, 1), (6_500.0, 20), (350.0, 1), (13_000.0, 40)])
    assert chip_smoke._device_ms(None, None, KERNELS, REPEATS) == pytest.approx(13.0 / REPEATS)
    assert [trace["expected"] for trace in chip_smoke.LOST_TRACES] == [40, 40]


def test_device_ms_without_device_time_is_not_measured(monkeypatch):
    _scripted(monkeypatch, [(0.0, 2), (0.0, 2 * REPEATS)])
    assert chip_smoke._device_ms(None, None, KERNELS, REPEATS) is None


def test_check_bounds_skips_a_time_not_measured():
    entry = {"name": "tsne_grad", "ms": 0.66, "device_ms": None, "bound_ms": 0.478,
             "by_rows": {"20000:late": {"ms": 0.66, "device_ms": None, "bound_ms": 0.478}}}
    chip_smoke.check_bounds([entry])
    entry["by_rows"]["20000:late"]["device_ms"] = 0.188
    with pytest.raises(AssertionError, match="20000:late: device_ms 0.188 is below"):
        chip_smoke.check_bounds([entry])


def _calls_trace(scale: float, offset: float = 1_000.0):
    """A trace of 3 calls, each a 100 us fill then the two kernels (600 and
    25 us) with 5 us gaps, on a clock that runs at ``scale`` and starts
    at ``offset``: (name, start_us, end_us) each."""
    events, at = [], 0.0
    for _ in range(3):
        for name, length in (("fill", 100.0), ("gradient_pairs_kernel", 600.0), ("gradient_finish_kernel", 25.0)):
            events.append((name, offset + at * scale, offset + (at + length) * scale))
            at += length + 5.0
    return events


@pytest.mark.parametrize("scale", [1.0, 0.49, 1.03])
def test_trace_device_us_takes_the_clock_of_cuda_events(scale):
    # the span, first start to last end, is 3 * 740 - 5 = 2,215 us;
    # CUDA events measured it as 2.23 ms (their record around the calls)
    device_us, launches = chip_smoke._trace_device_us(_calls_trace(scale), KERNELS, 2.23)
    assert launches == 6
    assert device_us == pytest.approx(3 * 625.0 * 2_230.0 / 2_215.0)


def test_trace_device_us_of_every_device_event():
    device_us, launches = chip_smoke._trace_device_us(_calls_trace(0.49), None, 2.215)
    assert launches == 9
    assert device_us == pytest.approx(3 * 725.0)


def test_trace_device_us_without_the_kernels():
    assert chip_smoke._trace_device_us(_calls_trace(1.0), ("interpolate_kernel",), 2.2) == (0.0, 0)
    assert chip_smoke._trace_device_us([], KERNELS, 2.2) == (0.0, 0)
