"""The JAX package's flight-recorder tests (``tests/test_profile.py``), run
on the port's ``telemetry/profile.py`` on the CPU.

The reference's source is read and run here with every module path
pointed at the port: the five-classifier build's Chrome trace (a row a
thread, byte counter tracks, the ``h2d:`` and ``phase:write`` spans'
attribution) and its ``?format=summary``, the store wire's bytes and
decode seconds on the ``wire:`` spans, the PhaseTimer's occurrences, the
sampling profiler (named threads, one shared sampler thread under
concurrent ``/debug/profile`` requests, its counts cleared, the 403, 400
and 500 answers, the knobs) and the serve batcher's sampled
``serve:forward`` traces.

The apps, the classifier and the serve registry run on the CPU
(``device="cpu"``). The CPU copies nothing to a card, so here the
byte counters count the CPU's copies (``tests/torch_card_copies.py``,
for this module), as the chip_smoke rehearsals count them: the golden
test's ``h2d`` bytes need a copy to count.

Left out (``NOT_PORTED``): ``TestBenchCompare`` and the module's
``import bench``: they test the JAX package's benchmark script
(``bench.py --compare``), which the port does not have.
"""

import pathlib

import pytest

from learningorchestra_tpu_torch.ml import base
from learningorchestra_tpu_torch.telemetry import profile as port_profile
from tests.torch_card_copies import count_cpu_copies

REFERENCE_TESTS = pathlib.Path(__file__).with_name("test_profile.py")
NOT_PORTED = {"TestBenchCompare": "the JAX package's bench.py --compare"}
# (text in the reference's tests, its count, the port's text)
EDITS = (
    ("import bench\n", 1, ""),
    ('store, models_dir="", jobs=JobManager()', 1, 'store, models_dir="", jobs=JobManager(), device="cpu"'),
    ('make_classifier("nb").fit(X, y)', 1, 'make_classifier("nb", device="cpu").fit(X, y)'),
    ("ModelRegistry(capacity=10**9)", 1, 'ModelRegistry(capacity=10**9, device="cpu")'),
)

_source = REFERENCE_TESTS.read_text()
for _old, _count, _new in EDITS:
    assert _source.count(_old) == _count, _old
    _source = _source.replace(_old, _new)
# the benchmark script's tests end the module
_source = _source[: _source.index("class TestBenchCompare")]
_source = _source.replace("learningorchestra_tpu.", "learningorchestra_tpu_torch.")
exec(compile(_source, str(REFERENCE_TESTS), "exec"), globals())  # noqa: S102


@pytest.fixture(autouse=True, scope="module")
def cpu_copies_count():
    """The CPU's host-to-device copies count, for this module's build."""
    on_card = base._on_card
    count_cpu_copies()
    yield
    base._on_card = on_card


def test_the_reference_tests_run_on_the_port():
    """The tests above use the port's flight recorder and web layer, and
    leave out only the benchmark script's."""
    assert profile is port_profile  # noqa: F821
    assert WebApp.__module__ == "learningorchestra_tpu_torch.utils.web"  # noqa: F821
    assert "learningorchestra_tpu." not in _source
    assert "import bench" not in _source and "bench." not in _source
    for name in NOT_PORTED:
        assert name not in globals()
