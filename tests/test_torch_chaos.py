"""The kill -9 drill on the port's runner.

The JAX package's ``tests/test_chaos.py`` is read and run here with its
runner pointed at the port's (``learningorchestra_tpu_torch/services/
runner.py``, started as ``main(device="cpu")`` in a child process): ingest
a 120-row CSV, cast it, start an async five-classifier build with every
builder phase delayed, ``SIGKILL`` the runner once a fit's segment
progress is journaled, restart it on the same WAL and models volume.
The restarted runner must re-enqueue the build from its journal and
finish it under the same job name; no acknowledged ingest row is lost;
``/metrics`` shows the resumed job and skipped fit segments; and every
classifier's accuracy and F1 equal those of an uninterrupted build of
the same data on the healthy runner.

The reference marks its drill slow (two JAX runner boots and six
builds); on the port it takes about 15 s, so it runs in tier 1.
"""

import pathlib

REFERENCE_TESTS = pathlib.Path(__file__).with_name("test_chaos.py")

_source = REFERENCE_TESTS.read_text()
for _old, _new in (
    (
        '[sys.executable, "-m", "learningorchestra_tpu.services.runner"]',
        '[sys.executable, "-c", "from learningorchestra_tpu_torch.services.runner import main; '
        "main(device='cpu')\"]",
    ),
    ("@pytest.mark.slow\n", ""),
):
    assert _source.count(_old) == 1, _old
    _source = _source.replace(_old, _new)
exec(compile(_source, str(REFERENCE_TESTS), "exec"), globals())  # noqa: S102


def test_the_reference_drill_runs_the_port():
    assert "learningorchestra_tpu." not in _source
    assert "learningorchestra_tpu_torch.services.runner import main" in _source
    assert "pytest.mark.slow" not in _source

