"""The JAX package's scheduler tests (``tests/test_sched.py``), run on the
port's copies of the scheduler, the retry policy, the knobs, the job
manager, the journal and recovery (``learningorchestra_tpu_torch/sched/``,
``core/jobs.py``).

Their source is read and run here with every module path pointed at the
port: admission and queue caps (the REST flood's 429 + ``Retry-After``
through the port's ``database_api``), priorities, the golden backoff
sequence and retries, cancellation and deadlines, the journal's
lifecycle records and recovery after a restart (``TestJournalRecovery``),
the device class end to end through the port's ``POST /models`` (a fake
build, on the CPU), record eviction, the wait race and the knobs'
validation, and the cluster manifest's sched section on the port's
cluster driver (``learningorchestra_tpu_torch/deploy/cluster.py``).
"""

import pathlib

REFERENCE_TESTS = pathlib.Path(__file__).with_name("test_sched.py")
CLUSTER_IMPORT = (
    '        sys.path.insert(0, "deploy")\n        try:\n            import cluster\n'
    '        finally:\n            sys.path.pop(0)\n'
)

_source = REFERENCE_TESTS.read_text().replace(
    "learningorchestra_tpu.", "learningorchestra_tpu_torch."
)
_old, _new = 'models_dir="", jobs=jobs\n', 'models_dir="", jobs=jobs, device="cpu"\n'
assert _source.count(_old) == 2, _old  # the two device-class tests
_source = _source.replace(_old, _new)
assert _source.count(CLUSTER_IMPORT) == 1
_source = _source.replace(CLUSTER_IMPORT, "        from learningorchestra_tpu_torch.deploy import cluster\n")
exec(compile(_source, str(REFERENCE_TESTS), "exec"), globals())  # noqa: S102


def test_the_reference_tests_run_on_the_port():
    """The classes above build the port's manager and scheduler, and the
    port's module names are the ones they use."""
    from learningorchestra_tpu_torch.core import jobs
    from learningorchestra_tpu_torch.sched import scheduler

    assert JobManager is jobs.JobManager  # noqa: F821
    assert Scheduler is scheduler.Scheduler  # noqa: F821
    assert "learningorchestra_tpu." not in _source
