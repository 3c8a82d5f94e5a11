"""The JAX package's scheduler tests (``tests/test_sched.py``), run on the
port's copies of the scheduler, the retry policy, the knobs and the job
manager (``learningorchestra_tpu_torch/sched/``, ``core/jobs.py``).

Their source is read and run here with every module path pointed at the
port: admission and queue caps, priorities, the golden backoff sequence
and retries, cancellation and deadlines, the device class end to end
through the port's ``POST /models`` (a fake build, on the CPU), record
eviction, the wait race and the knobs' validation.
``test_delete_route_cancels`` drives the port's model_builder app, the
reference's drives its database_api app: both serve the same job routes.
Left out: the journal and recovery tests (``TestJournalRecovery``; the
port has no journal yet), ``test_rest_flood_429_with_retry_after`` (it
goes through the database_api ingest route, not ported), and
``test_cluster_manifest_sched_section`` (it reads the deploy scripts,
not the port).
"""

import pathlib

REFERENCE_TESTS = pathlib.Path(__file__).with_name("test_sched.py")
NOT_PORTED = {
    "TestJournalRecovery": None,
    "TestAdmissionControl": "test_rest_flood_429_with_retry_after",
    "TestKnobValidation": "test_cluster_manifest_sched_section",
}

_source = REFERENCE_TESTS.read_text().replace(
    "learningorchestra_tpu.", "learningorchestra_tpu_torch."
)
for _line in (
    "    JobJournal,\n",
    "    recover_jobs,\n",
    "from learningorchestra_tpu_torch.sched.journal import JOURNAL_COLLECTION\n",
):
    assert _line in _source, _line
    _source = _source.replace(_line, "")
for _old, _new in (
    ("services import database_api", "services import model_builder"),
    (
        "database_api.create_app(store, jobs)",
        'model_builder.create_app(store, jobs=jobs, models_dir="", device="cpu")',
    ),
    ('models_dir="", jobs=jobs\n', 'models_dir="", jobs=jobs, device="cpu"\n'),
):
    assert _old in _source, _old
    _source = _source.replace(_old, _new)
exec(compile(_source, str(REFERENCE_TESTS), "exec"), globals())  # noqa: S102
for _class, _test in NOT_PORTED.items():
    if _test is None:
        del globals()[_class]
    else:
        delattr(globals()[_class], _test)


def test_the_reference_tests_run_on_the_port():
    """The classes above build the port's manager and scheduler, and the
    port's module names are the ones they use."""
    from learningorchestra_tpu_torch.core import jobs
    from learningorchestra_tpu_torch.sched import scheduler

    assert JobManager is jobs.JobManager  # noqa: F821
    assert Scheduler is scheduler.Scheduler  # noqa: F821
    assert "learningorchestra_tpu." not in _source
