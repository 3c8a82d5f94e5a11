"""projection service (port 5001).

Reference: microservices/projection_image/server.py:50-115 — validator
order matters (duplicate output name → 409 first, then parent existence
→ 406, then fields → 406), and the reference appends ``_id`` to the
requested fields before submitting (server.py:104-106).

The port's copy of ``learningorchestra_tpu/services/projection.py``.
"""

from __future__ import annotations

from learningorchestra_tpu_torch.core.jobs import JobManager
from learningorchestra_tpu_torch.core.store import DocumentStore
from learningorchestra_tpu_torch.ops.projection import project
from learningorchestra_tpu_torch.sched import HOST_CLASS, QueueFullError
from learningorchestra_tpu_torch.services import validators
from learningorchestra_tpu_torch.telemetry import register_store, span
from learningorchestra_tpu_torch.utils.web import WebApp, too_many_requests

MESSAGE_RESULT = "result"
MESSAGE_CREATED_FILE = "created_file"


def create_app(store: DocumentStore, jobs: JobManager | None = None) -> WebApp:
    app = WebApp("projection")
    jobs = jobs or JobManager()
    register_store(store)
    app.register_job_routes(jobs)
    app.register_observability(store)

    @app.route("/projections/<parent_filename>", methods=("POST",))
    def create_projection(request, parent_filename):
        body = request.get_json()
        projection_filename = body["projection_filename"]
        fields = body["fields"]
        try:
            validators.filename_free(store, projection_filename)
        except validators.ValidationError as error:
            return {MESSAGE_RESULT: error.args[0]}, 409
        try:
            validators.filename_exists(store, parent_filename)
            validators.fields_in_metadata(store, parent_filename, fields)
        except validators.ValidationError as error:
            return {MESSAGE_RESULT: error.args[0]}, 406
        # Atomic claim: concurrent duplicate creates get exactly one 201,
        # the loser a 409 (the check-then-act race SURVEY §5 flags).
        if not store.create_collection(projection_filename):
            return {MESSAGE_RESULT: validators.MESSAGE_DUPLICATE_FILE}, 409

        def work() -> None:
            with span("projection:project", parent=parent_filename):
                project(
                    store, parent_filename, projection_filename, list(fields)
                )

        # The response stays synchronous (reference parity) but the
        # work runs through the scheduler's host class: bounded
        # concurrency under load, 429 + Retry-After past the queue cap.
        try:
            jobs.run_sync(
                f"projection:{projection_filename}", work, job_class=HOST_CLASS
            )
        except QueueFullError as error:
            store.drop(projection_filename)  # release the name claim
            return too_many_requests(error)
        except BaseException:
            store.drop(projection_filename)
            raise
        return {MESSAGE_RESULT: MESSAGE_CREATED_FILE}, 201

    return app
