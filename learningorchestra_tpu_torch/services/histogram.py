"""histogram service (port 5004).

Reference: microservices/histogram_image/server.py:35-83. Duplicate
output name → 409 with ``duplicated_filename`` (this service's string
differs from projection's ``duplicate_file`` — reference
histogram.py:25).

The port's copy of ``learningorchestra_tpu/services/histogram.py``.
"""

from __future__ import annotations

from learningorchestra_tpu_torch.core.jobs import JobManager
from learningorchestra_tpu_torch.core.store import DocumentStore
from learningorchestra_tpu_torch.ops.histogram import create_histogram
from learningorchestra_tpu_torch.sched import HOST_CLASS, QueueFullError
from learningorchestra_tpu_torch.services import validators
from learningorchestra_tpu_torch.telemetry import register_store, span
from learningorchestra_tpu_torch.utils.web import WebApp, too_many_requests

MESSAGE_RESULT = "result"
MESSAGE_CREATED_FILE = "created_file"


def create_app(store: DocumentStore, jobs: JobManager | None = None) -> WebApp:
    app = WebApp("histogram")
    jobs = jobs or JobManager()
    register_store(store)
    app.register_job_routes(jobs)
    app.register_observability(store)

    @app.route("/histograms/<parent_filename>", methods=("POST",))
    def create_histogram_route(request, parent_filename):
        body = request.get_json()
        histogram_filename = body["histogram_filename"]
        fields = body["fields"]
        try:
            validators.filename_free(
                store, histogram_filename, validators.MESSAGE_HISTOGRAM_DUPLICATE
            )
        except validators.ValidationError as error:
            return {MESSAGE_RESULT: error.args[0]}, 409
        try:
            validators.filename_exists(store, parent_filename)
            validators.fields_in_metadata(store, parent_filename, fields)
        except validators.ValidationError as error:
            return {MESSAGE_RESULT: error.args[0]}, 406
        # Atomic claim closes the duplicate-create race (SURVEY §5).
        if not store.create_collection(histogram_filename):
            return {MESSAGE_RESULT: validators.MESSAGE_HISTOGRAM_DUPLICATE}, 409

        def work() -> None:
            with span("histogram:compute", parent=parent_filename):
                create_histogram(
                    store, parent_filename, histogram_filename, list(fields)
                )

        # Synchronous response, scheduled execution: host-class width
        # bounds concurrent aggregations, the queue cap backpressures.
        try:
            jobs.run_sync(
                f"histogram:{histogram_filename}", work, job_class=HOST_CLASS
            )
        except QueueFullError as error:
            store.drop(histogram_filename)  # release the name claim
            return too_many_requests(error)
        except BaseException:
            store.drop(histogram_filename)
            raise
        return {MESSAGE_RESULT: MESSAGE_CREATED_FILE}, 201

    return app
