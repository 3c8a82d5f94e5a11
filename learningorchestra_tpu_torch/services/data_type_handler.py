"""data_type_handler service (port 5003).

Reference: microservices/data_type_handler_image/server.py:46-76. The
request body IS the field→type dict; success message is ``file_changed``
with status 200.

The port's copy of ``learningorchestra_tpu/services/data_type_handler.py``.
"""

from __future__ import annotations

import itertools

from learningorchestra_tpu_torch.core.jobs import JobManager
from learningorchestra_tpu_torch.core.store import DocumentStore
from learningorchestra_tpu_torch.ops.dtype import convert_field_types
from learningorchestra_tpu_torch.sched import HOST_CLASS, QueueFullError
from learningorchestra_tpu_torch.services import validators
from learningorchestra_tpu_torch.telemetry import register_store, span
from learningorchestra_tpu_torch.utils.web import WebApp, too_many_requests

MESSAGE_RESULT = "result"
MESSAGE_CHANGED_FILE = "file_changed"


def create_app(store: DocumentStore, jobs: JobManager | None = None) -> WebApp:
    app = WebApp("data_type_handler")
    jobs = jobs or JobManager()
    register_store(store)
    app.register_job_routes(jobs)
    app.register_observability(store)
    # fieldtypes passes are legitimately repeatable on one dataset (the
    # reference allows back-to-back casts), so job names take a sequence
    # suffix instead of colliding as duplicates
    conversion_seq = itertools.count()

    @app.route("/fieldtypes/<filename>", methods=("PATCH",))
    def change_data_type(request, filename):
        fields = request.get_json()
        try:
            validators.filename_exists(store, filename)
            validators.field_types_valid(store, filename, fields)
        except validators.ValidationError as error:
            return {MESSAGE_RESULT: error.args[0]}, 406

        def work() -> None:
            # the 61%-of-pipeline cast (VERDICT r5) now shows up as its
            # own span in any trace that includes a fieldtypes pass
            with span("dtype:convert", filename=filename):
                convert_field_types(store, filename, fields)

        try:
            jobs.run_sync(
                f"dtype:{filename}#{next(conversion_seq)}",
                work,
                job_class=HOST_CLASS,
            )
        except QueueFullError as error:
            return too_many_requests(error)
        return {MESSAGE_RESULT: MESSAGE_CHANGED_FILE}, 200

    return app
