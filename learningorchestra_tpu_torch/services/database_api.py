"""database_api service (port 5000) — dataset CRUD.

Reference: microservices/database_api_image/server.py:33-96. Same
routes, payloads, status codes and messages; ingestion stays
asynchronous (201 immediately, rows land on a background job, the
``finished`` flag flips at the end — reference database.py:199-216) but
runs through the batched columnar ingest and a real job manager whose
failures also terminate pollers (core/jobs.py).

The port's copy of ``learningorchestra_tpu/services/database_api.py``.
"""

from __future__ import annotations

from learningorchestra_tpu_torch.core.ingest import (
    DUPLICATE_FILE,
    INVALID_URL,
    IngestError,
    ingest_csv,
    validate_csv_url,
    write_ingest_metadata,
)
from learningorchestra_tpu_torch.core.jobs import JobManager
from learningorchestra_tpu_torch.core.store import (
    METADATA_ID,
    ROW_ID,
    DocumentStore,
    UnsupportedQueryError,
    parse_query,
)
from learningorchestra_tpu_torch.sched import HOST_CLASS, QueueFullError
from learningorchestra_tpu_torch.telemetry import register_store
from learningorchestra_tpu_torch.utils.web import WebApp, too_many_requests

MESSAGE_RESULT = "result"
MESSAGE_CREATED_FILE = "file_created"
MESSAGE_DELETED_FILE = "deleted_file"
PAGINATE_FILE_LIMIT = 20


def create_app(store: DocumentStore, jobs: JobManager | None = None) -> WebApp:
    app = WebApp("database_api")
    jobs = jobs or JobManager()
    register_store(store)
    # GET /jobs (+ /trace, DELETE): every async job's state — PENDING/
    # RUNNING/FINISHED/FAILED/CANCELLED, class, attempts, timings,
    # error — inspectable and cancellable over REST instead of only via
    # each collection's metadata row.
    app.register_job_routes(jobs)
    app.register_observability(store)

    @app.route("/files", methods=("POST",))
    def create_file(request):
        body = request.get_json()
        url = body["url"]
        filename = body["filename"]
        try:
            validate_csv_url(url)
        except IngestError:
            return {MESSAGE_RESULT: INVALID_URL}, 406
        try:
            write_ingest_metadata(store, filename, url)
        except KeyError:
            return {MESSAGE_RESULT: DUPLICATE_FILE}, 409
        try:
            jobs.submit(
                f"ingest:{filename}",
                ingest_csv,
                store,
                filename,
                url,
                store=store,
                collection=filename,
                job_class=HOST_CLASS,
                # the journaled lineage: a restart that finds this job
                # admitted-but-never-started re-runs the ingest from
                # (filename, url) alone (sched/recovery.py)
                replay=("ingest", {"filename": filename, "url": url}),
            )
        except QueueFullError as error:
            # admission refused: undo the name claim so the client can
            # simply resubmit after Retry-After
            store.drop(filename)
            return too_many_requests(error)
        return {MESSAGE_RESULT: MESSAGE_CREATED_FILE}, 201

    @app.route("/files/<filename>", methods=("GET",))
    def read_file(request, filename):
        try:
            limit = int(request.args.get("limit", PAGINATE_FILE_LIMIT))
            skip = int(request.args.get("skip", 0))
        except ValueError:
            return {MESSAGE_RESULT: "invalid skip/limit"}, 400
        limit = min(limit, PAGINATE_FILE_LIMIT)
        try:
            query = parse_query(request.args.get("query"))
            documents = list(store.find(filename, query, skip=skip, limit=limit))
        except UnsupportedQueryError as error:
            return {MESSAGE_RESULT: str(error)}, 400
        except (ValueError, SyntaxError):  # unparseable query string
            return {MESSAGE_RESULT: "invalid query"}, 400
        return {MESSAGE_RESULT: documents}, 200

    @app.route("/files", methods=("GET",))
    def read_files_descriptor(request):
        result = []
        for filename in store.list_collections():
            metadata = store.find_one(filename, {ROW_ID: METADATA_ID})
            if metadata is None:
                continue
            metadata.pop(ROW_ID, None)
            result.append(metadata)
        return {MESSAGE_RESULT: result}, 200

    @app.route("/files/<filename>", methods=("DELETE",))
    def delete_file(request, filename):
        store.drop(filename)
        return {MESSAGE_RESULT: MESSAGE_DELETED_FILE}, 200

    return app
