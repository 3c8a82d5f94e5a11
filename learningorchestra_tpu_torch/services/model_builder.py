"""model_builder service (port 5002): builds and the online predict lane.

Counterpart of ``learningorchestra_tpu/services/model_builder.py``:

- ``POST /models`` builds the requested classifiers (lr, dt, rf, gb,
  nb) from a training and a test collection and the user's
  ``preprocessor_code`` (reference ``:201-295``). Synchronous by default,
  as the reference's server.py:112-115: 201 after every fit. With
  ``"async": true`` it answers 201 with the job's name at once and the
  build runs as a tracked job (``GET /jobs/<name>``, ``/wait``). Either
  way the build runs in the scheduler's DEVICE class, one at a time on
  the card: a full queue answers 429 + ``Retry-After``, an active
  duplicate async build 409, an unknown collection or classifier 406.
  The job journals its ``build_model`` replay payload, so a restarted
  runner re-runs or resumes it (sched/recovery.py);
- ``POST /models/sweep`` fits a λ grid over ``lr`` or a depth grid over
  ``dt`` as one coalescible DEVICE job (``ml/sweep.run_sweep``, reference
  ``:297-360``): per-point metrics in the answer and persisted as
  collection ``sweep_name``, the winner's checkpoint published so
  ``POST /models/<sweep_name>/predict`` serves it; 406 on a malformed
  request, 409 on a taken name or a running sweep of that name, 429 on a
  full queue;
- ``GET /models`` lists the ``.model`` artifacts in ``models_dir`` (the
  names under ``"result"``, the serve plane's stats under ``"serving"``);
- ``GET /models/<name>`` describes one artifact;
- ``POST /models/<name>/predictions`` (the batch lane, reference
  ``:459-523``) re-runs the preprocessor over a training and a test
  collection and predicts the whole test collection from the saved
  ``.model``, with no refit (``ml/builder.predict_with_model``), into
  collection ``prediction_filename``: 201 when written, 406 on missing
  fields, an unknown training or test collection or an unsafe name, 404
  on an unknown model, 409 on a taken prediction name, 429 on a full
  device queue; a concurrent duplicate runs again under a ``#dup`` job
  name, as the reference's;
- ``POST /models/<name>/predict`` takes ``{"rows": [[...], ...]}`` and
  answers labels and probabilities in one synchronous response. Requests
  go through the serve plane: the model's parameters stay pinned on the
  device and concurrent requests are joined into one forward;
- the job routes (``/jobs``, ``/jobs/<name>``, ``/wait``, ``/trace``,
  ``/profile``, ``DELETE``), ``/health``, ``/metrics`` and the
  observability routes (``/debug/*``, ``/traces/<cid>``,
  ``/metrics/history``, ``/metrics/ingest``; ``utils/web.py``).

A checkpoint that a build or a sweep publishes into ``models_dir`` is
warmed (``compile/warmup.py``): the app registers the process-wide
publish handler, which submits a ``warmup:<file>`` DEVICE job at
priority -5 that pins the model in the serve registry and runs one
forward at the serving dispatch shape.

Messages and status codes are the reference's: 404 unknown model, 406
missing or malformed rows, 413 more than ``LO_SERVE_MAX_ROWS`` rows, 429
inbox or queue full, 503 timed out, 500 ``prediction_failed: ...``.
"""

from __future__ import annotations

import itertools
import json
import os
import time
import zipfile
from typing import Optional

import numpy as np

from learningorchestra_tpu_torch.core.jobs import DuplicateJobError, JobManager
from learningorchestra_tpu_torch.core.store import DocumentStore
from learningorchestra_tpu_torch.device import DeviceLike, resolve_device
from learningorchestra_tpu_torch.ml import sweep as lo_sweep
from learningorchestra_tpu_torch.ml.base import CLASSIFIER_NAMES
from learningorchestra_tpu_torch.ml.builder import build_model, predict_with_model
from learningorchestra_tpu_torch.ml.checkpoint import (
    CHECKPOINT_SUFFIX,
    checkpoint_path as _checkpoint_path,
)
from learningorchestra_tpu_torch.sched import DEVICE_CLASS, QueueFullError, global_coalescer
from learningorchestra_tpu_torch.serve import (
    ModelNotFoundError,
    ServePlane,
    global_serve_plane,
)
from learningorchestra_tpu_torch.serve import config as serve_config
from learningorchestra_tpu_torch.serve.batcher import LATENCY_BUCKETS
from learningorchestra_tpu_torch.services import validators
from learningorchestra_tpu_torch.telemetry import register_store
from learningorchestra_tpu_torch.utils.web import WebApp, too_many_requests

MESSAGE_RESULT = "result"
MESSAGE_CREATED_FILE = "created_file"
MESSAGE_INVALID_ROWS = "invalid_rows"
MESSAGE_SERVE_TIMEOUT = "predict_timeout"
MESSAGE_TOO_MANY_ROWS = "too_many_rows"


def create_app(
    store: DocumentStore,
    build=None,
    models_dir: Optional[str] = None,
    jobs: Optional[JobManager] = None,
    serve: Optional[ServePlane] = None,
    device: DeviceLike = None,
    coalescer=None,
    predict=None,
) -> WebApp:
    """The builder and the predict lane over ``store`` and the checkpoints
    in ``models_dir`` (default ``LO_MODELS_DIR``). ``device=None`` means
    CUDA and raises without a card. ``build(body)`` overrides how a
    validated request body becomes a :func:`build_model` call, and
    ``predict(model_name, body)`` how one becomes a
    :func:`predict_with_model` call; ``jobs``
    injects a ``JobManager`` (tests pin its scheduler), else the app
    owns one; ``serve`` injects a plane (tests pin its knobs), else the
    process-wide plane of ``device`` serves; ``coalescer`` injects the
    sweeps' coalescing stage, else the process-wide one (so sweeps
    submitted through different apps in one process still fuse)."""
    device = resolve_device(device)
    if serve is None:
        serve = global_serve_plane(device)
    elif serve.device != device:
        raise ValueError(f"serve plane runs on {serve.device}, the app on {device}")
    models_dir = models_dir or os.environ.get("LO_MODELS_DIR")
    jobs = jobs or JobManager()
    coalescer = coalescer or global_coalescer()
    # resolve every serving knob now: a malformed value breaks app
    # construction instead of answering 500 on a live route
    serve_knobs = serve_config.validate_all()
    serve_timeout_s = serve_knobs["request_timeout_s"]
    serve_max_rows = serve_knobs["max_rows"]
    app = WebApp("model_builder")
    register_store(store)
    app.register_job_routes(jobs)
    app.register_observability(store)
    # the serve_p99 SLO reads it (telemetry/slo.py)
    serve_seconds = app.registry.histogram(
        "lo_serve_request_seconds",
        "End-to-end predict latency (admission to response build)",
        buckets=LATENCY_BUCKETS,
    )
    # Publish-time serve warmup (compile/warmup.py): when a build or a
    # sweep publishes a checkpoint into this app's models_dir, a
    # low-priority DEVICE job (the scheduler's heap prefers larger
    # values) loads it through the serve registry and runs the fixed
    # dispatch shape, so the first POST /models/<name>/predict finds the
    # model pinned and its kernels loaded. Process-wide handler, latest
    # app wins; a checkpoint published elsewhere is left alone.
    from learningorchestra_tpu_torch import compile as lo_compile

    def on_checkpoint_published(path: str, features) -> None:
        if not models_dir or os.path.dirname(os.path.abspath(path)) != os.path.abspath(models_dir):
            return

        def warm() -> None:
            from learningorchestra_tpu_torch.compile.warmup import warm_artifact

            warm_artifact(path, features=features, serve=serve)

        try:
            jobs.submit(f"warmup:{os.path.basename(path)}", warm, job_class=DEVICE_CLASS, priority=-5)
        except (DuplicateJobError, QueueFullError):
            # a republish racing its own warmup, or a full device queue:
            # the publication stands, the first predict pays the load
            pass

    lo_compile.set_publish_handler(on_checkpoint_published)
    # the reference lets a concurrent same-name sync build run too (racy
    # allow-both, server.py:112-115); the duplicate still goes through
    # the device queue, under a uniquified job name
    duplicate_seq = itertools.count(1)

    if build is None:

        def build(body: dict) -> None:
            build_model(
                store,
                body["training_filename"],
                body["test_filename"],
                body["preprocessor_code"],
                body["classificators_list"],
                device=device,
                models_dir=models_dir,
            )

    def checkpoint_path(name: str) -> str:
        return _checkpoint_path(models_dir, name)

    if predict is None:

        def predict(model_name: str, body: dict) -> None:
            predict_with_model(
                store,
                checkpoint_path(model_name),
                body["training_filename"],
                body["test_filename"],
                body["preprocessor_code"],
                body["prediction_filename"],
                device=device,
            )

    def artifact_exists(name: str) -> bool:
        return bool(
            models_dir
            and validators.safe_filename(name)
            and os.path.isfile(checkpoint_path(name))
        )

    @app.route("/models", methods=("POST",))
    def create_model(request):
        body = request.get_json()
        try:
            validators.filename_exists(
                store,
                body["training_filename"],
                validators.MESSAGE_INVALID_TRAINING_FILENAME,
            )
        except validators.ValidationError as error:
            return {MESSAGE_RESULT: error.args[0]}, 406
        try:
            validators.filename_exists(
                store,
                body["test_filename"],
                validators.MESSAGE_INVALID_TEST_FILENAME,
            )
        except validators.ValidationError as error:
            return {MESSAGE_RESULT: error.args[0]}, 406
        for name in body["classificators_list"]:
            if name not in CLASSIFIER_NAMES:
                return {
                    MESSAGE_RESULT: validators.MESSAGE_INVALID_CLASSIFICATOR
                }, 406
        job_name = (
            f"build:{body['test_filename']}:"
            f"{'+'.join(body['classificators_list'])}"
        )
        # the journaled replay payload: everything recovery needs to re-run
        # (or resume) this build after a crash, without the closure.
        # models_dir rides along (a restarted process resolves no
        # request-scoped state); the device does not (the restarted
        # runner brings its own)
        replay = (
            "build_model",
            {
                "training_filename": body["training_filename"],
                "test_filename": body["test_filename"],
                "preprocessor_code": body["preprocessor_code"],
                "classificators_list": list(body["classificators_list"]),
                "models_dir": models_dir,
            },
        )
        if body.get("async"):
            try:
                jobs.submit(job_name, build, body, job_class=DEVICE_CLASS, replay=replay)
            except QueueFullError as error:  # device queue at its cap
                return too_many_requests(error)
            except ValueError as error:  # same job already active
                return {MESSAGE_RESULT: str(error)}, 409
            return {MESSAGE_RESULT: MESSAGE_CREATED_FILE, "job": job_name}, 201
        # synchronous: the reference's contract (201 after every fit), run
        # as a tracked job in the DEVICE class so concurrent builds queue
        # for the card; the request thread waits, a scheduler worker runs
        try:
            jobs.run_sync(job_name, build, body, job_class=DEVICE_CLASS, replay=replay)
        except QueueFullError as error:
            return too_many_requests(error)
        except DuplicateJobError:
            # already active: the reference runs it again. Not a bare
            # ValueError — run_sync re-raises the build's own exceptions,
            # and a build that failed with ValueError must not run twice
            try:
                jobs.run_sync(
                    f"{job_name}#dup{next(duplicate_seq)}",
                    build,
                    body,
                    job_class=DEVICE_CLASS,
                    replay=replay,
                )
            except QueueFullError as error:
                return too_many_requests(error)
        return {MESSAGE_RESULT: MESSAGE_CREATED_FILE}, 201

    @app.route("/models/sweep", methods=("POST",))
    def sweep_models(request):
        """A hyperparameter sweep as one device job: a λ grid over ``lr``
        or a depth grid over ``dt`` fitted over one job axis
        (ml/sweep.py), per-point metrics in the answer and persisted as
        collection ``sweep_name``, the argmax checkpoint published so
        ``POST /models/<sweep_name>/predict`` serves the winner.
        Concurrent sweeps with compatible shapes coalesce into one
        dispatch."""
        body = request.get_json(silent=True)
        required = (
            "training_filename",
            "test_filename",
            "preprocessor_code",
            "classificator",
            "grid",
            "sweep_name",
        )
        if not isinstance(body, dict) or any(k not in body for k in required):
            return {MESSAGE_RESULT: validators.MESSAGE_MISSING_FIELDS}, 406
        try:
            validators.filename_exists(
                store,
                body["training_filename"],
                validators.MESSAGE_INVALID_TRAINING_FILENAME,
            )
            validators.filename_exists(
                store,
                body["test_filename"],
                validators.MESSAGE_INVALID_TEST_FILENAME,
            )
        except validators.ValidationError as error:
            return {MESSAGE_RESULT: error.args[0]}, 406
        if not validators.safe_filename(body["sweep_name"]):
            return {MESSAGE_RESULT: validators.MESSAGE_INVALID_FILENAME}, 406
        max_iter = body.get("max_iter", 100)
        if isinstance(max_iter, bool) or not isinstance(max_iter, int) or (
            max_iter < 1
        ):
            return {MESSAGE_RESULT: "invalid_max_iter"}, 406
        try:
            lo_sweep.validate_grid(body["classificator"], body["grid"])
        except ValueError as error:
            return {MESSAGE_RESULT: f"invalid_grid: {error}"}, 406
        try:
            validators.filename_free(store, body["sweep_name"])
        except validators.ValidationError as error:
            return {MESSAGE_RESULT: error.args[0]}, 409
        try:
            result = lo_sweep.run_sweep(
                store,
                body,
                jobs=jobs,
                coalescer=coalescer,
                models_dir=models_dir,
                device=device,
            )
        except QueueFullError as error:  # device queue at its cap
            return too_many_requests(error)
        except DuplicateJobError as error:  # same sweep already running
            return {MESSAGE_RESULT: str(error)}, 409
        return {MESSAGE_RESULT: result}, 201

    @app.route("/models", methods=("GET",))
    def list_models(request):
        serving = serve.stats()
        if not models_dir or not os.path.isdir(models_dir):
            return {MESSAGE_RESULT: [], "serving": serving}, 200
        names = sorted(
            name[: -len(CHECKPOINT_SUFFIX)]
            for name in os.listdir(models_dir)
            if name.endswith(CHECKPOINT_SUFFIX)
        )
        return {MESSAGE_RESULT: names, "serving": serving}, 200

    @app.route("/models/<model_name>", methods=("GET",))
    def get_model(request, model_name):
        if not artifact_exists(model_name):
            return {MESSAGE_RESULT: validators.MESSAGE_NOT_FOUND}, 404
        path = checkpoint_path(model_name)
        with zipfile.ZipFile(path) as archive:
            header = json.loads(archive.read("__model__.json"))
        return {
            MESSAGE_RESULT: {
                "name": model_name,
                "kind": header["kind"],
                "size_bytes": os.path.getsize(path),
                "serving": serve.registry.status(path),
            }
        }, 200

    @app.route("/models/<model_name>/predict", methods=("POST",))
    def predict_rows(request, model_name):
        """Rows in, labels + probabilities out. Every failure maps to a
        JSON error body, never a traceback."""
        started = time.perf_counter()
        if not artifact_exists(model_name):
            return {MESSAGE_RESULT: validators.MESSAGE_NOT_FOUND}, 404
        body = request.get_json(silent=True)
        if not isinstance(body, dict) or "rows" not in body:
            return {MESSAGE_RESULT: validators.MESSAGE_MISSING_FIELDS}, 406
        try:
            rows = np.asarray(body["rows"], dtype=np.float32)
        except (TypeError, ValueError):  # ragged / non-numeric
            return {MESSAGE_RESULT: MESSAGE_INVALID_ROWS}, 406
        if rows.ndim == 1 and rows.size:  # one bare row is one request
            rows = rows.reshape(1, -1)
        # isfinite also refuses JSON nulls, which asarray turns into NaN
        if rows.ndim != 2 or rows.size == 0 or not np.isfinite(rows).all():
            return {MESSAGE_RESULT: MESSAGE_INVALID_ROWS}, 406
        if len(rows) > serve_max_rows:
            return {MESSAGE_RESULT: MESSAGE_TOO_MANY_ROWS}, 413
        try:
            pending = serve.submit(checkpoint_path(model_name), rows)
        except QueueFullError as error:
            return too_many_requests(error)
        done = pending.wait(serve_timeout_s)
        # every exit after the dispatch is observed, timeouts and failures
        # too: a p99 without them would read healthy under overload
        serve_seconds.observe(time.perf_counter() - started)
        if not done:
            # the batcher drops the forward of a client that stopped waiting
            pending.abandon()
            return {MESSAGE_RESULT: MESSAGE_SERVE_TIMEOUT}, 503
        if pending.error is not None:
            if isinstance(pending.error, ModelNotFoundError):
                # artifact deleted between the check above and the dispatch
                return {MESSAGE_RESULT: validators.MESSAGE_NOT_FOUND}, 404
            return {
                MESSAGE_RESULT: (
                    "prediction_failed: "
                    f"{type(pending.error).__name__}: {pending.error}"
                )
            }, 500
        return {
            MESSAGE_RESULT: {
                "model": model_name,
                "predictions": pending.labels.tolist(),
                "probabilities": pending.probs.tolist(),
            }
        }, 200

    @app.route("/models/<model_name>/predictions", methods=("POST",))
    def predict_model(request, model_name):
        """A whole test collection predicted from a saved checkpoint."""
        body = request.get_json(silent=True)
        required = (
            "training_filename",
            "test_filename",
            "preprocessor_code",
            "prediction_filename",
        )
        if not isinstance(body, dict) or any(k not in body for k in required):
            return {MESSAGE_RESULT: validators.MESSAGE_MISSING_FIELDS}, 406
        if not artifact_exists(model_name):
            return {MESSAGE_RESULT: validators.MESSAGE_NOT_FOUND}, 404
        try:
            validators.filename_exists(
                store,
                body["training_filename"],
                validators.MESSAGE_INVALID_TRAINING_FILENAME,
            )
            validators.filename_exists(
                store,
                body["test_filename"],
                validators.MESSAGE_INVALID_TEST_FILENAME,
            )
        except validators.ValidationError as error:
            return {MESSAGE_RESULT: error.args[0]}, 406
        if not validators.safe_filename(body["prediction_filename"]):
            return {MESSAGE_RESULT: validators.MESSAGE_INVALID_FILENAME}, 406
        try:
            validators.filename_free(store, body["prediction_filename"])
        except validators.ValidationError as error:
            return {MESSAGE_RESULT: error.args[0]}, 409
        # a forward on the card: the device queue, as builds, so that it
        # never overlaps a fit's launches
        job_name = f"predict:{body['prediction_filename']}"
        try:
            jobs.run_sync(job_name, predict, model_name, body, job_class=DEVICE_CLASS)
        except QueueFullError as error:
            return too_many_requests(error)
        except DuplicateJobError:
            # the reference's rule for builds: the concurrent duplicate
            # runs too, through the device queue
            try:
                jobs.run_sync(
                    f"{job_name}#dup{next(duplicate_seq)}",
                    predict,
                    model_name,
                    body,
                    job_class=DEVICE_CLASS,
                )
            except QueueFullError as error:
                return too_many_requests(error)
        return {MESSAGE_RESULT: MESSAGE_CREATED_FILE}, 201

    return app
