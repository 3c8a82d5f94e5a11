"""model_builder service: the online predict lane.

Counterpart of ``learningorchestra_tpu/services/model_builder.py``
(:54-58, :361-457), with only the routes of the serving path:

- ``GET /models`` lists the ``.model`` artifacts in ``models_dir`` (the
  names under ``"result"``, the serve plane's stats under ``"serving"``);
- ``GET /models/<name>`` describes one artifact;
- ``POST /models/<name>/predict`` takes ``{"rows": [[...], ...]}`` and
  answers labels and probabilities in one synchronous response. Requests
  go through the serve plane: the model's parameters stay pinned on the
  device and concurrent requests are joined into one forward.

Messages and status codes are the reference's: 404 unknown model, 406
missing or malformed rows, 413 more than ``LO_SERVE_MAX_ROWS`` rows, 429
inbox full, 503 timed out, 500 ``prediction_failed: ...``. The build
(``POST /models``), sweeps, the batch lane (``/predictions``) and the job
and observability routes are not ported yet.
"""

from __future__ import annotations

import json
import os
import zipfile
from typing import Optional

import numpy as np

from learningorchestra_tpu_torch.device import DeviceLike, resolve_device
from learningorchestra_tpu_torch.ml.checkpoint import (
    CHECKPOINT_SUFFIX,
    checkpoint_path as _checkpoint_path,
)
from learningorchestra_tpu_torch.serve import (
    ModelNotFoundError,
    QueueFullError,
    ServePlane,
    global_serve_plane,
)
from learningorchestra_tpu_torch.serve import config as serve_config
from learningorchestra_tpu_torch.services import validators
from learningorchestra_tpu_torch.utils.web import WebApp, too_many_requests

MESSAGE_RESULT = "result"
MESSAGE_INVALID_ROWS = "invalid_rows"
MESSAGE_SERVE_TIMEOUT = "predict_timeout"
MESSAGE_TOO_MANY_ROWS = "too_many_rows"


def create_app(
    models_dir: Optional[str] = None,
    serve: Optional[ServePlane] = None,
    device: DeviceLike = None,
) -> WebApp:
    """The predict lane over the checkpoints in ``models_dir`` (default
    ``LO_MODELS_DIR``). ``device=None`` means CUDA and raises without a
    card; ``serve`` injects a plane (tests pin its knobs), else the
    process-wide plane of ``device`` serves."""
    device = resolve_device(device)
    if serve is None:
        serve = global_serve_plane(device)
    elif serve.device != device:
        raise ValueError(f"serve plane runs on {serve.device}, the app on {device}")
    models_dir = models_dir or os.environ.get("LO_MODELS_DIR")
    # resolve every serving knob now: a malformed value breaks app
    # construction instead of answering 500 on a live route
    serve_knobs = serve_config.validate_all()
    serve_timeout_s = serve_knobs["request_timeout_s"]
    serve_max_rows = serve_knobs["max_rows"]
    app = WebApp("model_builder")

    def checkpoint_path(name: str) -> str:
        return _checkpoint_path(models_dir, name)

    def artifact_exists(name: str) -> bool:
        return bool(
            models_dir
            and validators.safe_filename(name)
            and os.path.isfile(checkpoint_path(name))
        )

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
        if not pending.wait(serve_timeout_s):
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

    return app
