"""tsne (port 5005) and pca (port 5006) services — one parametrized app.

Counterpart of ``learningorchestra_tpu/services/images.py``, with the
same routes, request key (``tsne_filename`` or ``pca_filename``), status
codes and messages. Image existence is checked on the filesystem, like
the reference: duplicates → 409, missing on GET/DELETE → 404 with
``file_not_found``.

A create runs through the scheduler's DEVICE class (``jobs.run_sync``),
as the reference's does: it queues behind model builds instead of
contending with them for the card, answers 429 + ``Retry-After`` when
the device queue is full, and the 201 still comes after the PNG exists.
The app also serves the job routes, ``/health`` and ``/metrics``.
"""

from __future__ import annotations

import contextlib
import os

from typing import Optional

from learningorchestra_tpu_torch.core.jobs import JobManager
from learningorchestra_tpu_torch.core.store import DocumentStore
from learningorchestra_tpu_torch.device import DeviceLike
from learningorchestra_tpu_torch.ops.images import IMAGE_FORMAT, create_embedding_image
from learningorchestra_tpu_torch.sched import DEVICE_CLASS, QueueFullError
from learningorchestra_tpu_torch.services import validators
from learningorchestra_tpu_torch.telemetry import register_store, span
from learningorchestra_tpu_torch.utils.web import WebApp, send_file, too_many_requests

MESSAGE_RESULT = "result"
MESSAGE_CREATED_FILE = "created_file"
MESSAGE_DELETED_FILE = "deleted_file"

# In-flight create claims are `<name>.png.part` markers: atomic (O_EXCL)
# duplicate gating without ever exposing a half-written PNG to GET or
# DELETE. A crash can leave a stale marker blocking the name; DELETE on
# the name clears it once the PNG exists.
CLAIM_SUFFIX = ".part"


def create_app(
    store: DocumentStore,
    images_path: str,
    method: str,
    create=None,
    device: DeviceLike = None,
    jobs: Optional[JobManager] = None,
) -> WebApp:
    """``method`` is "tsne" or "pca"; the request filename key follows it.

    ``create(parent_filename, label_name, output_filename)`` overrides how
    a validated request becomes an image; by default it is
    :func:`create_embedding_image` on ``device`` (None: the CUDA card).
    ``jobs`` injects a ``JobManager`` (tests pin its scheduler; a process
    serving several apps shares one so the device class is one queue),
    else the app owns one."""
    app = WebApp(method)
    jobs = jobs or JobManager()
    register_store(store)
    app.register_job_routes(jobs)
    app.register_observability(store)

    if create is None:

        def create(parent_filename, label_name, output_filename):
            create_embedding_image(
                store,
                parent_filename,
                label_name,
                output_filename,
                images_path,
                method,
                device,
            )

    filename_key = f"{method}_filename"
    os.makedirs(images_path, exist_ok=True)

    def image_path(name: str) -> str:
        return os.path.join(images_path, name + IMAGE_FORMAT)

    def image_exists(name: str) -> bool:
        """The finished PNG exists — what GET/DELETE see."""
        return (name + IMAGE_FORMAT) in os.listdir(images_path)

    def name_taken(name: str) -> bool:
        """Finished PNG *or* an in-flight claim — the duplicate gate."""
        listing = os.listdir(images_path)
        return (name + IMAGE_FORMAT) in listing or (
            name + IMAGE_FORMAT + CLAIM_SUFFIX
        ) in listing

    def claim_image(name: str) -> bool:
        """Atomically claim the name with a ``.part`` marker; False if a
        concurrent create won."""
        try:
            fd = os.open(
                image_path(name) + CLAIM_SUFFIX,
                os.O_CREAT | os.O_EXCL | os.O_WRONLY,
            )
        except FileExistsError:
            return False
        os.close(fd)
        return True

    def release_claim(name: str, keep_png: bool) -> None:
        with contextlib.suppress(FileNotFoundError):
            os.remove(image_path(name) + CLAIM_SUFFIX)
        if not keep_png:
            with contextlib.suppress(FileNotFoundError):
                os.remove(image_path(name))  # partially rendered output

    @app.route("/images/<parent_filename>", methods=("POST",))
    def create_image(request, parent_filename):
        body = request.get_json()
        output_filename = body[filename_key]
        label_name = body.get("label_name")
        if not validators.safe_filename(output_filename):
            return {MESSAGE_RESULT: validators.MESSAGE_INVALID_FILENAME}, 406
        if name_taken(output_filename):
            return {MESSAGE_RESULT: validators.MESSAGE_DUPLICATE_FILE}, 409
        try:
            validators.filename_exists(store, parent_filename)
            validators.label_in_metadata(store, parent_filename, label_name)
        except validators.ValidationError as error:
            return {MESSAGE_RESULT: error.args[0]}, 406
        if not claim_image(output_filename):
            return {MESSAGE_RESULT: validators.MESSAGE_DUPLICATE_FILE}, 409
        if os.path.exists(image_path(output_filename)):
            # a concurrent create finished between name_taken() and the
            # claim: never overwrite a finished image
            release_claim(output_filename, keep_png=True)
            return {MESSAGE_RESULT: validators.MESSAGE_DUPLICATE_FILE}, 409

        def work() -> None:
            with span(f"{method}:embed", parent=parent_filename):
                create(parent_filename, label_name, output_filename)

        try:
            jobs.run_sync(f"{method}:{output_filename}", work, job_class=DEVICE_CLASS)
        except QueueFullError as error:
            release_claim(output_filename, keep_png=False)
            return too_many_requests(error)
        except BaseException:
            release_claim(output_filename, keep_png=False)
            raise
        release_claim(output_filename, keep_png=True)
        return {MESSAGE_RESULT: MESSAGE_CREATED_FILE}, 201

    @app.route("/images", methods=("GET",))
    def get_images(request):
        # only finished PNGs: in-flight `.part` claims are never listed
        listing = [
            name
            for name in os.listdir(images_path)
            if not name.endswith(CLAIM_SUFFIX)
        ]
        return {MESSAGE_RESULT: listing}, 200

    @app.route("/images/<filename>", methods=("GET",))
    def get_image(request, filename):
        if not validators.safe_filename(filename) or not image_exists(filename):
            return {MESSAGE_RESULT: validators.MESSAGE_NOT_FOUND}, 404
        return send_file(image_path(filename), "image/png")

    @app.route("/images/<filename>", methods=("DELETE",))
    def delete_image(request, filename):
        if not validators.safe_filename(filename) or not image_exists(filename):
            return {MESSAGE_RESULT: validators.MESSAGE_NOT_FOUND}, 404
        os.remove(image_path(filename))
        with contextlib.suppress(FileNotFoundError):
            os.remove(image_path(filename) + CLAIM_SUFFIX)
        return {MESSAGE_RESULT: MESSAGE_DELETED_FILE}, 200

    return app
