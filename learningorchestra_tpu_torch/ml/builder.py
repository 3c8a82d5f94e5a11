"""Model builder: the flagship pipeline — preprocess, fit N classifiers
concurrently, evaluate, persist predictions.

Counterpart of ``learningorchestra_tpu/ml/builder.py`` (reference
behaviour: microservices/model_builder_image/model_builder.py:133-247):
load the train and test dataframes, ``exec`` the user's preprocessing,
fan out one thread per requested classifier, time the fit, evaluate
weighted F1 and accuracy when an evaluation split exists, and write the
predictions back as batched columnar writes on a background writer.

On one card: every classifier thread launches on the device's current
stream, so the fits' kernels queue one after another there while the
threads overlap their host work (thresholds, scaler, preprocessing
copies). ``device=None`` means CUDA and raises without a card.

The batch predictions lane: :func:`predict_with_model` loads a saved
``.model``, re-runs the preprocessor over (training, test) and writes the
prediction collection, with no refit.

Crash resume: ``build_model(resume=...)`` takes the journaled
``progress`` events recovery hands a re-enqueued build
(sched/recovery.py): finished members are skipped, failed ones stay
failed, the rest refit, each fit picking up its own progress artifact
(ml/progress.py) beside the checkpoints.

Publication: after a checkpoint's atomic write, ``compile.
checkpoint_published(path, features)`` hands the serve path the chance
to warm it at its dispatch shape before the first ``POST /predict``
(``compile/warmup.py``); a no-op unless a service registered a handler.

Over a data axis of several ranks (``mesh``, parallel/mesh.py): every
rank runs the same build, the fits, evaluations and predictions over the
ranks (their collectives in one order: the classifiers one at a time),
and only a rank with ``write_outputs`` writes to the store, as the
reference's SPMD workers (``ml/builder.py:196-255``). In the runner's
multi-host mode the SPMD dispatcher (parallel/spmd.py) starts the build
and the batch lane on every rank, the coordinator with ``write_outputs``.
"""

from __future__ import annotations

import itertools
import os
import threading
import traceback
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Callable, Optional

import numpy as np
import torch

from learningorchestra_tpu_torch.core.columns import Column
from learningorchestra_tpu_torch.core.store import ROW_ID, DocumentStore
from learningorchestra_tpu_torch.core.table import insert_columns_batched
from learningorchestra_tpu_torch.device import DeviceLike, resolve_device
from learningorchestra_tpu_torch.frame.dataframe import DataFrame
from learningorchestra_tpu_torch.frame.pyspark_compat import run_preprocessor
from learningorchestra_tpu_torch.ml import progress as _progress
from learningorchestra_tpu_torch.ml.base import CLASSIFIER_NAMES, make_classifier
from learningorchestra_tpu_torch.parallel.mesh import over_ranks
from learningorchestra_tpu_torch.sched import cancel as _cancel
from learningorchestra_tpu_torch.sched import config as _sched_config
from learningorchestra_tpu_torch.sched.cancel import JobCancelledError, check_cancelled
from learningorchestra_tpu_torch.telemetry import tracing as _tracing
from learningorchestra_tpu_torch.testing import faults as _faults
from learningorchestra_tpu_torch.utils.dtypepolicy import dtype_policy
from learningorchestra_tpu_torch.utils.profiling import PhaseTimer, trace

FEATURES_COL = "features"
LABEL_COL = "label"

# Guards the process-wide torch profiler: one traced build at a time; a
# build that finds it busy runs untraced.
_TRACE_LOCK = threading.Lock()

# Capture directories are named from the job (dataset name + build
# sequence number), never the wall clock, so captures correlate with
# their request across runs.
_TRACE_SEQ = itertools.count()


def _next_trace_dir(trace_root: str, test_filename: str) -> str:
    for seq in _TRACE_SEQ:
        path = os.path.join(trace_root, f"build_{test_filename}_{seq:03d}")
        try:
            # makedirs IS the reservation: an exists() probe would let
            # two server processes sharing LO_TRACE_DIR claim the same
            # name before either profiler writes it
            os.makedirs(path)
        except FileExistsError:  # taken by an earlier run or a peer
            continue
        return path
    raise AssertionError("unreachable: itertools.count is infinite")


def load_dataframe(store: DocumentStore, filename: str) -> DataFrame:
    """Dataset → DataFrame, metadata row/fields excluded (the reference
    drops the metadata document and its fields, model_builder.py:96-116).

    Reads through the device cache's host tier (core/devcache.py): the
    second build or batch predict over the same collection revision skips
    the store read and the decode."""
    from learningorchestra_tpu_torch.core.devcache import dataset_table

    return DataFrame.from_table(dataset_table(store, filename))


class PredictionWriter:
    """Overlapped prediction write-back: one background thread drains
    per-classifier store writes while the next classifier fits, so the
    write tail leaves the build's critical path.

    One writer thread, not a pool: per-collection write order is
    preserved (rows before the metadata document), and the shared store
    sees at most one bulk writer per build. ``barrier()`` is the
    end-of-job fence build_model runs before returning: every submitted
    write has finished (or its exception fails that classifier), so the
    201/finished contract and the persisted per-phase timings stay
    honest — the "write" phase is measured on the writer thread around
    the actual store calls."""

    def __init__(self):
        self._pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="lo-writeback"
        )
        self._futures: list = []
        self._lock = threading.Lock()

    def submit(self, fn, name: Optional[str] = None) -> None:
        context = _tracing.capture()

        def run():
            with _tracing.attach(context):
                return fn()

        with self._lock:
            self._futures.append((name, self._pool.submit(run)))

    def barrier(self) -> list:
        """Drain every pending write; returns ``[(name, exception)]``
        for the writes that failed instead of raising — a failed
        write-back fails THAT classifier's outcome (the partial-results
        contract), not the whole build."""
        self._pool.shutdown(wait=True)
        with self._lock:
            futures, self._futures = self._futures, []
        failures = []
        for name, future in futures:
            error = future.exception()
            if error is not None:
                failures.append((name, error))
        return failures


def _prediction_columns(predicted_df: DataFrame) -> dict[str, Column]:
    """Column-major view of a prediction frame as typed columns: every
    column except the assembled ``features`` vector, ``probability`` as a
    fixed-width ``vec`` column (the (rows, classes) matrix goes to the
    store as one float64 buffer and becomes per-row lists only at
    document reads)."""
    out: dict[str, Column] = {}
    for name in predicted_df.columns:
        if name == FEATURES_COL:
            continue
        column = predicted_df._column(name)
        if column.dtype == object and column.ndim == 1:
            out[name] = Column.from_values(column.tolist())
        else:
            out[name] = Column.from_numpy(np.asarray(column, dtype=np.float64))
    return out


def train_one(
    store: DocumentStore,
    classificator_name: str,
    features_training: DataFrame,
    features_testing: DataFrame,
    features_evaluation: Optional[DataFrame],
    prediction_filename: str,
    device: DeviceLike = None,
    models_dir: Optional[str] = None,
    writer: Optional[PredictionWriter] = None,
    sink: Optional[_progress.ProgressSink] = None,
    on_durable: Optional[Callable[[dict], None]] = None,
    mesh=None,
    write_outputs: bool = True,
) -> dict:
    """Fit + evaluate + persist one classifier (the reference's
    ``classificator_handler``, model_builder.py:178-230). Returns the
    prediction collection's metadata document — complete only after the
    build's write barrier when a ``writer`` is given (None: write
    synchronously).

    ``mesh``: the ranks to fit, evaluate and predict over (its device
    replaces ``device``); every rank of it calls this with the same
    arguments. ``write_outputs=False`` runs all of it and writes nothing:
    no checkpoint, no prediction collection (the reference's SPMD workers,
    ``ml/builder.py:218-223``).

    ``models_dir`` (or ``LO_MODELS_DIR``) persists the fitted model as a
    ``.model`` checkpoint named after the prediction collection, recorded
    in the metadata as ``model_checkpoint``.

    ``sink`` makes the fit crash-resumable: it is bound as the ambient
    progress sink around the fit, so the segment loops persist progress
    artifacts (ml/progress.py). ``on_durable(metadata)`` fires once this
    classifier's outputs have durably landed (after the metadata insert,
    on the writer thread when writes overlap); build_model journals the
    member's completion there."""
    device = mesh.device if mesh is not None else resolve_device(device)
    sharded = over_ranks(mesh)
    output_name = f"{prediction_filename}_prediction_{classificator_name}"
    metadata = {
        "filename": output_name,
        "classificator": classificator_name,
        ROW_ID: 0,
    }
    timer = PhaseTimer()

    # cooperative cancellation (DELETE /jobs/<name>): phase boundaries are
    # the abort points; a no-op outside a scheduled job
    check_cancelled()
    X_train = features_training.feature_matrix(FEATURES_COL)
    y_train = features_training.label_vector(LABEL_COL)

    classifier = make_classifier(classificator_name, device=device, mesh=mesh)
    _faults.fire(
        "builder.phase", phase="fit", classificator=classificator_name
    )
    with timer.phase("fit", rows=len(X_train), dtype=dtype_policy()):
        with _progress.bind_sink(sink):
            model = classifier.fit(X_train, y_train)
        # the fit's kernels run asynchronously: wait for them inside the
        # phase, or "evaluate" would report the fit's tail
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    metadata["fit_time"] = timer.timings["fit"]
    check_cancelled()  # phase boundary: fit done, before checkpoint/eval

    if models_dir is None:
        models_dir = os.environ.get("LO_MODELS_DIR")
    if models_dir and write_outputs:
        from learningorchestra_tpu_torch.ml.checkpoint import (
            checkpoint_path,
            gather_model,
            write_checkpoint,
        )

        artifact = checkpoint_path(models_dir, output_name)
        _faults.fire(
            "builder.phase",
            phase="checkpoint",
            classificator=classificator_name,
        )
        with timer.phase("checkpoint"):
            os.makedirs(models_dir, exist_ok=True)
            write_checkpoint(gather_model(model), artifact)
        metadata["model_checkpoint"] = artifact
        # publish-time serve warmup: the feature width rides along, as
        # tree checkpoints do not record it; never raises into the build
        from learningorchestra_tpu_torch import compile as lo_compile

        lo_compile.checkpoint_published(artifact, features=int(X_train.shape[1]))

    prediction = None
    if features_evaluation is not None:
        # copied once a frame, shared by every classifier thread; build_model
        # aliases the eval frame to the test frame when their content is
        # equal, so X_eval IS X_test and one forward serves both. Over
        # ranks each takes its block of the host rows
        X_eval, y_eval, X_test = _evaluation_inputs(
            features_evaluation, features_testing, device, sharded)
        _faults.fire(
            "builder.phase",
            phase="evaluate",
            classificator=classificator_name,
        )
        with timer.phase("evaluate", rows=features_evaluation.count()):
            accuracy, weighted_f1, labels, probs = model.evaluate_predict(
                X_eval, y_eval, X_test
            )
            prediction = (labels, probs)
            # strings, as in the reference's metadata document
            # (model_builder.py:223-224, docs/database_api.md)
            metadata["F1"] = str(weighted_f1)
            metadata["accuracy"] = str(accuracy)

    return _predict_and_write(
        store,
        model,
        features_testing,
        output_name,
        metadata,
        timer,
        device,
        prediction=prediction,
        writer=writer,
        on_durable=on_durable,
        write_outputs=write_outputs,
    )


def _evaluation_inputs(features_evaluation, features_testing, device, sharded: bool):
    """``(X_eval, y_eval, X_test)``: the frames' device copies (cached on
    the frame, shared by the classifier threads), or over several ranks
    their host rows, of which each rank takes its block."""
    if sharded:
        X_eval = features_evaluation.feature_matrix(FEATURES_COL)
        X_test = X_eval if features_testing is features_evaluation else (
            features_testing.feature_matrix(FEATURES_COL))
        return X_eval, features_evaluation.label_vector(LABEL_COL), X_test
    return (
        features_evaluation.device_matrix(FEATURES_COL, device),
        features_evaluation.device_labels(LABEL_COL, device),
        features_testing.device_matrix(FEATURES_COL, device),
    )


def _predict_and_write(
    store: DocumentStore,
    model,
    features_testing: DataFrame,
    output_name: str,
    metadata: dict,
    timer: PhaseTimer,
    device: torch.device,
    prediction: Optional[tuple] = None,
    writer: Optional[PredictionWriter] = None,
    on_durable: Optional[Callable[[dict], None]] = None,
    write_outputs: bool = True,
) -> dict:
    """Predict over the test frame and persist the prediction collection
    and its metadata document (no ``finished`` flag, as in the reference,
    docs/database_api.md:76-83). The bulk write is its own ``write``
    phase; with a ``writer`` it runs on the build's writer thread,
    overlapped with the next classifier's fit, and the metadata document
    (timings included) still lands after the rows. ``write_outputs=False``
    predicts and writes nothing (its metadata gets its timings)."""
    if prediction is None:  # no eval split: predict is its own pass
        if model._sharded():
            X_test = features_testing.feature_matrix(FEATURES_COL)
        else:
            X_test = features_testing.device_matrix(FEATURES_COL, device)
        _faults.fire(
            "builder.phase",
            phase="predict",
            classificator=metadata.get("classificator"),
        )
        with timer.phase("predict", rows=features_testing.count()):
            prediction = model.predict_both(X_test)
    labels, probability = prediction
    if not write_outputs:
        metadata["timings"] = timer.as_metadata()
        return metadata
    predicted_df = features_testing.withColumn(
        "prediction", labels.astype(np.float64)
    ).withColumn("probability", probability)

    columns = _prediction_columns(predicted_df)
    write_rows = predicted_df.count()
    write_bytes = sum(
        int(column.resident_nbytes()) for column in columns.values()
    )

    def flush() -> None:
        _faults.fire(
            "builder.phase",
            phase="write",
            classificator=metadata.get("classificator"),
        )
        store.drop(output_name)
        with timer.phase("write", rows=write_rows, bytes=write_bytes):
            insert_columns_batched(store, output_name, columns)
        metadata["timings"] = timer.as_metadata()
        store.insert_one(output_name, metadata)
        # the metadata document is the durability proof (it lands after
        # the rows): only now is this member's completion journal-worthy
        if on_durable is not None:
            on_durable(metadata)

    if writer is None:
        flush()
    else:
        writer.submit(flush, metadata.get("classificator"))
    return metadata


def predict_with_model(
    store: DocumentStore,
    checkpoint_path: str,
    training_filename: str,
    test_filename: str,
    preprocessor_code: str,
    prediction_filename: str,
    device: DeviceLike = None,
    mesh=None,
    write_outputs: bool = True,
) -> dict:
    """Predictions from a saved checkpoint, with no refit (reference
    ``ml/builder.py:861-902``).

    Loads the ``.model`` that :func:`train_one` persisted, re-runs the same
    preprocessor over the same (training, test) frames (the training frame
    is required: preprocessor state such as StringIndexer's category order
    or the assembler's columns derives from it), predicts over the test
    frame and writes the prediction collection ``prediction_filename`` in
    the shape build_model writes, its metadata naming the
    ``model_checkpoint``. The metadata's ``timings`` take the lane apart:
    ``load_data``, ``preprocess``, ``h2d`` (the test matrix to the card, 0
    bytes on a device-cache hit), ``predict`` and ``write``.

    ``mesh``: the ranks to predict over (its device replaces ``device``;
    every rank calls this with the same arguments, and each predicts its
    block of the test rows, so there is no ``h2d`` phase).
    ``write_outputs=False`` predicts and writes nothing (an SPMD worker)."""
    from learningorchestra_tpu_torch.ml.checkpoint import load_model

    device = mesh.device if mesh is not None else resolve_device(device)
    timer = PhaseTimer()
    model = load_model(checkpoint_path, device=device, mesh=mesh)
    with timer.phase("load_data"):
        training_df = load_dataframe(store, training_filename)
        testing_df = load_dataframe(store, test_filename)
    with timer.phase("preprocess"):
        out = run_preprocessor(preprocessor_code, training_df, testing_df)
    features_testing = out["features_testing"]
    if not over_ranks(mesh):
        with timer.phase("h2d", rows=features_testing.count(), dtype=dtype_policy()):
            features_testing.device_matrix(FEATURES_COL, device)   # cached on the frame
    metadata = {
        "filename": prediction_filename,
        "model_checkpoint": checkpoint_path,
        ROW_ID: 0,
    }
    return _predict_and_write(
        store, model, features_testing, prediction_filename, metadata, timer, device,
        write_outputs=write_outputs,
    )


def _alias_if_equal(
    features_evaluation: Optional[DataFrame], features_testing: DataFrame
) -> Optional[DataFrame]:
    """The documented preprocessor evaluates on the test frame but builds
    it as a separate transform, so the frames are distinct objects with
    equal content. Aliasing them lets the frame's device copy serve both
    and evaluate_predict run one forward. The check is a host compare."""
    if features_evaluation is None or features_evaluation is features_testing:
        return features_evaluation
    try:
        eval_X = features_evaluation.feature_matrix(FEATURES_COL)
        test_X = features_testing.feature_matrix(FEATURES_COL)
        eval_y = features_evaluation.label_vector(LABEL_COL)
        test_y = features_testing.label_vector(LABEL_COL)
    except (KeyError, TypeError, ValueError):
        return features_evaluation
    if (
        eval_X.shape == test_X.shape
        and np.array_equal(eval_X, test_X)
        and np.array_equal(eval_y, test_y)
    ):
        return features_testing
    return features_evaluation


class _ResumedMemberFailure(RuntimeError):
    """A classifier the pre-crash run already journaled as permanently
    failed: the resumed build records the original error without
    re-running the member."""


def _fold_resume(resume: Optional[list]) -> dict[str, dict]:
    """Journaled ``progress`` events → per-classifier terminal status.
    Later events win (a ``failed`` member re-journaled ``finished`` by
    a later resume attempt is finished). Segment events carry no
    ``status`` and fold to nothing — the fits read their own progress
    artifacts, which hold strictly more than the journal line."""
    done: dict[str, dict] = {}
    for event in resume or []:
        name = event.get("classificator")
        status = event.get("status")
        if name and status in ("finished", "failed"):
            done[name] = {"status": status, "error": event.get("error")}
    return done


def _device_key(device: torch.device) -> str:
    """The progress artifact's device component: the device type, and the
    card's name on CUDA. A fit saved on the CPU's plain versions and
    resumed on the card's kernels (or the other way round) would be
    bit-identical to neither run, so such an artifact is refused and the
    fit restarts."""
    if device.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(device)}"
    return device.type


def _mesh_key(device: torch.device, mesh=None) -> str:
    """The progress artifact's layout component (the reference's
    ``_mesh_key``, ``ml/builder.py:500-506``): the device's key, and over a
    data axis of several ranks its size, so that a resume on another
    layout restarts clean."""
    data = mesh.shape["data"] if mesh is not None else 1
    return _device_key(device) if data == 1 else f"{_device_key(device)} data={data}"


def build_model(
    store: DocumentStore,
    training_filename: str,
    test_filename: str,
    preprocessor_code: str,
    classificators_list: list[str],
    device: DeviceLike = None,
    models_dir: Optional[str] = None,
    resume: Optional[list] = None,
    mesh=None,
    write_outputs: bool = True,
) -> list[dict]:
    """The reference's ``build_model`` (model_builder.py:133-176):
    preprocess once, then one thread per classifier, at most
    ``LO_BUILD_WORKERS`` at a time. Returns the metadata documents of the
    classifiers that succeeded (see :func:`_collect_outcomes`).

    ``resume`` is the journaled ``progress`` event list recovery hands
    a re-enqueued build (sched/recovery.py): classifiers it records as
    durably finished are skipped (their stored metadata is returned),
    ones it records as permanently failed stay failed without a re-run,
    and everything else refits — each fit picking up its own progress
    artifact, so only the remaining segments run.

    ``mesh``: the ranks to build over (every rank of it calls this with
    the same arguments); its classifiers then run one at a time, so that
    every rank enters their collectives in the same order, and no
    progress is persisted (a resumed process cannot rejoin the others'
    collectives). ``write_outputs``: see :func:`train_one`."""
    unknown = [n for n in classificators_list if n not in CLASSIFIER_NAMES]
    if unknown:
        raise KeyError(f"invalid classificator names {unknown}")
    device = mesh.device if mesh is not None else resolve_device(device)
    sharded = over_ranks(mesh)

    # captured once on the job's thread (contextvars do not cross the
    # classifier pool): the partial-results detail goes on its record
    from learningorchestra_tpu_torch.core.jobs import current_job_handle

    handle = current_job_handle()

    _faults.fire("builder.phase", phase="load_data")
    with _tracing.span("load_data"):
        training_df = load_dataframe(store, training_filename)
        testing_df = load_dataframe(store, test_filename)
        _tracing.annotate(rows=training_df.count() + testing_df.count())
    _faults.fire("builder.phase", phase="preprocess")
    with _tracing.span("preprocess"):
        out = run_preprocessor(preprocessor_code, training_df, testing_df)
        _tracing.annotate(rows=out["features_training"].count())
        out["features_evaluation"] = _alias_if_equal(
            out["features_evaluation"], out["features_testing"]
        )

    # LO_BUILD_WORKERS caps the fan-out: N concurrent fits hold N models'
    # device working sets at once
    max_workers = 1 if sharded else (len(classificators_list) or 1)
    cap = os.environ.get("LO_BUILD_WORKERS", "").strip()
    if cap and not sharded:
        try:
            max_workers = max(1, min(max_workers, int(cap)))
        except ValueError:
            raise ValueError(
                f"LO_BUILD_WORKERS must be an integer, got {cap!r}"
            ) from None
    # LO_TRACE_DIR: a torch.profiler trace of the whole fan-out, one per
    # build; a build that overlaps an active capture runs untraced —
    # tracing is observability, never a reason to fail a request
    trace_root = os.environ.get("LO_TRACE_DIR")
    trace_dir = None
    tracing = trace_root and write_outputs and _TRACE_LOCK.acquire(blocking=False)
    if tracing:
        try:
            trace_dir = _next_trace_dir(trace_root, test_filename)
        except OSError:  # unwritable/full trace volume: run untraced
            _TRACE_LOCK.release()
            tracing = False
    # Crash resume needs a durable home for progress artifacts: beside
    # the model checkpoints. Resolve the env fallback here so the sink
    # and train_one agree on one directory.
    if models_dir is None:
        models_dir = os.environ.get("LO_MODELS_DIR")
    make_sink: Optional[Callable] = None
    if models_dir and write_outputs and not sharded and _sched_config.resume_enabled():
        # the validation key: an artifact resumes only against the same
        # input content, dtype policy and device that produced it.
        # Content fingerprints, not collection revs: revs reseed per
        # boot, and the restarted process needs the artifact to validate
        sink_meta = {
            "training_fp": _progress.collection_fingerprint(store, training_filename),
            "test_fp": _progress.collection_fingerprint(store, test_filename),
            "dtype_policy": dtype_policy(),
            "mesh": _mesh_key(device, mesh),
        }
        every = _sched_config.resume_every_segments()
        os.makedirs(models_dir, exist_ok=True)

        def make_sink(name: str) -> _progress.ProgressSink:
            output_name = f"{test_filename}_prediction_{name}"
            on_segment = None
            if handle is not None:
                def on_segment(seg: int, _name=name) -> None:
                    handle.progress(classificator=_name, kind="segment", segment=seg)
            return _progress.ProgressSink(
                _progress.progress_path(models_dir, output_name),
                dict(sink_meta),
                every=every,
                on_segment=on_segment,
            )

    try:
        return _build_model_traced(
            store,
            out,
            classificators_list,
            test_filename,
            device,
            models_dir,
            max_workers,
            trace_dir,
            handle,
            resume_done=_fold_resume(resume),
            make_sink=make_sink,
            mesh=mesh,
            write_outputs=write_outputs,
        )
    finally:
        if tracing:
            _TRACE_LOCK.release()


def _build_model_traced(
    store,
    out,
    classificators_list,
    test_filename,
    device,
    models_dir,
    max_workers,
    trace_dir,
    handle=None,
    resume_done=None,
    make_sink=None,
    mesh=None,
    write_outputs=True,
) -> list[dict]:
    # contextvars don't cross pool threads: hand each worker the ambient
    # (trace, span) so its train span nests under the request's trace,
    # and the cancel token so DELETE /jobs/<name> reaches it
    context = _tracing.capture()
    cancel_token = _cancel.current_token()
    # LO_WRITE_OVERLAP=0 restores synchronous writes
    overlap = os.environ.get("LO_WRITE_OVERLAP", "1") != "0"
    writer = PredictionWriter() if overlap else None
    resume_done = resume_done or {}

    def run_train(name: str) -> dict:
        with _tracing.attach(context), _cancel.bind(cancel_token):
            # a cancelled build stops launching classifiers: fits in
            # flight run to their own next check, queued ones never start
            check_cancelled()
            sink = make_sink(name) if make_sink is not None else None
            prior = resume_done.get(name)
            if prior is not None and prior.get("status") == "failed":
                # journaled as permanently failed before the crash:
                # resume skips the member, keeping the original error
                if sink is not None:
                    sink.discard()
                raise _ResumedMemberFailure(
                    prior.get("error") or "failed before service restart"
                )
            if prior is not None and prior.get("status") == "finished":
                stored = store.find_one(f"{test_filename}_prediction_{name}", {ROW_ID: 0})
                if stored is not None:
                    # durably completed before the crash (the journal
                    # line lands only after the metadata insert): skip
                    # the refit, return the stored outcome
                    if sink is not None:
                        sink.discard()
                    return stored
                # journaled finished but the outputs are gone (dropped
                # collection): fall through and rebuild

            def durable(metadata, _name=name, _sink=sink) -> None:
                if handle is not None:
                    handle.progress(classificator=_name, status="finished")
                if _sink is not None:
                    _sink.discard()

            with _tracing.span(f"train:{name}", classificator=name):
                return train_one(
                    store,
                    name,
                    out["features_training"],
                    out["features_testing"],
                    out["features_evaluation"],
                    test_filename,
                    device,
                    models_dir,
                    writer=writer,
                    sink=sink,
                    on_durable=durable,
                    mesh=mesh,
                    write_outputs=write_outputs,
                )

    try:
        with trace(trace_dir), ThreadPoolExecutor(
            max_workers=max_workers
        ) as pool:
            futures = [
                (name, pool.submit(run_train, name))
                for name in classificators_list
            ]
            wait([future for _, future in futures])
    finally:
        # end-of-job barrier: no build returns (or fails) with writes
        # still in flight; a failed write-back fails that member
        write_failures = writer.barrier() if writer is not None else []
    return _collect_outcomes(
        classificators_list, futures, write_failures, handle
    )


def _collect_outcomes(
    classificators_list, futures, write_failures, handle
) -> list[dict]:
    """Fold per-classifier futures + write-back failures into the
    build's result — the partial-results contract:

    - all succeeded → the metadata list;
    - any cancelled → the cancellation re-raises (job CANCELLED);
    - all failed → a single member's exception re-raises verbatim
      (single-classifier builds keep the reference's 500 bodies), several
      failures raise one aggregate;
    - mixed → the successes return, the job FINISHES, and the record
      carries ``detail.result = "finished_partial"`` with a per-name
      status map (GET /jobs/<name> and the /wait body show it).

    Failed members are journaled (``status="failed"``) so a resumed run
    skips them instead of re-running a permanent failure."""
    succeeded: list[dict] = []
    errors: dict[str, BaseException] = {}
    cancelled: Optional[BaseException] = None
    write_failed = dict(write_failures)
    for name, future in futures:
        try:
            result = future.result()
        except JobCancelledError as interruption:
            cancelled = interruption
            continue
        except BaseException as error:  # noqa: BLE001 — folded below
            errors[name] = error
            continue
        if name in write_failed:
            # compute finished, but the overlapped write-back failed:
            # this member's outputs never landed
            errors[name] = write_failed[name]
            continue
        succeeded.append(result)
    if cancelled is not None:
        raise cancelled
    for name, error in errors.items():
        if isinstance(error, _ResumedMemberFailure):
            continue  # already journaled by the pre-crash run
        traceback.print_exception(type(error), error, error.__traceback__)
        if handle is not None:
            handle.progress(classificator=name, status="failed", error=_member_error(error))
    if not errors:
        return succeeded
    if not succeeded:
        if len(errors) == 1:
            raise next(iter(errors.values()))
        raise RuntimeError(
            "all classifiers failed: "
            + "; ".join(
                f"{name}: {_member_error(error)}"
                for name, error in errors.items()
            )
        )
    if handle is not None:
        statuses = {
            name: (
                {"status": "failed", "error": _member_error(errors[name])}
                if name in errors
                else {"status": "finished"}
            )
            for name in classificators_list
        }
        handle.annotate(result="finished_partial", classifiers=statuses)
    return succeeded


def _member_error(error: BaseException) -> str:
    if isinstance(error, _ResumedMemberFailure):
        return str(error)  # already formatted by the pre-crash run
    return f"{type(error).__name__}: {error}"
