"""Publish-time serve warmup: pay the first predict's loads at checkpoint
publication, not on a user's request.

Counterpart of ``learningorchestra_tpu/compile/warmup.py``. When the
builder (or a sweep's winner) publishes a checkpoint, the model_builder
service's publish handler (``compile.set_publish_handler``) submits a
low-priority device job running :func:`warm_artifact`: load the model
through the serve registry (pinning its parameters on the card) and run
one forward at the serving path's fixed dispatch shape,
``grid_size(1, max_batch)`` rows, as the micro-batcher dispatches
(``serve/batcher.py``). That forward launches the model's kernels (K6
for a tree model) and loads their library in this process if no earlier
call did; the load is booked under ``lo_compile_events_total``'s
``source="aot"`` (``telemetry/profile.compile_source``), so a
publish-time load never reads as a request-path stall.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def warm_artifact(
    path: str,
    features: Optional[int] = None,
    serve=None,
    device=None,
    max_batch: Optional[int] = None,
) -> bool:
    """Run the serving path's fixed-shape forward for ``path`` once.

    ``features`` is the training feature width (the builder knows it at
    publish time; tree checkpoints do not record it). Without it the
    width comes from the model's own parameters where they hold it
    (logistic regression's ``w``, naive Bayes's ``theta``); a tree model
    with no width is only pinned, and the call returns False: a forward
    at a guessed width is not the serving path's. ``serve`` is the
    plane whose registry pins the model; without one the checkpoint is
    loaded on ``device`` (None: the CUDA card)."""
    from learningorchestra_tpu_torch.telemetry.profile import compile_source
    from learningorchestra_tpu_torch.utils.shapegrid import grid_size

    if max_batch is None:
        from learningorchestra_tpu_torch.serve import config as serve_config

        max_batch = serve_config.max_batch()
    if serve is not None:
        model = serve.registry.get(path)
    else:
        from learningorchestra_tpu_torch.ml.checkpoint import load_model

        model = load_model(path, device=device)
    if features is None:
        if getattr(model, "w", None) is not None:
            features = int(model.w.shape[0])
        elif getattr(model, "theta", None) is not None:
            features = int(model.theta.shape[1])
        else:
            return False
    rows = np.zeros((grid_size(1, max_batch), int(features)), np.float32)
    with compile_source("aot", f"warmup:{path.rsplit('/', 1)[-1]}"):
        model.predict_both(rows)
    return True
