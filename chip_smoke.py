"""Drive the PyTorch port's predict lane, its lr, dt, rf, gb and nb fits,
its PCA and t-SNE image lane, its sweeps and job coalescing, its model
builder (``POST /models``), its whole service stack (crash resume, the
data services, ``POST /models/sweep``, the runner's kill -9 drill), its
batch predictions lane with the device cache, the stack over the
networked store (a replicated pair of store servers, failover), the
``bf16`` feature policy, every fit, PCA and t-SNE over ranks (rows
sharded over ``torch.distributed`` processes), one process a service
with the observability plane, the stack over two shard groups with
CSVs ingested natively in slabs, and the serving fleet (two replicas
behind the router, the publish-time warmup, a kill -9 drill), and its
deployment (the supervised stack and the cluster driver, with the kernel
libraries built at boot and shared over the store), on one CUDA card. Every server runs on the event loop (``LO_WEB_ASYNC``'s
default); the serve phase also runs on the threaded server.

Run from the repository root, with one card visible:

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py fit-kernels fit  # device, build and the named phases
    python3 chip_smoke.py sweep            # the sweeps and the coalescer alone
    python3 chip_smoke.py models           # the builds alone
    python3 chip_smoke.py stack            # resume, the services, sweeps, the kill -9 drill
    python3 chip_smoke.py batch bf16       # the batch lane; LO_DTYPE_POLICY=bf16 in a child
    python3 chip_smoke.py store            # the stack over a primary and a follower store server
    python3 chip_smoke.py multigpu         # K8′, the sums forms and slabs; every fit, PCA, t-SNE over ranks
    python3 chip_smoke.py services         # a store server and seven LO_SERVICE runners
    python3 chip_smoke.py shards           # two replicated shard groups, slabbed native CSV ingest
    python3 chip_smoke.py fleet serve      # two replicas behind the router; serve on both servers
    python3 chip_smoke.py deploy           # deploy.stack and deploy.cluster up, on the card

Phases, one JSON line each:

1. device      — CUDA must be available; the card's name and power limit.
2. build       — build (or load) the CUDA kernel libraries from
                 ``learningorchestra_tpu_torch/kernels/csrc``, one nvcc per
                 source, all started together.
3. kernels     — each forward kernel (K6) against its plain PyTorch version
                 on the same seeded inputs, at N in {1, 64, 4096, 1,048,576}
                 rows, 1 and 20 trees of depth 5: identical labels, the
                 ensemble's probabilities bit-equal and gb's within 1e-6;
                 times at 64 (the serve lane's dispatch shape), 4096 and
                 1,048,576 rows: events and device time warm, device time
                 cold (256 MB written before each call) and with L2
                 evicted by reads. A thread a row on 32-feature rows
                 at 1,048,576 rows, also with tiles cut below a block's
                 threads: ten calls each bit-equal. Also the times of
                 the lr and nb forwards (K8, cuBLAS).
4. serve       — ``dt``, ``rf``, ``gb``, ``lr`` and ``nb`` checkpoints at full
                 width (16 features, 2 classes, depth 5, 20 trees or rounds)
                 with seeded parameters, written by the port and served by its
                 HTTP app over real sockets: single rows, 8 concurrent single
                 rows and one 4096-row request to each model, checked against
                 the plain forward on the CPU; 404, 406 and 413; the kernels'
                 launch counts must rise during this phase. All on the
                 event loop; then the singles and the 8 concurrent requests
                 again on the threaded server (``LO_WEB_ASYNC=0``) and on
                 the loop, p50 and p99 of each.
5. fit-kernels — each fit kernel (K1-K5) against its plain version on
                 bench.py's synthetic rows at full width (1,000,000 x 16,
                 32 bins), at every level of a depth-5 tree, with dt (class
                 one-hot) and gb ((g, h)) channels: bins, counts, splits and
                 routes identical, gb sums within 1e-5 relative; times,
                 each call with L2 overwritten before it, no time below
                 its bound. Then the size limits: K1, K2 and K4 at 255 bins
                 (int32 bins) identical; K2 at a 2,048-node level with K = 2
                 and K = 10 and K5 at 4,096 leaves with K = 10 (windows
                 past one block's shared memory), counts identical and sums
                 within 1e-5; K6 at 20 trees of depth 10 and at one tree of
                 depth 12 with 20 classes, bit-equal. Then the forest's
                 tree axis: K2, K4 and K5 over 20 trees (one launch a
                 level) and K3 with each node's subset of 4 features, at
                 every level of a depth-5 forest grown by the plain
                 versions from seeded bootstrap counts, identical to the
                 plain versions and, tree by tree, to one-tree launches;
                 K3 on tied scores, on a node whose every allowed gain is
                 -inf and with NaN outside the subset; K2 at 20 trees of
                 a 2,048-node level, K = 10 (windows); the one-tree calls
                 of dt and gb bit-equal with a tree axis of 1; times as
                 above. K5's counts path (integer=True: dt's, the forest's
                 and the sweep's calls) identical to the plain version and
                 to its sums path, tree by tree and job by job; K4 over
                 20 trees of int32 bins (a row's words read once a group)
                 and at 20 trees x 2,048 nodes (the group's splits past
                 its shared table: windows of trees, and with the share
                 cut, splits from global memory), each tree bit-equal to
                 its launch alone; the CUDA kernels a K4 and a K5 call
                 run, and their device time with L2 evicted by reads
                 (no dirty lines left to write back). Then K7, both entry
                 points, against the plain twin on the same rows
                 standardized by scaler_stats, with 2 and 10 classes: loss
                 within 1e-6 relative, gradient within 1e-6, a second launch
                 bit identical; times cold (L2 overwritten) and warm. K7
                 also past the sweep's width: 20,000 features (rows read
                 from global memory) and 300 classes, 4,096 rows, at the
                 same tolerances.
6. fit         — ``make_classifier(...)`` fits dt, rf, gb, lr and nb on the
                 same 1,000,000 rows on the card, then evaluate_predict
                 (its launches counted alone: K6's are the summary's
                 ``evaluate_launches``), save_model and one request each
                 over HTTP. Held against
                 plain-version fits on the card (dt: identical heaps and
                 metrics; rf: the 20 trees in one chunk, one launch of K2,
                 K3 and K4 a level, heaps identical and leaf probabilities
                 within 1e-6 on the same draws, refit bit for bit; gb:
                 margins and accuracy within 1e-3; lr: losses
                 within 1e-5 relative, the same stop segment, probabilities
                 within 1e-4), gb and lr refit bit for bit, no host sync in
                 a level, round or L-BFGS segment; nb's theta and prior
                 within 4e-6 of a float64 host computation; a depth-12 dt
                 of 10 classes with heaps identical to its plain-version
                 fit; the fit kernels' launch counts per fit; K9's time.
7. embed-kernels — t-SNE's kernels against their plain versions on the
                 main path's own matrices: bench.py's embedding blobs (16
                 features, 10 centres) as the image requests read them
                 from the store, label column included (17 columns). K11
                 (calibrated affinities) at the landmark fit's 5,000 rows,
                 the exact fit's 20,000 and the quality fit's 2,048 (see
                 embed), each p within 1e-3 of its row's largest, rows
                 past it counted; K12 (Z, then the gradient) on each
                 fit's own P, at its start Y0 with exaggeration and at
                 its final embedding without, no farther from float64
                 than the plain version and within 1e-3 of the plain
                 gradient's largest entry (or twice the plain version's
                 distance from float64), three optimizer iterations each
                 way; the same checks on a seeded non-symmetric P at 1,
                 2, 261 and 300 rows (no pair, one pair, ragged tiles
                 with 4-byte and 16-byte copies of P); K13
                 (interpolation) of the 1,000,000 rows onto the 5,000
                 landmarks' fitted embedding in one launch, and of their
                 first 65,536 rows, within 1e-3 of the largest landmark
                 coordinate, a row's distances in global scratch bit
                 identical to shared memory; a second launch bit
                 identical, K11's distances in global memory bit
                 identical to shared; times cold beside their bounds
                 (one exp a bisection step for K11 and K13; Z and the
                 gradient over the unordered pairs). Then K10 (PCA, torch
                 ops) on the 1,000,000 x 17 matrix, cold and warm,
                 beside its bound.
8. embed       — the port's tsne and pca services over real HTTP on the
                 same store: PCA and t-SNE (auto: landmark) at 1,000,000
                 rows and t-SNE (auto: exact) at 20,000; each PNG read
                 back; K11-K13's launches per request (K12 two an
                 iteration). Each request's exact fit (the 20,000 rows;
                 the 5,000 landmarks) against the plain versions' fit
                 from the same X and Y0: KL(P || Q) within 2%; the
                 landmark request's interpolation against the plain
                 version on its own inputs, within 1e-3; the same at
                 2,048 rows, where half the iterations and a PCA
                 projection must fail the KL gate; the k = 10 label
                 agreement of each embedding against the 2,048-row plain
                 fit's; both t-SNE refits bit identical.
9. sweep       — the fused programs (K14) through ``ml/sweep.run_group`` on
                 bench.py's synthetic rows (1,000,000 train, seed 0; a
                 200,000-row eval draw, seed 1): bench.py's sweep_100 lr
                 grid (100 λ over linspace(0, 1), 25 iterations: 112
                 padded slots of 1,048,576 rows) and a dt depth grid {2,
                 5, 8} (three programs of 8 slots), each one member, each
                 run with the counts set to 0 just before it: K7
                 segments + iterations and iterations launches for the
                 whole group, K1 3 (a program's shared rows binned once
                 under its member's unstacked thresholds), K2-K4 15
                 each, K5 3, K6 3; points/s. Each depth's program over
                 the shared thresholds bit-equal (heaps, leaf
                 probabilities, metrics) to the same program over them
                 stacked slot by slot.
                 Both held against the same groups through the plain
                 versions on the card (lr: the same winner, every point's
                 probabilities within 1e-4; dt: heaps identical, leaf
                 probabilities within 1e-6). K7 (weighted), K1, K2 with
                 each job's bins, K4, K5 and K6 over 8 jobs: each job
                 bit-equal to a launch of it alone and within the plain
                 versions' tolerances; K7 also in each geometry its
                 wrappers choose: jobs sharing X in groups of 1, 7, 112
                 and 113 and the flood's 64 stacked jobs of 1,024 rows,
                 weighted and not, 2 and 10 classes, each job bit-equal
                 to its solo launch and a second launch bit identical;
                 each timed cold at the main path's shapes with the three
                 programs. Five lr members (own
                 data, 1,000,000 rows) and three dt members fused by a
                 Coalescer in one dispatch, bit-identical to their solo
                 runs; bench.py's flood of 64 concurrent lr jobs of 1,024
                 rows at a 10 ms window (one fused dispatch) and at 0.

10. models     — two builds of lr, dt, rf, gb and nb through the port's
                 model_builder app over HTTP, ``device=None`` (the card):
                 tests/data's Titanic CSVs (891 and 418 rows, projected to
                 the golden flow's fields, then ``ingest_csv`` and
                 ``convert_field_types``) with the documented
                 preprocessor, synchronously; and bench.py's product path
                 (100,000 rows x 16 features + label, its VectorAssembler
                 preprocessor), synchronously and ``async`` (waited on
                 through ``/jobs/<name>/wait``). Each build runs with the
                 counts set to 0 just before it; its launches of K1-K7 and
                 K6 and its K9 calls must be non-zero. Each prediction
                 collection must hold the test rows, its labels those its
                 ``.model`` gives through ``load_model`` on the card, its
                 accuracy and F1 numpy's on that model's eval labels
                 (within 1e-6), and ``POST /models/<name>/predict`` must
                 answer the same labels for 8 rows. Each data set's
                 request is then built once more, synchronously, with
                 every kernel of a build (K1-K7, K6's two forwards)
                 swapped for its plain version, and no kernel launched:
                 every build's labels must equal that build's, and its
                 probabilities and metrics agree within the fit phase's
                 tolerance of each classifier (PLAIN_BUILD_TOL). Prints
                 each classifier's phases (fit, checkpoint, evaluate,
                 write), the build's load_data and preprocess spans, its
                 wall and the plain-version build's.
11. stack      — the whole stack in one process, ``device=None``: (a) gb
                 and lr fits at 1,000,000 x 16 with a progress sink bound,
                 cut into 5 chunks of 4 rounds and 10 segments of 10
                 iterations (``LO_PROGRAM_ROW_STEPS`` 0.1, lr at tol 0),
                 stopped by the ``fit.segment`` fault after their first
                 saved segment and resumed from the artifact: each resumed
                 model bit-equal to an uninterrupted fit's, the segments
                 skipped counted, K1-K5 or K7 launched in the resumed
                 part. (b) The runner's ``start_all(ephemeral=True)`` over
                 a WAL store in a temporary directory, over HTTP: the
                 Titanic walkthrough (``POST /files`` of tests/data's
                 CSVs, projections, field types, a histogram, an async
                 five-classifier build with the documented preprocessor),
                 its metrics equal to ``build_model``'s on the same
                 collections; ``POST /models/sweep`` with the 100-point λ
                 grid and the dt depth grid {2, 5, 8} on bench.py's
                 product collections, the points bit-equal to a direct
                 ``run_sweep``, the winner's checkpoint answering
                 ``/models/<sweep_name>/predict`` with ``load_model``'s
                 labels, launches of K7, K1-K6 and K9 counted. (c) The
                 kill -9 drill: ``python -m
                 learningorchestra_tpu_torch.services.runner`` as a child
                 on the card, a 20,000-row CSV ingested and an async
                 five-classifier build with every builder phase delayed,
                 SIGKILL once a fit's segment is journaled, a restart on
                 the same data directory: the build finishes under its
                 name with every classifier's metrics equal to an
                 uninterrupted build's, ``/metrics`` shows segments
                 skipped and a resumed job, and every ingested row is
                 there. Prints each wall.

10. batch      — the five classifiers built over HTTP on the product
                 store (100,000 rows), a 1,000,000-row test collection of
                 its schema written columnar, and ``POST
                 /models/<name>/predictions`` for each ``.model``: K6
                 (ensemble and gb) launched on its rows, every written
                 label ``load_model``'s own on the preprocessed test
                 frame; a second request served by the device cache
                 (hits, no misses, no bytes copied to the card); an
                 ``insert_one`` moves the collection's rev and the next
                 request reads it again; evicting the cached device
                 matrices frees their bytes (``memory_allocated``). Each
                 request's wall and ``timings``.
11. store      — a primary store server (sync replication) and its
                 follower (automatic promotion) as child processes, the
                 seven services in this process over
                 ``connect("primary,follower")`` with a shared-memory
                 ring: the product collections and the 1,000,000-row
                 test collection ingested through the binary verbs; a
                 sync build whose metrics equal an in-process store's
                 build's; a gb batch request whose labels equal the same
                 request's in process, ``load_data`` over the ring and,
                 from a ringless client, over the HTTP body (bytes and
                 frames by road; the test collection's read alone by
                 each road in turns); a repeat served by the device
                 cache after rev probes over the wire (0 bytes copied);
                 a ``set_column_bin`` from another client that moves the
                 rev, and the reread; then ``kill -9`` of the primary:
                 the follower's promotion time and loss window (0), an
                 async build and a batch request with the values from
                 before. K1-K7 and K6 must launch during the phase.
12. shards     — two shard groups, each a primary store server (sync
                 replication) and its follower (automatic promotion), as
                 child processes; the seven services in this process over
                 ``connect("p0,f0;p1,f1")`` (a ``ShardedStore``, 8,192-row
                 stripes). bench.py's product rows and a 1,000,000-row
                 test file as CSVs through ``POST /files`` (the large one
                 natively in 5 slabs of ``LO_INGEST_SLAB_BYTES``) and
                 ``PATCH /fieldtypes``: every collection byte for byte
                 the Python parse's in an in-process store, before and
                 after the cast; each group's block rows as
                 ``ShardLayout(2, 8192)`` places them; one native parse
                 a slab, no fallback; the shard map. A sync build and a
                 gb batch request held to the in-process store's; ``kill
                 -9`` of group 1's primary (promotion s, loss window 0)
                 and a batch request with the labels from before;
                 model_builder's ``lo_store_shard_*`` gauges for both
                 groups. K1-K7 and K6 must launch during the phase. The
                 1,000,000-row CSV's ingest wall three ways (native slabs
                 over the shards, native whole and Python whole in
                 process), the build's and the batch request's walls
                 and ``load_data`` beside the store phase's one group.

13. bf16       — in a child process under ``LO_DTYPE_POLICY=bf16``: K1,
                 K6 (tree lanes, a thread a row, rows from global memory)
                 and K7 (both entry points, 2 and 10 classes) on bfloat16
                 X bit-equal to their float32 launches on the widened X
                 and held to their plain versions, at 1,000,000 × 16 and
                 at 5, 16, 17 and 32 features, timed cold and warm beside
                 the float32 form; K7 also on rows of 202, 444 and 20,000
                 features (4,096 rows: staged raw, and from global
                 memory), and an lr build on rows of 256 features (it
                 fits); the five-classifier product build and
                 a ``/predict`` (every build kernel launched, the cached
                 matrices bfloat16 at half the float32 bytes, every label
                 its ``.model``'s); a t-SNE request (201) and a PCA
                 request (the reference's 500: its ``eigh`` refuses
                 bfloat16); a λ sweep whose payload stays float32. Its
                 metrics beside the batch phase's float32 build's.

14. multigpu   — K8′ on the card against its plain twins: masked_col_sums
                 (pass 1 and the centred pass 2) and masked_standardize on
                 one rank's block of bench.py's 1,000,000 rows (padded to
                 1,048,576, the padding masked) and on 4,096 rows of 1, 5,
                 16, 17 and 256 features, one column constant: the sums
                 within 1e-12 of the largest, the stats within 1e-6 (the
                 constant column's scale 1), the standardization bit-equal;
                 K7's sums form at the block's shape, 2 and 10 classes:
                 within K7's tolerances of the twin, divided by sum w
                 bit-equal to the weighted launch. Each timed cold, warm,
                 on the profiler (L2 overwritten, and for K8′ evicted by
                 reads), beside its twin and its bound; a call of
                 masked_col_sums runs one kernel; the whole masked_stats
                 (both passes) beside torch.var_mean, the one PyTorch call
                 that gives both moments. Then ``fit_sharded`` at 1,000,000 x 16
                 through per-host feeding in child processes
                 (``chip_smoke.py multigpu-child``), each run's ranks
                 started together: (a) NCCL, one rank a card, with two
                 cards or more; (b) one NCCL rank on card 0; (c) four gloo
                 ranks sharing card 0 (CUDA tensors through gloo, or
                 through the host where this gloo refuses them), which also
                 run the SPMD ``fit`` of the full rows. The ranks of a run
                 hold the same bits (checked over the group); each run's
                 predictions agree with run (b)'s on 99.9% of rows and its
                 losses within 1e-5; run (c)'s ``fit`` agrees with the
                 one-process ``fit`` the same way; every kernel of the path
                 launched by every rank. K2's and K5's sums forms at a
                 depth-5 gb fit's levels and leaves on one rank's block
                 (262,144 and 1,048,576 rows): within 1e-12 of the twin,
                 rounded bit-equal to the float32 launch; K11's row slab
                 at the 5,000 landmarks cut four ways, bit-equal to the
                 whole launch's rows; K12's slab at the landmark fit's Y0
                 and final embedding, within embed-kernels' K12
                 tolerances, and at edge shapes (1 to 5,000 rows cut 1,
                 3 and 4 ways; P by the 16-byte and the 4-byte path, the
                 two bit-equal); each timed. In every child, after the lr
                 fits, the SPMD fits of dt, rf, gb and nb (their
                 ``evaluate_predict`` over the ranks), PCA and a landmark
                 t-SNE request at 1,000,000 rows; runs (b) and (c) held
                 against the one-process fits: dt and rf heaps identical,
                 gb's margins within 1e-5 (whether its heaps are
                 identical reported), nb within 1e-6, PCA within 1e-3 of
                 its largest coordinate, t-SNE's KL and kNN agreement
                 within the embed phase's bounds; every rank launched
                 the sums forms and the slabs. One record line a run
                 (backend, ranks, cards, ranks a card, walls, host
                 seconds in collectives, launches a rank, each fit's).

15. fleet      — a store server, two model_builder replicas
                 (``LO_FLEET_REPLICA`` 0 and 1, ``LO_FLEET_REPLICAS=2``,
                 ``LO_FLEET_RF=2``, ``LO_FLEET_DOWN_S=2``) and the router
                 (``LO_SERVICE=router``), each a process on the card, the
                 serve phase's five checkpoints in their shared models
                 directory. Both heartbeats list the five; the Titanic
                 build (sync, on replica 0) is followed by a
                 ``warmup:<file>`` job a checkpoint, K6 launches by the
                 tree warmups, and first predicts of each built model
                 (routed, then straight at replica 0) that add no
                 ``source="jit"`` compile event and no registry miss on
                 replica 0; an async build's ``/wait`` read as an event
                 stream ends in a ``done`` frame. Closed loops of 16
                 clients x 50 requests at 1 and 64 rows for each model,
                 through the router and straight at replica 0, every
                 answer held to the plain CPU forward, K6 launched on both
                 replicas. The drill: kill -9 of dt's primary while its
                 loop runs through the router: every answer a 200 for dt,
                 ``lo_router_retries_total`` up, then after the down
                 window the router's picture shows the dead replica
                 unhealthy and the survivor healthy, and a further loop
                 adds no retry. One record line: boot s, walls, the
                 warmup's jobs and launches, p50, p99 and requests/s of
                 each loop, the drill.

16. services   — a store server and seven runner processes, one a service
                 (``LO_SERVICE``, ``LO_PORT``), each on the card, every
                 collector ticking each second, ``LO_PLANE_MEMBERS`` naming
                 all seven. Under one ``X-Correlation-Id``: the Titanic
                 walkthrough, the product collections, an async
                 five-classifier build and a PCA image, held bit for
                 bit to an in-process twin over the same store (labels,
                 probabilities, metrics, the PNG); K1-K7 and K6 launched
                 in model_builder's process (its
                 ``lo_kernel_launches_total`` over the build) and in the
                 twin's; model_builder's ``/metrics`` (a compile event
                 a kernel library, the h2d bytes the twin's
                 ``h2d_bytes()`` counts, its d2h bytes, wire reads); the
                 build's Chrome trace and summary; the stitched trace's
                 process rows; a 2 s sampled profile during a build;
                 ``/metrics/history``; every SLO rule ok. One record line:
                 each child's boot s, the walls, the build with and
                 without a profile window over it (two each). The
                 builds' publish-time warmups are waited for before the
                 counters are read: launches and bytes include them on
                 both sides, and the build's and its warmups' traces
                 together hold the h2d bytes counted.

17. deploy     — after the build phase (the libraries exist), before
                 services: (a) ``python
                 -m learningorchestra_tpu_torch.deploy.stack`` with
                 ``LO_EPHEMERAL=1``, ``LO_AOT=1``, ``LO_AOT_PUBLISH=1``,
                 ``LO_RESTART_DELAY=0.5``: the store and seven services up,
                 each child's boot line naming ``cuda:0``,
                 ``stack_ports.json``; every runner's compile pass five
                 hits, model_builder's ``lo_aot_programs_compiled_total``
                 5 and its compile events five ``aot`` hits, no miss;
                 ``__lo_executables__`` five meta rows of this card's
                 fingerprint; a sync five-classifier build over REST at
                 100,000 x 16 (K1-K7 and K6 launched in model_builder)
                 bit-equal to ``build_model`` in this process on the card
                 over the same store; model_builder SIGKILLed, restarted
                 by the supervisor, a second build answering 201 with the
                 same outputs. (b) ``python -m
                 learningorchestra_tpu_torch.deploy.cluster up`` over the
                 local transport: a head (store and coordinator) and a
                 worker-only machine, both ``LO_DIST_BACKEND=gloo`` on
                 card 0, the manifest's ``compile`` section on, the
                 worker's ``LO_JIT_CACHE`` an empty folder of its own:
                 its pass fetches the five libraries from the head's
                 store (``hit/fleetcache`` = fetched, no miss, no nvcc);
                 a build over REST whose labels equal (a)'s one-process
                 build's (lr and gb as the multigpu runs hold them), the
                 worker rank's kernels launched and no compile miss; the
                 worker's runner SIGKILLed, every machine's group
                 relaunched by the driver, the next build 201 with the
                 same labels. One record line: each boot's seconds, the
                 passes' seconds, the fetch's beside the build phase's
                 cold nvcc seconds, the builds' walls beside the
                 in-process build's, the heals' seconds.

Then the ``kernels`` summary line (the bf16 forms as ``<kernel>:bf16``
rows), the card's ``nvidia-smi`` name and power
limit, and last ``{"ok": true, "device": {...}}``. Any failure raises and
exits non-zero without that last line. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from learningorchestra_tpu_torch import kernels
from learningorchestra_tpu_torch.ml import (
    binning,
    evaluation,
    logistic,
    make_classifier,
    naive_bayes,
    trees,
)
from learningorchestra_tpu_torch.ml.checkpoint import (
    checkpoint_path,
    load_model,
    model_from_arrays,
    save_model,
    write_checkpoint,
)
from learningorchestra_tpu_torch.ml.base import segment_steps
from learningorchestra_tpu_torch.core.store import InMemoryStore
from learningorchestra_tpu_torch.ml.trees import GBT_ROUNDS, GBT_STEP, MAX_DEPTH, NUM_TREES
from learningorchestra_tpu_torch.ops import pca, tsne
from learningorchestra_tpu_torch.serve import ServePlane
from learningorchestra_tpu_torch.serve import config as serve_config
from learningorchestra_tpu_torch.services.model_builder import create_app
from learningorchestra_tpu_torch.utils.web import ServerThread

FEATURES = 16          # bench.py's synthetic width
CLASSES = 2
DEPTH = MAX_DEPTH      # the repo's default models at full width
TREES = NUM_TREES      # rf trees; gb rounds are the same 20
STEP = GBT_STEP
MAX_BINS = 32
KERNEL_ROWS = (1, 64, 4096, 1_048_576)
TIMED_ROWS = (64, 4096, 1_048_576)
TREE_TOL = 1e-6
# K6 a thread a row on rows wider than the items a thread fetches ahead
# (4 words), and a share that cuts its tile below a block's 256 threads
WIDE_FEATURES, WIDE_SHARE, WIDE_CALLS = 32, 30_000, 10
LINEAR_TOL = 1e-5      # lr/nb: the GEMM sums in another order on the card
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 ops/s off the
# tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12
# Overwritten between the timed calls of a fit kernel, so that each call
# reads its inputs from HBM: five times the H100's 50 MB L2
L2_FLUSH_BYTES = 256 << 20

KERNEL_SOURCE = "learningorchestra_tpu_torch/kernels/csrc/tree_forward.cu"
FIT_SOURCE = "learningorchestra_tpu_torch/kernels/csrc/tree_fit.cu"
REPLACES = {
    "tree_ensemble_forward": (
        "learningorchestra_tpu/ml/trees.py:303 _descend under :364 _ensemble_forward"
    ),
    "gbt_forward": "learningorchestra_tpu/ml/trees.py:303 _descend under :648 _gbt_forward",
}
FIT_REPLACES = {
    "apply_bins": "learningorchestra_tpu/ml/binning.py:37 apply_bins",
    "level_histograms": (
        "learningorchestra_tpu/ml/trees.py:66 _level_histograms (also vmapped over trees, :437)"
    ),
    "select_splits": (
        "learningorchestra_tpu/ml/trees.py:160 _gini_gain, :181 _newton_gain, "
        ":196 _select_splits (with feature subsets, :201-206)"
    ),
    "route": (
        "learningorchestra_tpu/ml/trees.py:235 _route (:217 _indicator_lookup; "
        "also vmapped over trees, :437)"
    ),
    "leaf_sums": "learningorchestra_tpu/ml/trees.py:142 _leaf_sums (also vmapped over trees, :437)",
}
FOREST_KERNELS = ("level_histograms", "select_splits", "route", "leaf_sums")
SUBSET_K = int(np.ceil(np.sqrt(FEATURES)))   # rf's feature subsets: 4 of 16
WIDE_FOREST_ROWS = 100_000   # the windowed forest level: rows enough for every node
LOGISTIC_SOURCE = "learningorchestra_tpu_torch/kernels/csrc/logistic.cu"
LOGISTIC_REPLACES = {
    "logistic_loss_grad": (
        "learningorchestra_tpu/ml/logistic.py:35 _loss_fn under value_and_grad "
        "in :141 _fit_segment_impl"
    ),
    "logistic_trial_losses": (
        "learningorchestra_tpu/ml/logistic.py:35 _loss_fn in the Armijo loop "
        ":176-200 of :141 _fit_segment_impl"
    ),
}
FIT_KERNELS = tuple(FIT_REPLACES) + tuple(LOGISTIC_REPLACES)
FIT_ROWS = 1_000_000   # bench.py's synthetic rows
GB_SUM_RTOL = 1e-5     # gb sums: float64 atomics in the plain version's scatter
FIT_MARGIN_TOL = 1e-3  # gb fit against the plain-version fit: margins, accuracy
# K7 against its plain twin: both sum rows in float64; the logits round in
# another order (fmaf in the kernel, cuBLAS in the twin)
K7_LOSS_RTOL = 1e-6
K7_GRAD_ATOL = 1e-6
LR_LOSS_RTOL = 1e-5    # lr fit against the plain-version fit, per iteration
LR_PROB_TOL = 1e-4     # and its probabilities
# nb theta and prior against float64 on the host: each is a float32
# difference of two logs near 16 (sums near 1e7), where one float32 step
# is 1.9e-6
NB_TOL = 4e-6
DEEP_DEPTH, DEEP_CLASSES = 12, 10   # the deep dt: 2,048 nodes at its last level
# H100 SXM float64 peak off the tensor cores (NVIDIA data sheet): K7 sums
# its gradient in float64
PEAK_FP64_OPS_PER_S = 33.5e12
# CUDA kernels of each device program; the profiler sums their device time
DEVICE_KERNELS = {
    "tree_ensemble_forward": ("tree_ensemble_forward_kernel",),
    "gbt_forward": ("gbt_forward_kernel",),
    "apply_bins": ("apply_bins_kernel",),
    # the counts path's memset of its output is part of its work
    "level_histograms": (
        "level_histograms_kernel", "sum_partials_kernel", "level_counts_kernel",
        "counts_to_float_kernel", "Memset",
    ),
    "select_splits": ("select_splits_kernel",),
    "route": ("route_kernel",),
    # the counts path is one kernel; the sums path one, or two past one
    # block's partials
    "leaf_sums": ("leaf_counts_kernel", "leaf_sums_kernel", "sum_partials_kernel"),
    "logistic_loss_grad": ("loss_grad_kernel", "finish_kernel"),
    "logistic_trial_losses": ("trial_losses_kernel", "finish_kernel"),
    "tsne_affinities": ("distances_kernel", "affinities_kernel"),
    "tsne_z": ("z_pairs_kernel", "z_total_kernel"),
    "tsne_grad": ("gradient_pairs_kernel", "gradient_finish_kernel"),
    "tsne_interpolate": ("interpolate_kernel",),
}
TSNE_SOURCE = "learningorchestra_tpu_torch/kernels/csrc/tsne.cu"
TSNE_REPLACES = {
    "tsne_affinities": (
        "learningorchestra_tpu/ops/tsne.py:122 _affinities with :65 _squared_distances "
        "and :79 _calibrate_row_block"
    ),
    "tsne_z": "learningorchestra_tpu/ops/tsne.py:170 _optimize, its gradient's normalizer (:192-198)",
    "tsne_grad": "learningorchestra_tpu/ops/tsne.py:170 _optimize, its gradient (:192-205)",
    "tsne_interpolate": "learningorchestra_tpu/ops/tsne.py:315 _interpolate",
}
TSNE_KERNELS = tuple(TSNE_REPLACES)
EMBED_ROWS = 1_000_000          # bench.py's embedding rows (its EMBED_ROWS)
EXACT_ROWS = tsne.EXACT_ROWS_LIMIT   # the largest exact t-SNE: 20,000 rows
QUALITY_ROWS = 2_048            # bench.py's head-to-head t-SNE size
INTERP_ROWS = 65_536            # K13 also on the first rows alone
QUALITY_SAMPLE, QUALITY_K = 4_000, 10
# Kernel against plain version on the same inputs, and why:
# K11: each p within 1e-3 of its row's largest p. The kernel's distances
# (a sequential fmaf dot) and the plain version's (cuBLAS) round apart by
# a few float32 steps of |x|^2 (~1,000 here, ~1e-4 apart), and p =
# exp(-beta d) moves by beta times that.
K11_TOL = 1e-3
# K12: Z within 1e-5 relative (float64 row sums against torch's float32
# sum); the gradient no farther from a float64 evaluation of the same
# expressions than the plain version is (1e-6 of the largest entry of
# slack), and so within 1e-3 of the plain version's largest entry or
# within twice the plain version's own distance from float64, whichever
# is larger; three iterations of the optimizer within 1e-4 of the largest
# coordinate. The reference's |a|^2 + |b|^2 - 2 a.b rounds at |y|^2 ~
# 3,600 (coordinates up to ~60), and the gradient 4 (s_i y_i - t_i) is a
# difference of two sums: at a fit's start both float32 versions sit
# ~2e-7 of the largest entry from float64, but at its final embedding,
# where attraction and repulsion nearly cancel, 1e-2 (5,000 and 20,000
# rows on an H100; the kernel the nearer of the two).
K12_Z_RTOL = 1e-5
K12_PLAIN_TOL = 1e-3
K12_FLOAT64_SLACK = 1e-6
K12_TOL = 1e-4
# K13: within 1e-3 of the landmarks' largest coordinate (K11's distances,
# then a float64 sum against a float32 product).
K13_TOL = 1e-3
# The 2,048-row exact fit by the kernels against the plain versions' fit
# from the same Y0: k = 10 label agreement within 0.02 (t-SNE is chaotic,
# so the two embeddings part; their quality must not); the main path's
# t-SNE embeddings no worse than the plain fit less the same margin.
QUALITY_MARGIN = 0.02
# Each exact fit of the main path (and the 2,048-row fit) against the
# plain versions' fit from the same P and Y0: KL(P || Q) of the two final
# embeddings within 2% of the plain fit's. Four 2,048-row fits whose Y0
# differ by a float32 step or less part by 0.6% in KL; half the
# iterations leave it 5% higher, a PCA projection 40% (the port's plain
# versions on a CPU). The 2,048-row fit's controls, half its iterations
# and the PCA projection, must fall outside the margin.
KL_MARGIN = 0.02
# The t-SNE kernels' work is mostly not multiply-adds: it is counted in
# float32 instructions, a fused multiply-add one of them, at the card's
# instruction rate, half the 67 TFLOP/s that counts a multiply-add as two.
PEAK_FP32_INSTRUCTIONS_PER_S = PEAK_FP32_OPS_PER_S / 2
# Float64 instructions (an add, or a fused multiply-add counted once) at
# half the float32 instruction rate: 33.5 TFLOP/s counts a fused
# multiply-add as two
PEAK_FP64_INSTRUCTIONS_PER_S = PEAK_FP64_OPS_PER_S / 2
# The float32 instructions a t-SNE kernel needs, an exp and a division
# one each (a lower bound: each is several on the card), counted from the
# kernels' arithmetic (tsne.cu). K11 and K13, for one (row, column) pair:
# a distance from the norms (a multiply-add a feature, three more); each
# of 32 bisection steps one pass (multiply, subtract, exp, add into the
# total, multiply-add of e and the logit into the entropy's sum; the log
# and the division are the row's, not the pair's); the final pass's
# multiply, subtract, exp and add, then K11's p (multiply, subtract, exp,
# divide) or K13's two multiply-adds into sum e y.
TSNE_STEP_INSTRUCTIONS = 5
TSNE_AFFINITY_INSTRUCTIONS = 32 * TSNE_STEP_INSTRUCTIONS + 4 + 4
TSNE_INTERPOLATION_INSTRUCTIONS = 32 * TSNE_STEP_INSTRUCTIONS + 4 + 2
# K12, for one unordered pair {i, j}, done once: 1 / (1 + d) of two 2-D
# rows from their norms; q and its floor; and for each of W_ij and W_ji
# the exaggerated P less q, W, and its three float64 sums. Z: the inverse
# and its sum. Both over the n (n - 1) / 2 unordered pairs.
TSNE_INVERSE_INSTRUCTIONS = 7
TSNE_GRADIENT_PAIR_INSTRUCTIONS = TSNE_INVERSE_INSTRUCTIONS + 2 + 2 * 6


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


# --------------------------------------------------------------------------
# Seeded parameters in the shapes and dtypes a fit writes
# --------------------------------------------------------------------------

def bench_rows(rng, rows: int, features: int = FEATURES) -> np.ndarray:
    """bench.py-style rows: uniform x 20, float32."""
    return rng.random((rows, features), dtype=np.float32) * 20.0


def bench_synthetic(rows: int, seed: int = 0):
    """bench.py's synthetic classification data (its ``_synthetic``): 16
    uniform features in [0, 20), a noisy threshold on two of them."""
    rng = np.random.default_rng(seed)
    X = rng.random((rows, FEATURES), dtype=np.float32) * 20.0
    y = (
        (X[:, 0] + X[:, 1] * 0.5 + rng.random(rows, dtype=np.float32) * 8) > 22
    ).astype(np.int32)
    return X, y


def _heaps(rng, thresholds, count: int, depth: int, leaf_rate: float = 0.1):
    """``features_heap`` and ``thresholds_heap`` of ``count`` trees grown
    as a fit grows them: a node whose parent stopped splitting stops too
    (feature -1), and a split's threshold is one of the feature's quantile
    thresholds."""
    features, bins = thresholds.shape
    nodes = 2**depth - 1
    features_heap = np.full((count, nodes), -1, np.int32)
    thresholds_heap = np.full((count, nodes), thresholds[0, 0], np.float32)
    for tree in range(count):
        for node in range(nodes):
            parent_split = node == 0 or features_heap[tree, (node - 1) // 2] >= 0
            if parent_split and rng.random() >= leaf_rate:
                feature = int(rng.integers(features))
                features_heap[tree, node] = feature
                thresholds_heap[tree, node] = thresholds[feature, rng.integers(bins)]
    return features_heap, thresholds_heap


def synthetic_checkpoints(
    seed: int = 0,
    features: int = FEATURES,
    depth: int = DEPTH,
    num_trees: int = TREES,
    classes: int = CLASSES,
) -> dict:
    """``{name: (kind, arrays, scalars)}`` for dt, rf, gb, lr and nb, with
    seeded parameters in exactly the shapes and dtypes the fits write."""
    rng = np.random.default_rng(seed)
    X = bench_rows(rng, 4096, features)
    quantiles = np.linspace(0, 1, MAX_BINS + 1)[1:-1]
    thresholds = np.quantile(X.astype(np.float64), quantiles, axis=0).T
    thresholds[-1] = np.inf  # a constant training feature: never splits right
    thresholds = thresholds.astype(np.float32)
    leaves = 2**depth

    def leaf_probs(count):
        return rng.dirichlet(np.ones(classes), size=(count, leaves)).astype(np.float32)

    dt = _heaps(rng, thresholds, 1, depth)
    rf = _heaps(rng, thresholds, num_trees, depth)
    gb = _heaps(rng, thresholds, num_trees, depth)
    theta = rng.random((classes, features)) + 0.1
    prior = rng.random(classes) + 0.5
    return {
        "dt": (
            "tree_ensemble",
            {"features_heap": dt[0], "thresholds_heap": dt[1], "leaf_probs": leaf_probs(1)},
            {"max_depth": depth},
        ),
        "rf": (
            "tree_ensemble",
            {"features_heap": rf[0], "thresholds_heap": rf[1], "leaf_probs": leaf_probs(num_trees)},
            {"max_depth": depth},
        ),
        "gb": (
            "gbt",
            {
                "features_heap": gb[0],
                "thresholds_heap": gb[1],
                "leaf_values": (rng.normal(size=(num_trees, leaves)) * 2).astype(np.float32),
            },
            {"f0": float(np.float32(-0.2)), "step": STEP, "max_depth": depth},
        ),
        "lr": (
            "logistic",
            {
                "w": rng.normal(size=(features, classes)).astype(np.float32),
                "b": rng.normal(size=classes).astype(np.float32),
                "mean": X.mean(axis=0, dtype=np.float64).astype(np.float32),
                "scale": X.std(axis=0, dtype=np.float64).astype(np.float32),
            },
            {},
        ),
        "nb": (
            "naive_bayes",
            {
                "theta": np.log(theta / theta.sum(axis=1, keepdims=True)).astype(np.float32),
                "prior": np.log(prior / prior.sum()).astype(np.float32),
            },
            {},
        ),
    }


# --------------------------------------------------------------------------
# Phases
# --------------------------------------------------------------------------

def nvidia_smi_line() -> str:
    result = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return result.stdout.strip().splitlines()[0]


def phase_device(torch) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; a CUDA card is required")
    card = nvidia_smi_line()
    emit({
        "phase": "device",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": card,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    })
    return {"card": card}


# SASS opcodes counted in each kernel: the pipes that run at a quarter of
# the float32 rate or less (MUFU, conversions, FCHK), float64 and barriers
SASS_COUNTED = ("MUFU", "F2F", "FCHK", "DADD", "DFMA", "DMUL", "SHFL", "BAR", "LDGSTS")


def sass_summary(library_path: str) -> dict | None:
    """Per kernel of a built library, from ``cuobjdump -sass``: its SASS
    instruction count and the counts of ``SASS_COUNTED``. None when the
    toolkit has no cuobjdump."""
    import re

    cuobjdump = os.path.join(os.path.dirname(kernels._find_nvcc()), "cuobjdump")
    if not os.path.isfile(cuobjdump):
        return None
    text = subprocess.run(
        [cuobjdump, "-sass", library_path], capture_output=True, text=True, timeout=120, check=True
    ).stdout
    summary = {}
    for section in re.split(r"\n\s*Function : ", text)[1:]:
        name = section.split("\n", 1)[0].strip()
        counts = dict.fromkeys(SASS_COUNTED, 0)
        total = 0
        for instruction in re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", section):
            words = instruction.split()
            opcode = (words[1] if words[0].startswith("@") else words[0]).split(".")[0]
            total += opcode != "NOP"
            if opcode in counts:
                counts[opcode] += 1
        # the kernel's own name, and its integer template arguments if it has any
        short = re.search(r"\d([a-z][a-z_]*?_kernel)(?:I((?:L\w\d+E)+)E)?", name)
        arguments = re.findall(r"L\w(\d+)E", short.group(2) or "") if short else []
        key = name if short is None else short.group(1) + (f"<{','.join(arguments)}>" if arguments else "")
        summary[key] = {"instructions": total, **counts}
    return summary


def phase_build() -> None:
    started = time.perf_counter()
    # one nvcc per source, all started together
    with ThreadPoolExecutor(max_workers=len(kernels.SOURCES)) as pool:
        for future in [pool.submit(kernels.build, name) for name in kernels.SOURCES]:
            future.result()
    libraries = {}
    for name in kernels.SOURCES:
        kernels.library(name)
        info = kernels.build_info[name]
        libraries[name] = {
            "seconds": info["seconds"],
            "built": info["built"],
            "library": os.path.relpath(info["path"]),
            "ptxas": [
                line.strip() for line in info["ptxas"].splitlines()
                if "registers" in line or "Compiling entry" in line or "spill" in line
            ],
            "sass": sass_summary(info["path"]),
        }
    emit({"phase": "build", "seconds": time.perf_counter() - started, "libraries": libraries})


def _kernel_inputs(torch, rows: int, count: int, seed: int, features: int = FEATURES):
    """Rows and heaps for the kernel checks: early leaves anywhere
    (feature -1), inf thresholds, NaN in selected and unselected columns."""
    rng = np.random.default_rng(seed)
    nodes, leaves = 2**DEPTH - 1, 2**DEPTH
    X = bench_rows(rng, rows, features)
    X[rng.random(X.shape) < 0.05] = np.nan
    features_heap = rng.integers(-1, features, size=(count, nodes)).astype(np.int32)
    thresholds_heap = (rng.random((count, nodes)) * 20).astype(np.float32)
    thresholds_heap[rng.random((count, nodes)) < 0.1] = np.inf
    leaf_probs = rng.dirichlet(np.ones(CLASSES), size=(count, leaves)).astype(np.float32)
    leaf_values = rng.normal(size=(count, leaves)).astype(np.float32)

    def cuda(array):
        return torch.from_numpy(array).cuda()

    return (
        cuda(X), cuda(features_heap), cuda(thresholds_heap),
        cuda(leaf_probs), cuda(leaf_values),
    )


def _event_ms(torch, fn, repeats: int, flush=None) -> float:
    """Mean milliseconds per call of ``fn`` on the stream: back to back,
    or, given a ``flush`` buffer, each call alone right after the buffer
    is overwritten, so that it finds none of its inputs in L2."""
    fn()
    torch.cuda.synchronize()
    if flush is not None:
        pairs = []
        for _ in range(repeats):
            flush.zero_()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return sum(start.elapsed_time(end) for start, end in pairs) / repeats
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


# Cycles of the spin kernel that keeps the card busy while the host
# enqueues the first work of a trace (~6 ms on an H100)
SPIN_CYCLES = 10_000_000


def _trace_device_us(events, kernel_names, wall_ms: float) -> tuple[float, int]:
    """Device microseconds and launches of the kernels whose names contain
    one of ``kernel_names`` (every device event when that is None) in a
    trace's device ``events``, (name, start_us, end_us) on the trace's
    clock, which CUDA events measured as ``wall_ms`` from the first one's
    start to the last one's end. The trace's clock can be off by a factor
    over a whole trace (0.49 to 1.03 of CUDA events' on an H100), so the
    kernels' time is their share of the span from the first event's
    start to the last one's end, times ``wall_ms``: a share and a span of
    one clock."""
    first, last, named_us, launches = float("inf"), float("-inf"), 0.0, 0
    for name, start_us, end_us in events:
        first, last = min(first, start_us), max(last, end_us)
        if kernel_names is None or any(wanted in name for wanted in kernel_names):
            named_us += end_us - start_us
            launches += 1
    if launches == 0 or last <= first:
        return 0.0, launches
    return named_us / (last - first) * wall_ms * 1000.0, launches


def _profile_device_us(torch, fn, kernel_names=None, event_clock: bool = True) -> tuple[float, int]:
    """Device microseconds and launches of the CUDA kernels whose names
    contain one of ``kernel_names``, or of every CUDA kernel when that is
    None, while ``fn`` runs: from the profiler's trace of the card, put on
    the clock of CUDA events recorded around ``fn`` (``_trace_device_us``).
    A spin kernel ahead of the start event (and out of the count) keeps
    the card busy until ``fn``'s first work is enqueued, so that the events
    span the same time as ``fn``'s device events. With ``event_clock``
    False, the trace's own sum of every device event's time: for a
    ``fn`` whose host work precedes its first device work (a fit's
    thresholds), the events' span holds that host time too, and the
    share of the trace's span would count it as busy."""
    from torch.profiler import ProfilerActivity, profile

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    events = [
        (event.name, event.time_range.start, event.time_range.end)
        for event in prof.events()
        if "CUDA" in str(getattr(event, "device_type", "")) and "spin_kernel" not in event.name
    ]
    if not event_clock:
        return sum(end_us - start_us for _, start_us, end_us in events), len(events)
    return _trace_device_us(events, kernel_names, start.elapsed_time(end))


def _busy_ms(torch, fn):
    """Device milliseconds of every device event (kernels, copies,
    memsets) in the trace of ``fn``, on the trace's own clock; None when
    the trace shows no device time (the profiler missed it)."""
    total_us, _ = _profile_device_us(torch, fn, event_clock=False)
    return total_us / 1000.0 if total_us > 0 else None


# Traces taken for one device time before it is given up as not measured,
# and the traces that lost launches (reported before the summary)
PROFILE_ATTEMPTS = 3
LOST_TRACES: list = []


def _device_ms(torch, fn, kernel_names, repeats: int, flush=None):
    """Mean device milliseconds per call of ``fn`` in the CUDA kernels
    named ``kernel_names``, from the profiler's trace of the card. Given a
    ``flush`` buffer, it is overwritten before each call (the fill's own
    kernel is not counted). The profiler can lose a kernel's records, and
    a trace that lost some gives a time below the truth: a trace of the
    ``repeats`` calls counts only when it shows ``repeats`` times the
    most launches that a trace of one call has shown. None when no trace
    of ``PROFILE_ATTEMPTS`` does, or when the trace has no device time for
    the kernels."""

    def calls(count):
        def run():
            for _ in range(count):
                if flush is not None:
                    flush.zero_()
                fn()

        return run

    per_call = 0
    for _ in range(PROFILE_ATTEMPTS):
        per_call = max(per_call, _profile_device_us(torch, calls(1), kernel_names)[1])
        total_us, launches = _profile_device_us(torch, calls(repeats), kernel_names)
        if per_call > 0 and launches == per_call * repeats:
            return total_us / 1000.0 / repeats if total_us > 0 else None
        LOST_TRACES.append({
            "kernels": list(kernel_names), "launches": launches, "expected": per_call * repeats,
        })
    return None


def _bound(rows: int, count: int, kernel: str, x_bytes: int = 4) -> tuple[float, str]:
    """Least milliseconds the card could take: bytes (X read once, at
    ``x_bytes`` a value, the output written once, the heaps read once) over
    HBM bandwidth against float32 operations (D compares per row and tree,
    plus C adds for the mean or a multiply and an add for the margin) over
    the float32 peak."""
    nodes, leaves = 2**DEPTH - 1, 2**DEPTH
    per_leaf = CLASSES if kernel == "tree_ensemble_forward" else 1
    heap_bytes = count * (nodes * 8 + leaves * per_leaf * 4)
    bytes_moved = rows * FEATURES * x_bytes + rows * CLASSES * 4 + heap_bytes
    ops = rows * count * (DEPTH + (CLASSES if kernel == "tree_ensemble_forward" else 2))
    byte_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
    op_ms = ops / PEAK_FP32_OPS_PER_S * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def phase_kernels(torch) -> dict:
    results = {name: {"max_abs_err": 0.0, "bit_equal": True, "by_rows": {}} for name in REPLACES}
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    read_flush = _ReadFlush(torch, flush.device)
    for rows in KERNEL_ROWS:
        for tree_count in (1, TREES):
            X, fh, th, lp, lv = _kernel_inputs(torch, rows, tree_count, seed=rows + tree_count)
            calls = {
                "tree_ensemble_forward": (
                    lambda: trees.ensemble_forward(X, fh, th, lp, DEPTH),
                    lambda: trees._ensemble_forward(X, fh, th, lp, DEPTH),
                ),
                "gbt_forward": (
                    lambda: trees.gbt_forward(X, -0.2, fh, th, lv, STEP, DEPTH),
                    lambda: trees._gbt_forward(X, -0.2, fh, th, lv, STEP, DEPTH),
                ),
            }
            for name, (kernel, plain) in calls.items():
                got, want = kernel(), plain()
                torch.cuda.synchronize()
                if got.shape != want.shape or not torch.isfinite(got).all():
                    raise AssertionError(f"{name} at {rows} rows: bad output {got.shape}")
                error = float((got - want).abs().max())
                if error > TREE_TOL:
                    raise AssertionError(f"{name} at {rows} rows, {tree_count} trees: err {error}")
                if not torch.equal(got.argmax(1), want.argmax(1)):
                    raise AssertionError(f"{name} at {rows} rows: labels differ")
                # the ensemble's sums and division are the plain version's
                # float32 operations in its order: the same bits
                if name == "tree_ensemble_forward" and not torch.equal(got, want):
                    raise AssertionError(f"{name} at {rows} rows, {tree_count} trees: not bit-equal")
                results[name]["bit_equal"] &= bool(torch.equal(got, want))
                results[name]["max_abs_err"] = max(results[name]["max_abs_err"], error)
                if rows in TIMED_ROWS and tree_count == TREES:
                    repeats = 200 if rows <= 4096 else 50
                    bound_ms, bound_by = _bound(rows, tree_count, name)
                    results[name]["by_rows"][rows] = {
                        "ms": _event_ms(torch, kernel, repeats),
                        "device_ms": _device_ms(torch, kernel, DEVICE_KERNELS[name], repeats),
                        "ms_cold": _event_ms(torch, kernel, 20, flush),
                        "device_ms_cold": _device_ms(torch, kernel, DEVICE_KERNELS[name], 20, flush),
                        "device_ms_clean_l2": _device_ms(torch, kernel, DEVICE_KERNELS[name], 20, read_flush),
                        "plain_ms": _event_ms(torch, plain, max(5, repeats // 10)),
                        "bound_ms": bound_ms,
                        "bound_by": bound_by,
                        "geometry": trees._forward_geometry(
                            rows, FEATURES, tree_count, DEPTH,
                            CLASSES if name == "tree_ensemble_forward" else 1,
                        )._asdict(),
                    }
    linear = _linear_forward_times(torch)
    emit({
        "phase": "kernels", "rows": KERNEL_ROWS, "trees": (1, TREES), **results,
        "wide_rows": check_wide_rows(torch), "linear_forwards": linear,
    })
    return results


def check_wide_rows(torch) -> dict:
    """K6 a thread a row on rows wider than a thread's items fetched ahead:
    1,048,576 rows of WIDE_FEATURES features through 20 trees of depth 5,
    the ensemble's and gb's, at the geometry's tile (a row a thread) and
    with the share cut to WIDE_SHARE, so that a tile holds fewer rows than
    a block has threads and the threads past them stage the next tile
    while the others still walk this one. Every call of WIDE_CALLS is
    bit-equal to the plain version; the times beside."""
    rows = KERNEL_ROWS[-1]
    X, fh, th, lp, lv = _kernel_inputs(torch, rows, TREES, seed=WIDE_FEATURES, features=WIDE_FEATURES)
    calls = {
        "tree_ensemble_forward": (
            CLASSES,
            lambda: trees.ensemble_forward(X, fh, th, lp, DEPTH),
            lambda: trees._ensemble_forward(X, fh, th, lp, DEPTH),
        ),
        "gbt_forward": (
            1,
            lambda: trees.gbt_forward(X, -0.2, fh, th, lv, STEP, DEPTH),
            lambda: trees._gbt_forward(X, -0.2, fh, th, lv, STEP, DEPTH),
        ),
    }
    record = {}
    saved = trees._FORWARD_SHARE
    try:
        for share in (saved, WIDE_SHARE):
            trees._FORWARD_SHARE = share
            for name, (classes, kernel, plain) in calls.items():
                geometry = trees._forward_geometry(rows, WIDE_FEATURES, TREES, DEPTH, classes)
                if not geometry.row_threads:
                    raise AssertionError(f"{name} at {WIDE_FEATURES} features: not a thread a row ({geometry})")
                want = plain()
                for call in range(WIDE_CALLS):
                    if not torch.equal(kernel(), want):
                        raise AssertionError(
                            f"{name} at {WIDE_FEATURES} features, share {share}, call {call}: not bit-equal"
                        )
                record[f"{name}:share_{share}"] = {
                    "ms": _event_ms(torch, kernel, 20), "geometry": geometry._asdict(),
                }
    finally:
        trees._FORWARD_SHARE = saved
    return {"bit_equal": True, "rows": rows, "features": WIDE_FEATURES, "calls": WIDE_CALLS, **record}


def _linear_forward_times(torch) -> dict:
    """The lr and nb forwards (K8: ``torch.matmul`` + softmax, no hand
    kernel) at the serve and batch shapes, beside their bound: X read once,
    the probabilities written once, over HBM bandwidth (their float32
    operations, ~5 per weight, are far below the peak)."""
    rng = np.random.default_rng(11)
    checkpoints = synthetic_checkpoints(seed=0)
    times = {}
    for name in ("lr", "nb"):
        model = model_from_arrays(*checkpoints[name])
        times[name] = {}
        for rows in TIMED_ROWS:
            X = torch.from_numpy(bench_rows(rng, rows)).cuda()
            bytes_moved = rows * FEATURES * 4 + rows * CLASSES * 4
            ops = rows * CLASSES * (2 * FEATURES + 5)
            byte_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
            op_ms = ops / PEAK_FP32_OPS_PER_S * 1e3
            times[name][rows] = {
                "ms": _event_ms(torch, lambda: model._forward(X), 200 if rows <= 4096 else 50),
                "bound_ms": max(byte_ms, op_ms),
                "bound_by": "bytes" if byte_ms >= op_ms else "operations",
            }
    return times


class _Client:
    """JSON over HTTP to the local server, never through a proxy; every
    request carries ``headers`` (a correlation ID, say)."""

    def __init__(self, port: int, headers: "dict | None" = None):
        self.base = f"http://127.0.0.1:{port}"
        self.opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
        self.headers = dict(headers or {})

    def call(self, method: str, path: str, payload=None) -> tuple[int, dict]:
        data = None if payload is None else json.dumps(payload).encode()
        request = urllib.request.Request(
            self.base + path, data=data, method=method,
            headers={"Content-Type": "application/json", **self.headers},
        )
        try:
            with self.opener.open(request, timeout=120) as response:
                return response.status, json.loads(response.read())
        except urllib.error.HTTPError as error:
            return error.code, json.loads(error.read())


def _check_answer(name, status, body, rows, reference, tolerance) -> None:
    if status != 200:
        raise AssertionError(f"{name}: status {status} {body}")
    result = body["result"]
    labels = np.asarray(result["predictions"])
    probs = np.asarray(result["probabilities"], dtype=np.float64)
    if probs.shape != (len(rows), CLASSES) or not np.isfinite(probs).all():
        raise AssertionError(f"{name}: probabilities of shape {probs.shape}")
    if not np.array_equal(labels, probs.argmax(axis=1)):
        raise AssertionError(f"{name}: labels are not the argmax of the probabilities")
    error = np.abs(probs - reference).max()
    if error > tolerance:
        raise AssertionError(f"{name}: probabilities differ from the CPU forward by {error}")


def _serve_rounds(client, models: dict, single, full=None) -> tuple:
    """Each model's single rows one at a time, then 8 of them at once
    (and, given ``full``, one request of that many rows), every answer
    held to the plain CPU forward. Returns the single rows' and the
    concurrent requests' latencies (ms) and the answers checked."""
    single_ms, concurrent_ms, checks = [], [], 0
    for name, (cpu_model, tolerance) in models.items():
        path = f"/models/{name}/predict"
        for row in single:
            started = time.perf_counter()
            status, body = client.call("POST", path, {"rows": [row.tolist()]})
            single_ms.append((time.perf_counter() - started) * 1e3)
            _check_answer(name, status, body, row[None], cpu_model.predict_proba(row[None]), tolerance)
            checks += 1
        answers: list = [None] * 8
        barrier = threading.Barrier(8)

        def one(index, _path=path):
            barrier.wait(timeout=60)
            started = time.perf_counter()
            answers[index] = client.call("POST", _path, {"rows": [single[index].tolist()]})
            concurrent_ms.append((time.perf_counter() - started) * 1e3)

        workers = [threading.Thread(target=one, args=(i,)) for i in range(8)]
        for worker in workers:
            worker.start()
        for worker in workers:
            worker.join(timeout=120)
            if worker.is_alive():
                raise AssertionError(f"{name}: a concurrent request did not finish")
        for index, (status, body) in enumerate(answers):
            row = single[index][None]
            _check_answer(name, status, body, row, cpu_model.predict_proba(row), tolerance)
            checks += 1
        if full is not None:
            status, body = client.call("POST", path, {"rows": full.tolist()})
            _check_answer(name, status, body, full, cpu_model.predict_proba(full), tolerance)
            checks += 1
    return single_ms, concurrent_ms, checks


def _latency_ms(single_ms: list, concurrent_ms: list) -> dict:
    return {
        "p50_single_row_ms": statistics.median(single_ms),
        "p99_single_row_ms": float(np.percentile(single_ms, 99)),
        "p50_concurrent_ms": statistics.median(concurrent_ms),
        "p99_concurrent_ms": float(np.percentile(concurrent_ms, 99)),
    }


def phase_serve(torch, card: str) -> dict:
    max_rows = serve_config.max_rows()
    rng = np.random.default_rng(7)
    single = bench_rows(rng, 16)
    full = bench_rows(rng, max_rows)
    with tempfile.TemporaryDirectory() as models_dir:
        tolerances = {}
        for name, gathered in synthetic_checkpoints(seed=0).items():
            write_checkpoint(gathered, checkpoint_path(models_dir, name))
            tolerances[name] = TREE_TOL if gathered[0] in ("tree_ensemble", "gbt") else LINEAR_TOL
        models = {
            name: (load_model(checkpoint_path(models_dir, name), device="cpu"), tolerance)
            for name, tolerance in tolerances.items()
        }
        plane = ServePlane()
        # the event loop (LO_WEB_ASYNC's default) serves the main path
        server = ServerThread(create_app(InMemoryStore(), models_dir=models_dir, serve=plane)).start()
        try:
            if server._loop is None:
                raise AssertionError("serve: ServerThread did not serve on the event loop")
            client = _Client(server.port)
            kernels.reset_launches()
            single_ms, concurrent_ms, checks = _serve_rounds(client, models, single, full)
            torch.cuda.synchronize()
            launches = kernels.launches()
            nan_rows = single[:2].tolist()
            nan_rows[1][3] = float("nan")
            refusals = (
                ("/models/missing/predict", {"rows": [single[0].tolist()]},
                 404, {"result": "file_not_found"}),
                ("/models/rf/predict", {"rows": nan_rows}, 406, {"result": "invalid_rows"}),
                ("/models/gb/predict", {"rows": bench_rows(rng, max_rows + 1).tolist()},
                 413, {"result": "too_many_rows"}),
            )
            for path, payload, status, answer in refusals:
                got = client.call("POST", path, payload)
                if got != (status, answer):
                    raise AssertionError(f"{path}: expected {status} {answer}, got {got}")
            stats = plane.stats()
        finally:
            server.stop()
        # the same singles and concurrent requests on the threaded server
        # (LO_WEB_ASYNC=0), then on the loop again: loop, threaded, loop
        servers = {"loop": [_latency_ms(single_ms, concurrent_ms)], "threaded": []}
        previous = os.environ.get("LO_WEB_ASYNC")
        try:
            for flag in ("0", "1"):
                os.environ["LO_WEB_ASYNC"] = flag
                again = ServerThread(create_app(InMemoryStore(), models_dir=models_dir, serve=plane)).start()
                try:
                    if (again._loop is None) != (flag == "0"):
                        raise AssertionError(f"serve: LO_WEB_ASYNC={flag} chose the other server")
                    times = _serve_rounds(_Client(again.port), models, single)
                finally:
                    again.stop()
                checks += times[2]
                servers["threaded" if flag == "0" else "loop"].append(_latency_ms(times[0], times[1]))
        finally:
            if previous is None:
                os.environ.pop("LO_WEB_ASYNC", None)
            else:
                os.environ["LO_WEB_ASYNC"] = previous
            plane.close()
    missing = [name for name in REPLACES if launches[name] == 0]
    if missing:
        raise AssertionError(f"the serve path never launched {missing}")
    record = {
        "phase": "serve",
        "models": sorted(tolerances),
        "answers_checked": checks,
        "launches": launches,
        "p50_single_row_ms": servers["loop"][0]["p50_single_row_ms"],
        "p99_single_row_ms": servers["loop"][0]["p99_single_row_ms"],
        "servers": servers,
        "mean_batch_size": stats["mean_batch_size"],
        "batches": stats["batches"],
        "registry": stats["registry"],
        "nvidia_smi": card,
    }
    emit(record)
    return record


# --------------------------------------------------------------------------
# The fit: kernels K1-K5 and the dt and gb fits
# --------------------------------------------------------------------------

def _fit_bound(
    name: str, rows: int, n_nodes: int, channels: int, bins_read: int = 0,
    trees: int = 1, subsets: bool = False, max_bins: int = MAX_BINS, x_bytes: int = 4,
) -> tuple[float, str]:
    """Least milliseconds the card could take for one call at these shapes:
    the bytes the function needs, each read once and each output written
    once, over HBM bandwidth, against the float32 operations it needs over
    the float32 peak. ``route`` needs one bin of each row whose node
    splits (``bins_read``, from this run's data), not the whole matrix. A
    forest's ``trees`` share the bins and each has its own nodes, channels
    and output; its split search reads each node's feature scores."""
    F, B, K, T = FEATURES, max_bins, channels, trees
    if name == "apply_bins":      # X (x_bytes a value), thresholds -> int8 bins; a 5-step search
        bytes_moved = rows * F * x_bytes + F * (B - 1) * 4 + rows * F
        ops = rows * F * int(np.ceil(np.log2(B)))
    elif name == "level_histograms":   # bins, node, channels -> histogram
        bytes_moved = rows * F + T * (rows * 4 + rows * K * 4 + n_nodes * F * B * K * 4)
        ops = T * rows * F * K
    elif name == "select_splits":  # histogram -> feature, bin; ~5 ops a channel
        bytes_moved = T * n_nodes * (F * B * K * 4 + 8 + (F * 4 if subsets else 0))
        ops = T * n_nodes * F * B * (5 * K + 5)
    elif name == "route":          # node, a bin per split row, split -> node
        bytes_moved = T * (rows * 4 * 2 + n_nodes * 8) + bins_read
        ops = T * rows * 2
    else:                          # leaf_sums: leaf, channels -> sums
        bytes_moved = T * (rows * 4 + rows * K * 4 + n_nodes * K * 4)
        ops = T * rows * K
    byte_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
    op_ms = ops / PEAK_FP32_OPS_PER_S * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def _fit_channels(torch, y_dev, seed: int) -> dict:
    """A fit's channels on the card: class one-hots (dt, gini) and the
    (g, h) pairs of a boosting round at seeded margins (gb, newton)."""
    rng = np.random.default_rng(seed)
    margins = torch.from_numpy(rng.normal(size=y_dev.shape[0]).astype(np.float32)).to(y_dev.device)
    p = torch.sigmoid(margins)
    g = p - y_dev.to(torch.float32)
    h = (p * (1 - p)).clamp(min=1e-6)
    one_hot = torch.nn.functional.one_hot(y_dev.long(), CLASSES).to(torch.float32)
    return {"gini": one_hot.contiguous(), "newton": torch.stack([g, h], dim=1)}


def _sums_error(name: str, mode: str, got, want) -> float:
    """Counts (dt) must be identical; gb sums agree within GB_SUM_RTOL of
    each cell. Returns the largest absolute difference."""
    if got.shape != want.shape or not bool(got.isfinite().all()):
        raise AssertionError(f"{name} ({mode}): bad output {tuple(got.shape)}")
    difference = (got - want).abs()
    if mode == "gini" and bool((difference > 0).any()):
        raise AssertionError(f"{name} (gini): class counts differ")
    relative = float((difference / want.abs().clamp(min=1e-30)).max())
    if relative > GB_SUM_RTOL:
        raise AssertionError(f"{name} ({mode}): relative difference {relative}")
    return float(difference.max())


def check_fit_kernels(torch, X_dev, y_dev, thresholds, seed: int = 5) -> dict:
    """Each fit kernel against its plain version on the same inputs, at
    every level of a depth-DEPTH tree grown by the plain versions, for dt
    and gb channels. Returns each kernel's largest difference and the
    inputs of each (mode, level) for timing."""
    errors = {name: 0.0 for name in FIT_REPLACES}
    # searchsorted(side="left") at its edges: NaN past every threshold (inf
    # ones too), +inf at the first inf threshold, -inf and -0.0 in bin 0
    edges = torch.tensor([[0.0, 1.0, 2.0, np.inf, np.inf]], device=X_dev.device)
    values = torch.tensor(
        [[np.nan], [np.inf], [-np.inf], [-0.0], [0.0], [2.0], [0.5], [3.0]], device=X_dev.device
    )
    expected = [5, 3, 0, 0, 0, 2, 1, 3]
    for apply in (binning.apply_bins, binning._apply_bins):
        if apply(values, edges)[:, 0].tolist() != expected:
            raise AssertionError(f"{apply.__name__}: edge values binned {apply(values, edges)[:, 0].tolist()}")
    bins = binning.apply_bins(X_dev, thresholds)
    if not torch.equal(bins, binning._apply_bins(X_dev, thresholds)):
        raise AssertionError("apply_bins: bins differ")
    cases = {}
    for mode, channels in _fit_channels(torch, y_dev, seed).items():
        node = torch.zeros(X_dev.shape[0], dtype=torch.int32, device=X_dev.device)
        # dt's one-hots are integer channels (K2's counts path), gb's (g, h)
        # are not (its sums path)
        integer = mode == "gini"
        for level in range(DEPTH):
            n_nodes = 2**level
            hist = trees.level_histograms(bins, node, channels, n_nodes, MAX_BINS, integer=integer)
            plain_hist = trees._level_histograms(bins, node, channels, n_nodes, MAX_BINS)
            errors["level_histograms"] = max(
                errors["level_histograms"], _sums_error("level_histograms", mode, hist, plain_hist)
            )
            if not torch.equal(
                trees.level_histograms(bins, node, channels, n_nodes, MAX_BINS, integer=integer), hist
            ):
                raise AssertionError(f"level_histograms ({mode}, level {level}): a second launch differs")
            if integer and not torch.equal(
                trees.level_histograms(bins, node, channels, n_nodes, MAX_BINS), hist
            ):
                raise AssertionError(f"level_histograms (level {level}): the sums path's counts differ")
            feature, bin_index = trees.select_splits(plain_hist, mode)
            plain_feature, plain_bin = trees._select_plain(plain_hist, mode)
            if not (torch.equal(feature, plain_feature) and torch.equal(bin_index, plain_bin)):
                raise AssertionError(f"select_splits ({mode}, level {level}): splits differ")
            routed = trees.route(bins, node, plain_feature, plain_bin)
            plain_routed = trees._route(bins, node, plain_feature, plain_bin)
            if not torch.equal(routed, plain_routed):
                raise AssertionError(f"route ({mode}, level {level}): nodes differ")
            # the one-tree calls of dt and gb are a forest of one, bit for bit
            split = trees.select_splits(plain_hist[None], mode)
            if not (
                torch.equal(trees.level_histograms(
                    bins, node[None], channels[None], n_nodes, MAX_BINS, integer=integer)[0], hist)
                and torch.equal(split[0][0], feature) and torch.equal(split[1][0], bin_index)
                and torch.equal(trees.route(bins, node[None], plain_feature[None], plain_bin[None])[0], routed)
            ):
                raise AssertionError(f"{mode}, level {level}: a tree axis of 1 changes the bits")
            cases[(mode, level)] = (node, channels, plain_hist, plain_feature, plain_bin)
            node = plain_routed
        sums = trees.leaf_sums(node, channels, 2**DEPTH)
        plain_sums = trees._leaf_sums(node, channels, 2**DEPTH)
        errors["leaf_sums"] = max(errors["leaf_sums"], _sums_error("leaf_sums", mode, sums, plain_sums))
        if not torch.equal(trees.leaf_sums(node[None], channels[None], 2**DEPTH)[0], sums):
            raise AssertionError(f"leaf_sums ({mode}): a tree axis of 1 changes the bits")
        if not torch.equal(trees.leaf_sums(node, channels, 2**DEPTH), sums):
            raise AssertionError(f"leaf_sums ({mode}): a second launch differs")
        if integer:
            # dt's call: the counts path, as exact as the sums path
            counted = trees.leaf_sums(node, channels, 2**DEPTH, integer=True)
            if not torch.equal(counted, plain_sums):
                raise AssertionError("leaf_sums (counts): class counts differ")
            if not torch.equal(trees.leaf_sums(node[None], channels[None], 2**DEPTH, integer=True)[0], counted):
                raise AssertionError("leaf_sums (counts): a tree axis of 1 changes the bits")
        cases[(mode, DEPTH)] = (node, channels, None, None, None)
    return {"errors": errors, "bins": bins, "cases": cases}


K1_EDGE_ROWS = 1001     # not a multiple of a tile, a word or a warp


def check_k1_edges(torch, X: np.ndarray, thresholds: np.ndarray) -> dict:
    """K1's bins torch.equal to the plain version's at its edges: NaN,
    +-inf, ties with a threshold and duplicate thresholds, an all-inf
    feature (an all-NaN column), 255 bins (int32), K1_EDGE_ROWS rows at 5
    and 17 features (no 16-byte words), a shared X against each job's
    thresholds at the main path's rows (8 jobs, one group) and at 113
    jobs (three groups), and the thresholds in windows of features and in
    a padded table in global memory (shares forced down)."""
    rng = np.random.default_rng(13)
    rows = K1_EDGE_ROWS
    edge = X[:rows].copy()
    edge[:, 2] = np.nan                                   # an all-NaN feature
    edge[rng.random(edge.shape) < 0.02] = np.nan
    edge[:6, 0] = [np.inf, -np.inf, -0.0, np.nan, thresholds[0, 0], thresholds[0, -1]]
    edge_thresholds = thresholds.copy()
    edge_thresholds[2] = np.inf                           # the all-NaN feature's
    edge_thresholds[5, 10:14] = edge_thresholds[5, 10]    # duplicates
    edge[6:9, 5] = edge_thresholds[5, 10]                 # ties with the duplicates
    X_full = torch.from_numpy(X).cuda()

    def held(name, X_dev, thresholds_dev):
        if thresholds_dev.dim() == 3:
            got, want = binning.job_apply_bins(X_dev, thresholds_dev), binning._job_apply_bins(X_dev, thresholds_dev)
        else:
            got, want = binning.apply_bins(X_dev, thresholds_dev), binning._apply_bins(X_dev, thresholds_dev)
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise AssertionError(f"apply_bins ({name}): bins differ from the plain version")
        return got

    cases = {}
    X_edge, th_edge = torch.from_numpy(edge).cuda(), torch.from_numpy(edge_thresholds).cuda()
    held("edges", X_edge, th_edge)
    th255 = torch.from_numpy(binning.make_thresholds(X[:200_000], 255).astype(np.float32)).cuda()
    cases["int32_255_bins"] = str(held("255 bins", X_full, th255).dtype)
    for features in (5, 17):
        wide = np.ascontiguousarray(np.concatenate([edge, edge[:, ::-1]], axis=1)[:, :features])
        th = np.concatenate([edge_thresholds, edge_thresholds[::-1]])[:features]
        held(f"{features} features", torch.from_numpy(wide).cuda(), torch.from_numpy(np.ascontiguousarray(th)).cuda())
    jobs = {}
    for count in (JOB_CHECK_JOBS, 113):
        stacked = torch.stack([th_edge * (1.0 + 1e-3 * j) for j in range(count)]).contiguous()
        X_jobs = X_full if count == JOB_CHECK_JOBS else X_full[:100_000]
        got = held(f"shared X, {count} jobs", X_jobs, stacked)
        for j in (0, count - 1):
            if not torch.equal(got[j], binning.job_apply_bins(X_jobs, stacked[j:j + 1])[0]):
                raise AssertionError(f"apply_bins (shared X, {count} jobs): job {j} differs alone")
        jobs[count] = binning._k1_geometry(FEATURES, MAX_BINS - 1, count, True, 1)._asdict()
    cases["shared_x_jobs"] = jobs
    forced = {}
    saved = binning._BIN_SHARE
    try:
        for share in (1024, 64):   # windows of 8 features; a padded table in global memory
            binning._BIN_SHARE = share
            held(f"share {share}", X_edge, th_edge)
            held(f"share {share}, 255 bins", X_full[:rows], th255)
            held(f"share {share}, jobs", X_edge, torch.stack([th_edge, th_edge * 1.001]).contiguous())
            forced[share] = binning._k1_geometry(FEATURES, MAX_BINS - 1, 1, True, 1, share)._asdict()
    finally:
        binning._BIN_SHARE = saved
    cases["forced"] = forced
    return cases


def _k3_hist(torch, nodes: int, max_bins: int, channels: int, rows: int, seed: int):
    """A level's class counts on the card: ``rows`` rows spread at random
    over ``nodes`` nodes, each feature's bins and ``channels`` classes."""
    rng = np.random.default_rng(seed)
    lam = rows / (nodes * max_bins * channels)
    return torch.from_numpy(rng.poisson(lam, (nodes, FEATURES, max_bins, channels)).astype(np.float32)).cuda()


def check_k3_edges(torch) -> dict:
    """K3's splits equal to the plain version's at its edges: a NaN gain
    (newton: the first NaN wins and its node is a leaf), exact ties
    between features, an empty node (a leaf at bin 0), newton at 255
    bins, 2,048 nodes of 10 classes, and 16 features x 255 bins x 10
    classes in one window of shared memory, in windows of features and in
    global scratch (shares forced down)."""
    rng = np.random.default_rng(14)
    gini = _k3_hist(torch, 16, MAX_BINS, CLASSES, FIT_ROWS // 16, 1)
    gini[3] = 0.0                                       # no rows
    gini[5, 9] = gini[5, 2]                             # feature 9 ties feature 2
    newton = torch.from_numpy(rng.random((16, FEATURES, MAX_BINS, 2), dtype=np.float32)).cuda()
    newton[..., 0] -= 0.5
    newton[3] = 0.0
    newton[7, 4, 6, 0] = float("nan")
    newton[7, 9, 2, 0] = float("nan")
    newton255 = torch.from_numpy(rng.random((16, FEATURES, 255, 2), dtype=np.float32)).cuda()
    newton255[..., 0] -= 0.5
    cases = {
        "nan_ties_empty": (gini, "gini"), "nan_gain": (newton, "newton"), "newton_255_bins": (newton255, "newton"),
        "2048_nodes_10_classes": (_k3_hist(torch, 2048, MAX_BINS, DEEP_CLASSES, FIT_ROWS, 2), "gini"),
        "255_bins_10_classes": (_k3_hist(torch, 16, 255, DEEP_CLASSES, FIT_ROWS, 3), "gini"),
    }
    outcomes = {}

    def held(name, hist, mode):
        got, want = trees.select_splits(hist, mode), trees._select_plain(hist, mode)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"select_splits ({name}): splits differ from the plain version")
        return got

    for name, (hist, mode) in cases.items():
        feature, bin_index = held(name, hist, mode)
        outcomes[name] = {"nodes": int(feature.numel()), "leaf_nodes": int((feature < 0).sum()),
                          "geometry": trees._k3_geometry(*hist.shape[-3:])._asdict()}
    feature, bin_index = held("empty", gini, "gini")
    if (int(feature[3]), int(bin_index[3])) != (-1, 0) or int(feature[5]) == 9:
        raise AssertionError("select_splits: the empty node is not a leaf at bin 0, or a tie went to the later feature")
    if int(held("nan", newton, "newton")[0][7]) != -1:
        raise AssertionError("select_splits: a NaN gain did not make its node a leaf")
    saved = trees._SPLIT_SHARE
    try:
        for share in (65_536, 4_096):   # windows of 6 features; the stage in global scratch
            trees._SPLIT_SHARE = share
            for name in ("255_bins_10_classes", "newton_255_bins"):
                held(f"{name}, share {share}", *cases[name])
            outcomes[f"255_bins_10_classes:share_{share}"] = trees._k3_geometry(16, 255, DEEP_CLASSES, share)._asdict()
    finally:
        trees._SPLIT_SHARE = saved
    return {"outcomes": outcomes, "cases": cases}


class _ReadFlush:
    """A flush that evicts L2 by reading a buffer past its size, in place
    of overwriting one (``zero_`` is the name the timing helpers call):
    the next call finds none of its inputs in L2, and no dirty lines for
    its own reads to write back first."""

    def __init__(self, torch, device):
        self.buffer = torch.ones(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=device)

    def zero_(self):
        self.buffer.sum()


def _launch_floor_ms(torch, flush) -> float:
    """Milliseconds of one launch of an empty kernel (tree_fit.cu
    ``lo_empty``) through ctypes, cold, on the same clock as the kernels:
    the card's launch floor."""
    lib = kernels.library("tree_fit")
    index = torch.cuda.current_device()
    return _event_ms(torch, lambda: lib.lo_empty(index, torch.cuda.current_stream().cuda_stream), 20, flush)


def _card_draws(torch, rows: int, seed: int, device):
    """A forest's draws on the card, as the rf estimator makes them."""
    generator = torch.Generator(device=device).manual_seed(seed)
    return trees._forest_draws(TREES, rows, DEPTH, FEATURES, generator, device)


def check_forest_kernels(torch, bins, y_dev, seed: int = 6) -> dict:
    """K2, K4 and K5 over a forest's tree axis and K3 with its feature
    subsets against their plain versions, at every level of a depth-DEPTH
    forest of TREES trees grown by the plain versions from seeded draws:
    counts, splits and routes identical. A tree's histogram in the forest
    launch equals the launch of that tree alone, bit for bit. Then K3 on
    tied scores, on a node whose every allowed gain is -inf and with a NaN
    outside the subset, and K2 at a windowed level of the forest. Returns
    each kernel's largest difference and the inputs of each level for
    timing."""
    errors = {name: 0.0 for name in FOREST_KERNELS}
    rows = bins.shape[0]
    draws = _card_draws(torch, rows, seed, bins.device)
    one_hot = torch.nn.functional.one_hot(y_dev.long(), CLASSES).to(torch.float32)
    channels = (one_hot[None] * draws.bootstrap[:, :, None]).contiguous()
    node = torch.zeros((TREES, rows), dtype=torch.int32, device=bins.device)
    cases = {}
    for level in range(DEPTH):
        n_nodes = 2**level
        hist = trees.level_histograms(bins, node, channels, n_nodes, MAX_BINS, integer=True)
        plain_hist = trees._level_histograms(bins, node, channels, n_nodes, MAX_BINS)
        errors["level_histograms"] = max(
            errors["level_histograms"], _sums_error("level_histograms (forest)", "gini", hist, plain_hist)
        )
        for tree in (0, TREES - 1):
            alone = trees.level_histograms(bins, node[tree], channels[tree], n_nodes, MAX_BINS, integer=True)
            if not torch.equal(alone, hist[tree]):
                raise AssertionError(f"level_histograms (forest, level {level}): tree {tree} differs alone")
        scores = draws.subset_scores[:, n_nodes - 1 : 2 * n_nodes - 1]
        feature, bin_index = trees.select_splits(plain_hist, "gini", scores, SUBSET_K)
        plain_feature, plain_bin = trees._select_plain(plain_hist, "gini", scores, SUBSET_K)
        if not (torch.equal(feature, plain_feature) and torch.equal(bin_index, plain_bin)):
            raise AssertionError(f"select_splits (forest, level {level}): splits differ")
        routed = trees.route(bins, node, plain_feature, plain_bin)
        plain_routed = trees._route(bins, node, plain_feature, plain_bin)
        if not torch.equal(routed, plain_routed):
            raise AssertionError(f"route (forest, level {level}): nodes differ")
        for tree in (0, TREES - 1):
            if not torch.equal(trees.route(bins, node[tree], plain_feature[tree], plain_bin[tree]), routed[tree]):
                raise AssertionError(f"route (forest, level {level}): tree {tree} differs alone")
        cases[level] = (node, channels, plain_hist, scores, plain_feature, plain_bin)
        node = plain_routed
    sums = trees.leaf_sums(node, channels, 2**DEPTH)
    plain_sums = trees._leaf_sums(node, channels, 2**DEPTH)
    errors["leaf_sums"] = _sums_error("leaf_sums (forest)", "gini", sums, plain_sums)
    # the forest's call: the counts path
    counted = trees.leaf_sums(node, channels, 2**DEPTH, integer=True)
    if not torch.equal(counted, plain_sums):
        raise AssertionError("leaf_sums (forest, counts): class counts differ")
    for tree in (0, TREES - 1):
        if not (
            torch.equal(trees.leaf_sums(node[tree], channels[tree], 2**DEPTH, integer=True), counted[tree])
            and torch.equal(trees.leaf_sums(node[tree], channels[tree], 2**DEPTH), sums[tree])
        ):
            raise AssertionError(f"leaf_sums (forest): tree {tree} differs alone")
    cases[DEPTH] = (node, channels, None, None, None, None)
    special = _check_subset_edges(torch, cases[DEPTH - 1][2], cases[DEPTH - 1][3])
    wide = _check_wide_forest_level(torch, bins[:WIDE_FOREST_ROWS])
    errors["level_histograms"] = max(errors["level_histograms"], wide.pop("max_abs_err"))
    return {"errors": errors, "cases": cases, "subset_edges": special, "wide_level": wide}


def _check_subset_edges(torch, hist, scores) -> dict:
    """K3 against its plain version on a forest level's histogram where
    the plain version's sort meets ties (scores in steps of 1/8), where
    tree 0's node 0 has no rows in its allowed features (every allowed
    gain -inf: a leaf at bin 0), and under newton with a NaN in a feature
    outside node 0's subset (-inf there, so no NaN wins)."""
    tied = (scores * 8).floor() / 8
    kth = torch.sort(tied, dim=-1).values[..., SUBSET_K - 1 : SUBSET_K]
    allowed = tied <= kth
    empty = hist.clone()
    empty[0, 0][allowed[0, 0]] = 0.0
    rng = np.random.default_rng(4)
    newton = torch.from_numpy(rng.random(tuple(hist.shape[:-1]) + (2,), dtype=np.float32)).to(hist.device)
    newton[..., 0] -= 0.5
    outside = int(torch.nonzero(~allowed[0, 0])[0, 0])
    newton[0, 0, outside, 3, 0] = float("nan")
    outcomes = {}
    for name, values, mode in (("ties", hist, "gini"), ("empty_node", empty, "gini"), ("nan_outside", newton, "newton")):
        got = trees.select_splits(values, mode, tied, SUBSET_K)
        want = trees._select_plain(values, mode, tied, SUBSET_K)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"select_splits (forest, {name}): splits differ")
        outcomes[name] = {"leaf_nodes": int((got[0] < 0).sum()), "nodes": int(got[0].numel())}
    empty_split = trees.select_splits(empty, "gini", tied, SUBSET_K)
    if (int(empty_split[0][0, 0]), int(empty_split[1][0, 0])) != (-1, 0):
        raise AssertionError("select_splits (forest, empty_node): not a leaf at bin 0")
    ties = int((tied[..., None, :] == tied[..., :, None]).sum() - tied.numel())
    return {"tied_score_pairs": ties, **outcomes}


def _check_wide_forest_level(torch, bins) -> dict:
    """K2 over the forest's trees at a 2,048-node level of 10 classes
    (windows of nodes past one block's shared memory), counts identical
    to the plain version; one cold call timed."""
    rows, deep = bins.shape[0], 2 ** (DEEP_DEPTH - 1)
    rng = np.random.default_rng(12)
    node = torch.from_numpy(rng.integers(0, deep, (TREES, rows)).astype(np.int32)).to(bins.device)
    bootstrap = torch.from_numpy(rng.poisson(1.0, (TREES, rows)).astype(np.float32)).to(bins.device)
    labels = torch.from_numpy(rng.integers(0, DEEP_CLASSES, rows)).to(bins.device)
    one_hot = torch.nn.functional.one_hot(labels, DEEP_CLASSES).to(torch.float32)
    channels = (one_hot[None] * bootstrap[:, :, None]).contiguous()
    hist = trees.level_histograms(bins, node, channels, deep, MAX_BINS, integer=True)
    plain = trees._level_histograms(bins, node, channels, deep, MAX_BINS)
    error = _sums_error("level_histograms (forest, 2,048 nodes)", "gini", hist, plain)
    for tree in (0, TREES - 1):
        alone = trees.level_histograms(bins, node[tree], channels[tree], deep, MAX_BINS, integer=True)
        if not torch.equal(alone, hist[tree]):
            raise AssertionError(f"level_histograms (forest, 2,048 nodes): tree {tree} differs alone")
    del hist, plain
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=bins.device)
    return {
        "rows": rows, "trees": TREES, "nodes": deep, "channels": DEEP_CLASSES,
        "path": _histogram_path(rows, deep, DEEP_CLASSES, True), "max_abs_err": error,
        "ms": _event_ms(
            torch, lambda: trees.level_histograms(bins, node, channels, deep, MAX_BINS, integer=True), 2, flush
        ),
    }


def _histogram_path(rows: int, n_nodes: int, channels: int, integer: bool, max_bins: int = MAX_BINS,
                    bin_bytes: int = 1) -> dict:
    """How K2 covers a level of this shape: the counts path's chunks and
    whether it counts in shared memory, or the sums path's chunks and its
    windows of nodes, feature blocks and passes."""
    if integer:
        tiling = trees._count_tiling(rows, FEATURES, n_nodes, max_bins, channels, bin_bytes)
        return {"path": "counts", "chunks": tiling.chunks, "in_shared": tiling.in_shared,
                "block_features": tiling.block_features}
    tiling = trees._block_features(FEATURES, n_nodes, max_bins, channels, bin_bytes)
    return {
        "path": "sums", "chunks": trees._sum_chunks(rows, n_nodes, max_bins)[0],
        "node_windows": -(-n_nodes // tiling.nodes), "feature_blocks": -(-FEATURES // tiling.block_features),
        "passes": -(-max_bins // tiling.bins) * -(-channels // tiling.channels),
    }


def ten_classes(X: np.ndarray, seed: int = 3) -> np.ndarray:
    """Ten roughly balanced classes of bench.py's rows: deciles of the
    same noisy score that makes its two classes."""
    rng = np.random.default_rng(seed)
    score = X[:, 0] + X[:, 1] * 0.5 + rng.random(X.shape[0], dtype=np.float32) * 8
    return np.digitize(score, np.quantile(score, np.linspace(0.1, 0.9, 9))).astype(np.int32)


def check_repairs(torch, X: np.ndarray, y: np.ndarray) -> dict:
    """The kernels at the shapes past their former limits, against their
    plain versions on the same inputs: int32 bins (255 bins), a 2,048-node
    level and 4,096 leaves (windows of shared memory), and forests whose
    heaps do not fit a block together (20 trees of depth 10) or at all (a
    depth-12 tree of 20 classes)."""
    record = {}
    X_dev = torch.from_numpy(X).cuda()
    y10 = torch.from_numpy(ten_classes(X).astype(np.int64)).cuda()
    # R1: 255 bins, int32
    thresholds = torch.from_numpy(binning.make_thresholds(X, 255).astype(np.float32)).cuda()
    bins = binning.apply_bins(X_dev, thresholds)
    if bins.dtype != torch.int32 or not torch.equal(bins, binning._apply_bins(X_dev, thresholds)):
        raise AssertionError("apply_bins at 255 bins: bins differ (or are not int32)")
    channels = _fit_channels(torch, y10 % 2, seed=8)
    channels["gini"] = torch.nn.functional.one_hot(y10, DEEP_CLASSES).to(torch.float32)
    node = torch.zeros(X.shape[0], dtype=torch.int32, device=X_dev.device)
    errors = {"level_histograms": 0.0, "leaf_sums": 0.0}
    for level in range(4):
        plain = {}
        for mode, values in channels.items():
            hist = trees.level_histograms(bins, node, values, 2**level, 255, integer=mode == "gini")
            plain[mode] = trees._level_histograms(bins, node, values, 2**level, 255)
            errors["level_histograms"] = max(
                errors["level_histograms"],
                _sums_error("level_histograms (255 bins)", mode, hist, plain[mode]),
            )
        feature, bin_index = trees._select_plain(plain["newton"], "newton")
        routed = trees.route(bins, node, feature, bin_index)
        if not torch.equal(routed, trees._route(bins, node, feature, bin_index)):
            raise AssertionError(f"route at 255 bins, level {level}: nodes differ")
        node = routed
    # int32 bins through the tree-group route: 20 trees over one matrix
    # (a row's 16 int32 bins as four 16-byte words, read once a group)
    rng = np.random.default_rng(10)
    forest_node = torch.from_numpy(rng.integers(0, 16, (TREES, X.shape[0])).astype(np.int32)).cuda()
    forest_feature = torch.from_numpy(rng.integers(-1, FEATURES, (TREES, 16)).astype(np.int32)).cuda()
    forest_bin = torch.from_numpy(rng.integers(0, 255, (TREES, 16)).astype(np.int32)).cuda()
    routed = trees.route(bins, forest_node, forest_feature, forest_bin)
    if not torch.equal(routed, trees._route(bins, forest_node, forest_feature, forest_bin)):
        raise AssertionError("route at 255 bins, 20 trees: nodes differ")
    for tree in (0, TREES - 1):
        if not torch.equal(trees.route(bins, forest_node[tree], forest_feature[tree], forest_bin[tree]), routed[tree]):
            raise AssertionError(f"route at 255 bins: tree {tree} differs alone")
    del forest_node, routed
    record["bins_255"] = {
        "int32": True, "levels": 4, "max_abs_err": errors["level_histograms"],
        "forest_route": trees._route_geometry(TREES, 16, True)._asdict(),
    }
    # R2: a depth-12 level and 4,096 leaves
    bins = binning.apply_bins(X_dev, torch.from_numpy(binning.make_thresholds(X).astype(np.float32)).cuda())
    rng = np.random.default_rng(9)
    deep = 2 ** (DEEP_DEPTH - 1)
    node = torch.from_numpy(rng.integers(0, deep, X.shape[0]).astype(np.int32)).cuda()
    leaf = torch.from_numpy(rng.integers(0, 2 * deep, X.shape[0]).astype(np.int32)).cuda()
    timings = {}
    for mode, values in channels.items():
        K, integer = values.shape[1], mode == "gini"
        hist = trees.level_histograms(bins, node, values, deep, MAX_BINS, integer=integer)
        plain = trees._level_histograms(bins, node, values, deep, MAX_BINS)
        errors["level_histograms"] = max(
            errors["level_histograms"], _sums_error("level_histograms (2,048 nodes)", mode, hist, plain)
        )
        timings[f"level_histograms:{deep}x{K}"] = {
            "ms": _event_ms(
                torch, lambda: trees.level_histograms(bins, node, values, deep, MAX_BINS, integer=integer), 3
            ),
            **_histogram_path(X.shape[0], deep, K, integer),
        }
    sums = trees.leaf_sums(leaf, channels["gini"], 2 * deep)
    plain = trees._leaf_sums(leaf, channels["gini"], 2 * deep)
    errors["leaf_sums"] = _sums_error("leaf_sums (4,096 leaves)", "gini", sums, plain)
    timings[f"leaf_sums:{2 * deep}x{DEEP_CLASSES}"] = {
        "ms": _event_ms(torch, lambda: trees.leaf_sums(leaf, channels["gini"], 2 * deep), 3),
        "windows": len(trees._windows(2 * deep, trees._leaf_warps(2 * deep, DEEP_CLASSES).leaves)),
    }
    # the deep dt's call: the counts path (in global memory: 160 KB of
    # counts a block would leave 16 chunks)
    counted = trees.leaf_sums(leaf, channels["gini"], 2 * deep, integer=True)
    if not torch.equal(counted, plain):
        raise AssertionError("leaf_sums (4,096 leaves, counts): class counts differ")
    timings[f"leaf_sums:{2 * deep}x{DEEP_CLASSES}:counts"] = {
        "ms": _event_ms(torch, lambda: trees.leaf_sums(leaf, channels["gini"], 2 * deep, integer=True), 3),
        **trees._leaf_count_tiling(X.shape[0], 2 * deep, DEEP_CLASSES)._asdict(),
    }
    del counted
    # K4 at a 2,048-node level of 20 trees: the group's splits pass a
    # block's share (windows of trees), and, with the share cut to 64
    # bytes, every tree's splits read from global memory
    deep_node = torch.from_numpy(rng.integers(0, deep, (TREES, X.shape[0])).astype(np.int32)).cuda()
    deep_feature = torch.from_numpy(rng.integers(-1, FEATURES, (TREES, deep)).astype(np.int32)).cuda()
    deep_bin = torch.from_numpy(rng.integers(0, MAX_BINS, (TREES, deep)).astype(np.int32)).cuda()
    saved = trees._ROUTE_SHARE
    try:
        for share in (saved, 64):
            trees._ROUTE_SHARE = share
            routed = trees.route(bins, deep_node, deep_feature, deep_bin)
            if not torch.equal(routed, trees._route(bins, deep_node, deep_feature, deep_bin)):
                raise AssertionError(f"route (20 trees x {deep} nodes, share {share}): nodes differ")
            for tree in (0, TREES - 1):
                if not torch.equal(trees.route(bins, deep_node[tree], deep_feature[tree], deep_bin[tree]), routed[tree]):
                    raise AssertionError(f"route (20 trees x {deep} nodes, share {share}): tree {tree} differs alone")
            timings[f"route:{TREES}x{deep}:share_{share}"] = {
                "ms": _event_ms(torch, lambda: trees.route(bins, deep_node, deep_feature, deep_bin), 3),
                **trees._route_geometry(TREES, deep, True)._asdict(),
            }
    finally:
        trees._ROUTE_SHARE = saved
    del deep_node, routed
    record["wide_levels"] = {"max_abs_err": errors, "timings": timings}
    # R3: forests past a block's shared memory, bit-equal to the plain forward
    forests = {}
    for count, depth, classes in ((TREES, 10, CLASSES), (1, DEEP_DEPTH, 20)):
        fh, th, lp, lv = _forest(torch, X, count, depth, classes, seed=count + depth)
        calls = {
            "tree_ensemble_forward": (
                lambda: trees.ensemble_forward(X_dev, fh, th, lp, depth),
                lambda: trees._ensemble_forward(X_dev, fh, th, lp, depth),
            ),
            "gbt_forward": (
                lambda: trees.gbt_forward(X_dev, -0.2, fh, th, lv, STEP, depth),
                lambda: trees._gbt_forward(X_dev, -0.2, fh, th, lv, STEP, depth),
            ),
        }
        for name, (kernel, plain) in calls.items():
            if not torch.equal(kernel(), plain()):
                raise AssertionError(f"{name} at {count} trees of depth {depth}: not bit-equal")
            forests[f"{name}:{count}x{depth}x{classes}"] = {
                "ms": _event_ms(torch, kernel, 3),
                "geometry": trees._forward_geometry(
                    X.shape[0], FEATURES, count, depth, classes if name == "tree_ensemble_forward" else 1
                )._asdict(),
            }
    record["forests"] = {"bit_equal": True, "timings": forests}
    return record


def _forest(torch, X, count, depth, classes, seed):
    """Heaps of ``count`` trees of ``depth`` on ``X``'s features, as a fit
    writes them, and their leaf parameters, on the card."""
    rng = np.random.default_rng(seed)
    thresholds = binning.make_thresholds(X[:4096]).astype(np.float32)
    features_heap, thresholds_heap = _heaps(rng, thresholds, count, depth, leaf_rate=0.02)
    leaves = 2**depth
    leaf_probs = rng.dirichlet(np.ones(classes), size=(count, leaves)).astype(np.float32)
    leaf_values = rng.normal(size=(count, leaves)).astype(np.float32)
    return tuple(
        torch.from_numpy(array).cuda()
        for array in (features_heap, thresholds_heap, leaf_probs, leaf_values)
    )


def _k7_bound(
    rows: int, features: int, classes: int, trial: bool, x_bytes: int = 4, weighted: bool = False,
) -> tuple[float, str]:
    """Least milliseconds for one K7 call: X (``x_bytes`` a value), y and,
    ``weighted``, the row weights
    read once (the parameters and outputs are bytes beside them) over HBM bandwidth,
    against its operations at their type's peak: per row and candidate
    2FC float32 for the logits and ~4C for the softmax, and for the
    gradient 2FC + 2C float64."""
    F, C = features, classes
    candidates = 4 if trial else 1
    params = candidates * (F * C + C) * 4
    bytes_moved = rows * F * x_bytes + rows * 4 + params + (candidates if trial else F * C + C + 1) * 4
    bytes_moved += rows * 4 if weighted else 0
    fp32_ops = rows * candidates * (2 * F * C + 4 * C)
    fp64_ops = 0 if trial else rows * (2 * F * C + 2 * C + 1)
    byte_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
    op_ms = (fp32_ops / PEAK_FP32_OPS_PER_S + fp64_ops / PEAK_FP64_OPS_PER_S) * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def check_logistic_kernels(torch, X: np.ndarray, y: np.ndarray, flush) -> dict:
    """K7's two entry points against the plain twin at the fit's shape:
    bench.py's rows standardized by scaler_stats, 2 and 10 classes, at a
    seeded mid-fit point, reg 0 and 0.1. Times at reg 0: cold (L2
    overwritten before each call) and warm (back to back)."""
    mean, scale = logistic.scaler_stats(X)
    X_dev = torch.from_numpy(logistic._standardized(X, mean, scale)).cuda()
    rows = X.shape[0]
    results = {name: {"max_abs_err": 0.0, "by_classes": {}} for name in LOGISTIC_REPLACES}
    for classes, labels in ((CLASSES, y), (DEEP_CLASSES, ten_classes(X))):
        rng = np.random.default_rng(classes)
        y_dev = torch.from_numpy(labels.astype(np.int32)).cuda()

        def cuda(*shape, scale_by=0.3):
            return torch.from_numpy((rng.normal(size=shape) * scale_by).astype(np.float32)).cuda()

        W, b, D, d = cuda(FEATURES, classes), cuda(classes), cuda(FEATURES, classes), cuda(classes)
        steps = torch.tensor([1.0, 0.5, 0.25, 0.125], device=X_dev.device)
        W4 = (W[None] + steps[:, None, None] * D[None]).contiguous()
        b4 = (b[None] + steps[:, None] * d[None]).contiguous()
        for l2 in (0.0, 0.1):
            got = logistic.loss_and_grad(W, b, X_dev, y_dev, l2)
            want = logistic._loss_fn(W, b, X_dev, y_dev, l2)
            again = logistic.loss_and_grad(W, b, X_dev, y_dev, l2)
            if not all(torch.equal(a, c) for a, c in zip(got, again)):
                raise AssertionError(f"logistic_loss_grad ({classes} classes): a second launch differs")
            loss_rel = abs(float(got[0]) - float(want[0])) / abs(float(want[0]))
            grad_err = max(float((got[i] - want[i]).abs().max()) for i in (1, 2))
            if not loss_rel <= K7_LOSS_RTOL or not grad_err <= K7_GRAD_ATOL:
                raise AssertionError(
                    f"logistic_loss_grad ({classes} classes, l2 {l2}): loss {loss_rel} "
                    f"relative, gradient {grad_err}"
                )
            trial = logistic.trial_losses(W4, b4, X_dev, y_dev, l2)
            plain_trial = logistic._trial_losses(W4, b4, X_dev, y_dev, l2)
            if not torch.equal(trial, logistic.trial_losses(W4, b4, X_dev, y_dev, l2)):
                raise AssertionError(f"logistic_trial_losses ({classes} classes): a second launch differs")
            trial_rel = float(((trial - plain_trial).abs() / plain_trial.abs()).max())
            if not trial_rel <= K7_LOSS_RTOL:
                raise AssertionError(f"logistic_trial_losses ({classes} classes, l2 {l2}): {trial_rel} relative")
            results["logistic_loss_grad"]["max_abs_err"] = max(
                results["logistic_loss_grad"]["max_abs_err"],
                grad_err, abs(float(got[0]) - float(want[0])),
            )
            results["logistic_trial_losses"]["max_abs_err"] = max(
                results["logistic_trial_losses"]["max_abs_err"], float((trial - plain_trial).abs().max())
            )
        calls = {
            "logistic_loss_grad": (
                lambda: logistic.loss_and_grad(W, b, X_dev, y_dev, 0.0),
                lambda: logistic._loss_fn(W, b, X_dev, y_dev, 0.0),
            ),
            "logistic_trial_losses": (
                lambda: logistic.trial_losses(W4, b4, X_dev, y_dev, 0.0),
                lambda: logistic._trial_losses(W4, b4, X_dev, y_dev, 0.0),
            ),
        }
        for name, (kernel, plain) in calls.items():
            bound_ms, bound_by = _k7_bound(rows, FEATURES, classes, name == "logistic_trial_losses")
            results[name]["by_classes"][classes] = {
                "ms": _event_ms(torch, kernel, 20, flush),
                "warm_ms": _event_ms(torch, kernel, 50),
                "device_ms": _device_ms(torch, kernel, DEVICE_KERNELS[name], 20, flush),
                "plain_ms": _event_ms(torch, plain, 3, flush),
                # no single PyTorch call computes the mean nll with its
                # gradient, or at four parameter sets
                "library_ms": None,
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "geometry": logistic._k7_geometry(
                    FEATURES, classes, 1, False, trial=name == "logistic_trial_losses"),
            }
    for result in results.values():
        # the main path's shape: bench.py's two classes
        result.update(result["by_classes"][CLASSES])
    return results


def _same_bits(got, want) -> bool:
    """Tensors equal, NaN where NaN."""
    return all(
        bool((a.isnan() == c.isnan()).all()) and bool((a.nan_to_num() == c.nan_to_num()).all())
        for a, c in zip(got, want)
    )


def check_k7_empty(torch) -> dict:
    """K7 where the reference's gradient is no quotient of sums. No rows:
    the loss is NaN and the data term's gradient 0 (``jax.grad`` of the
    reference's mean contracts over no rows, which is 0 before any
    division), so dW is the L2 term's l2 W and db 0: solo, and a group of
    three jobs that share their (no) rows. Rows whose weights are all 0:
    loss and gradient NaN, as the reference's: job 1 of one launch of three
    jobs with rows, the others bit-equal to their launches alone and
    within K7_LOSS_RTOL and K7_GRAD_ATOL of the plain twin. The no-row
    cases held against the plain twin bit for bit, NaN where NaN."""
    device = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(11)

    def cuda(array):
        return torch.from_numpy(np.ascontiguousarray(array)).to(device)

    W = cuda((rng.normal(size=(3, FEATURES, CLASSES)) * 0.3).astype(np.float32))
    b = cuda((rng.normal(size=(3, CLASSES)) * 0.3).astype(np.float32))
    l2s = cuda(np.array([0.0, 0.1, 0.5], np.float32))
    X0 = torch.empty((0, FEATURES), dtype=torch.float32, device=device)
    y0 = torch.empty((0,), dtype=torch.int32, device=device)
    record = {}
    solo = logistic.loss_and_grad(W[1], b[1], X0, y0, 0.1)
    jobs = logistic.job_loss_and_grad(W, b, X0, y0, None, l2s)
    torch.cuda.synchronize()
    if not (
        _same_bits(solo, logistic._loss_fn(W[1], b[1], X0, y0, 0.1))
        and _same_bits(jobs, logistic._job_loss_fn(W, b, X0, y0, None, l2s))
    ):
        raise AssertionError("logistic_loss_grad (no rows): the kernel differs from the plain twin")
    if not (
        bool(solo[0].isnan()) and torch.equal(solo[1], 0.1 * W[1]) and bool((solo[2] == 0).all())
        and bool(jobs[0].isnan().all()) and torch.equal(jobs[1], l2s[:, None, None] * W)
        and bool((jobs[2] == 0).all())
    ):
        raise AssertionError("logistic_loss_grad (no rows): not a NaN loss and the L2 term's gradient")
    record["no_rows"] = {"solo": True, "group_of_3": True, "geometry": logistic._k7_geometry(
        FEATURES, CLASSES, 3, True)}
    rows = K7_WIDE_ROWS
    X = cuda(rng.normal(size=(rows, FEATURES)).astype(np.float32))
    y = cuda(rng.integers(0, CLASSES, size=(3, rows)).astype(np.int32))
    weights = cuda(np.stack([np.ones(rows, np.float32), np.zeros(rows, np.float32),
                             (rng.random(rows) < 0.8).astype(np.float32)]))
    got = logistic.job_loss_and_grad(W, b, X, y, weights, l2s)
    want = logistic._job_loss_fn(W, b, X, y, weights, l2s)
    if not (all(bool(part[1].isnan().all()) for part in (*got, *want))
            and all(bool(part[j].isfinite().all()) for part in (*got, *want) for j in (0, 2))):
        raise AssertionError("logistic_loss_grad (zero weights): job 1 is not NaN, or another job is")
    live = torch.tensor([0, 2], device=device)
    loss_rel = float(((got[0][live] - want[0][live]).abs() / want[0][live].abs()).max())
    grad_err = max(float((got[i][live] - want[i][live]).abs().max()) for i in (1, 2))
    if not loss_rel <= K7_LOSS_RTOL or not grad_err <= K7_GRAD_ATOL:
        raise AssertionError(
            f"logistic_loss_grad (zero weights): loss {loss_rel} relative, gradient {grad_err}")
    for j in (0, 2):
        alone = logistic.job_loss_and_grad(
            W[j:j + 1], b[j:j + 1], X, y[j:j + 1], weights[j:j + 1], l2s[j:j + 1])
        if not all(torch.equal(part[j], one[0]) for part, one in zip(got, alone)):
            raise AssertionError(f"logistic_loss_grad (zero weights): job {j} differs alone")
    record["zero_weights"] = {"jobs": 3, "nan_job": 1, "others_bit_equal_alone": True}
    return record


# K7 past the sweep's width, each entry point alone: rows too wide for
# shared memory (read from global memory, the wide form unstaged, slot
# windows), classes past the registers (logits recomputed, windows) and
# classes whose terms pass a block's shared memory (each window keeps its
# own classes')
K7_WIDE_SHAPES = ((20_000, 2), (16, 300), (16, 2_000))
K7_WIDE_ROWS = 4_096


def check_k7_wide(torch) -> dict:
    """K7's two entry points at K7_WIDE_SHAPES on K7_WIDE_ROWS seeded rows
    (the logits kept small: W scaled by 1/sqrt(F)), against the plain twin
    at K7_LOSS_RTOL and K7_GRAD_ATOL, a second launch bit identical; with
    the geometry each ran in."""
    record = {}
    for features, classes in K7_WIDE_SHAPES:
        rng = np.random.default_rng(features + classes)

        def cuda(array):
            return torch.from_numpy(np.ascontiguousarray(array, dtype=np.float32)).cuda()

        X = cuda(rng.normal(size=(K7_WIDE_ROWS, features)))
        y = torch.from_numpy(rng.integers(0, classes, K7_WIDE_ROWS).astype(np.int32)).cuda()
        W = cuda(rng.normal(size=(features, classes)) * 0.3 / np.sqrt(features))
        b = cuda(rng.normal(size=classes) * 0.3)
        steps = torch.tensor([1.0, 0.5, 0.25, 0.125], device=X.device)
        W4 = (W[None] * (1.0 + steps[:, None, None])).contiguous()
        b4 = (b[None] * (1.0 + steps[:, None])).contiguous()
        what = f"{features} features x {classes} classes"
        got = logistic.loss_and_grad(W, b, X, y, 0.0)
        if not all(torch.equal(a, c) for a, c in zip(got, logistic.loss_and_grad(W, b, X, y, 0.0))):
            raise AssertionError(f"logistic_loss_grad ({what}): a second launch differs")
        want = logistic._loss_fn(W, b, X, y, 0.0)
        loss_rel = abs(float(got[0]) - float(want[0])) / abs(float(want[0]))
        grad_err = max(float((got[i] - want[i]).abs().max()) for i in (1, 2))
        if not loss_rel <= K7_LOSS_RTOL or not grad_err <= K7_GRAD_ATOL:
            raise AssertionError(f"logistic_loss_grad ({what}): loss {loss_rel} relative, gradient {grad_err}")
        trial = logistic.trial_losses(W4, b4, X, y, 0.0)
        if not torch.equal(trial, logistic.trial_losses(W4, b4, X, y, 0.0)):
            raise AssertionError(f"logistic_trial_losses ({what}): a second launch differs")
        plain_trial = logistic._trial_losses(W4, b4, X, y, 0.0)
        trial_rel = float(((trial - plain_trial).abs() / plain_trial.abs()).max())
        if not trial_rel <= K7_LOSS_RTOL:
            raise AssertionError(f"logistic_trial_losses ({what}): {trial_rel} relative")
        record[what] = {
            "loss_rel": loss_rel, "grad_err": grad_err, "trial_rel": trial_rel,
            "geometry": logistic._k7_geometry(features, classes, 1, False),
            "trial_geometry": logistic._k7_geometry(features, classes, 1, False, trial=True),
        }
    return record


def phase_fit_kernels(torch) -> dict:
    X, y = bench_synthetic(FIT_ROWS)
    thresholds_np = binning.make_thresholds(X).astype(np.float32)
    thresholds_np[3, -2:] = np.inf  # a feature with repeated inf thresholds
    # values binning must place exactly, among the rows
    X[:4, 0] = [np.nan, np.inf, -np.inf, -0.0]
    X[4:6, 1] = thresholds_np[1, 7:9]
    X[6:8, 3] = [np.inf, np.nan]
    X_dev = torch.from_numpy(X).cuda()
    y_dev = torch.from_numpy(y.astype(np.int64)).cuda()
    thresholds = torch.from_numpy(thresholds_np).cuda()
    checked = check_fit_kernels(torch, X_dev, y_dev, thresholds)
    bins, cases = checked["bins"], checked["cases"]
    k1_edges = check_k1_edges(torch, X, thresholds_np)
    k3_edges = check_k3_edges(torch)
    rows = X.shape[0]
    results = {name: {"max_abs_err": checked["errors"][name], "by_level": {}} for name in FIT_REPLACES}
    # every call timed with a cold L2: the bounds count HBM bytes, and the
    # inputs of K2, K4 and K5 (28, 21 and 12 MB) would otherwise stay in L2
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=X_dev.device)
    read_flush = _ReadFlush(torch, X_dev.device)

    def timed(name, key, kernel, plain, library, n_nodes, channels, bins_read=0, trees_=1):
        bound_ms, bound_by = _fit_bound(
            name, rows, n_nodes, channels, bins_read, trees_, subsets=trees_ > 1
        )
        into = results[name]["forest"] if trees_ > 1 else results[name]
        into["by_level"][key] = {
            "ms": _event_ms(torch, kernel, 20, flush),
            "device_ms": _device_ms(torch, kernel, DEVICE_KERNELS[name], 20, flush),
            "plain_ms": _event_ms(torch, plain, 3, flush),
            "library_ms": None if library is None else _event_ms(torch, library, 3, flush),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
        }
        if name in ("route", "leaf_sums"):
            # the CUDA kernels one wrapper call ran (the profiler's count),
            # and the device time with L2 evicted by reads: the write flush
            # leaves dirty lines that the call's reads then write back
            into["by_level"][key]["kernels_a_call"] = _profile_device_us(torch, kernel, DEVICE_KERNELS[name])[1]
            into["by_level"][key]["device_ms_clean_l2"] = _device_ms(
                torch, kernel, DEVICE_KERNELS[name], 20, read_flush
            )

    X_columns = X_dev.T.contiguous()
    timed(
        "apply_bins", "all",
        lambda: binning.apply_bins(X_dev, thresholds),
        lambda: binning._apply_bins(X_dev, thresholds),
        lambda: torch.searchsorted(thresholds, X_columns, side="left"),
        1, 1,
    )
    feature_offsets = torch.arange(FEATURES, device=bins.device) * MAX_BINS
    for (mode, level), (node, channels, hist, feature, bin_index) in cases.items():
        key = f"{mode}:{level}"
        K = channels.shape[1]
        if level == DEPTH:
            n_leaves = 2**DEPTH
            leaf = node.long()
            # dt's call counts (integer channels), gb's sums
            timed(
                "leaf_sums", key,
                lambda: trees.leaf_sums(node, channels, n_leaves, integer=mode == "gini"),
                lambda: trees._leaf_sums(node, channels, n_leaves),
                lambda: [torch.bincount(leaf, weights=channels[:, k], minlength=n_leaves) for k in range(K)],
                n_leaves, K,
            )
            continue
        n_nodes = 2**level
        flat = (node.long()[:, None] * (FEATURES * MAX_BINS) + feature_offsets + bins.long()).reshape(-1)
        weights = [channels[:, k : k + 1].expand(rows, FEATURES).reshape(-1) for k in range(K)]
        timed(
            "level_histograms", key,
            lambda: trees.level_histograms(bins, node, channels, n_nodes, MAX_BINS, integer=mode == "gini"),
            lambda: trees._level_histograms(bins, node, channels, n_nodes, MAX_BINS),
            lambda: [torch.bincount(flat, weights=w, minlength=n_nodes * FEATURES * MAX_BINS) for w in weights],
            n_nodes, K,
        )
        results["level_histograms"]["by_level"][key]["k2_path"] = _histogram_path(rows, n_nodes, K, mode == "gini")
        timed(
            "select_splits", key,
            lambda: trees.select_splits(hist, mode),
            lambda: trees._select_plain(hist, mode),
            None, n_nodes, K,
        )
        # the rows whose node splits: each needs one bin
        bins_read = int((feature.long()[node.long()] >= 0).sum())
        timed(
            "route", key,
            lambda: trees.route(bins, node, feature, bin_index),
            lambda: trees._route(bins, node, feature, bin_index),
            None, n_nodes, K, bins_read,
        )
    forest = check_forest_kernels(torch, bins, y_dev)
    for name in FOREST_KERNELS:
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], forest["errors"][name])
        results[name]["forest"] = {
            "trees": TREES, "subset_k": SUBSET_K, "max_abs_err": forest["errors"][name], "by_level": {},
        }
    tree_ids = torch.arange(TREES, device=bins.device)[:, None]
    for level, (node, channels, hist, scores, feature, bin_index) in forest["cases"].items():
        key, K = f"rf:{level}", channels.shape[2]
        if level == DEPTH:
            n_leaves = 2**DEPTH
            index = (tree_ids * n_leaves + node.long()).reshape(-1)
            weights = [channels[:, :, k].reshape(-1) for k in range(K)]
            timed(
                "leaf_sums", key,
                lambda: trees.leaf_sums(node, channels, n_leaves, integer=True),
                lambda: trees._leaf_sums(node, channels, n_leaves),
                lambda: [torch.bincount(index, weights=w, minlength=TREES * n_leaves) for w in weights],
                n_leaves, K, trees_=TREES,
            )
            continue
        n_nodes = 2**level
        flat = (
            ((tree_ids * n_nodes + node.long())[:, :, None] * (FEATURES * MAX_BINS))
            + feature_offsets + bins.long()[None]
        ).reshape(-1)
        weights = [channels[:, :, k : k + 1].expand(TREES, rows, FEATURES).reshape(-1) for k in range(K)]
        cells = TREES * n_nodes * FEATURES * MAX_BINS
        timed(
            "level_histograms", key,
            lambda: trees.level_histograms(bins, node, channels, n_nodes, MAX_BINS, integer=True),
            lambda: trees._level_histograms(bins, node, channels, n_nodes, MAX_BINS),
            lambda: [torch.bincount(flat, weights=w, minlength=cells) for w in weights],
            n_nodes, K, trees_=TREES,
        )
        del flat, weights
        timed(
            "select_splits", key,
            lambda: trees.select_splits(hist, "gini", scores, SUBSET_K),
            lambda: trees._select_plain(hist, "gini", scores, SUBSET_K),
            None, n_nodes, K, trees_=TREES,
        )
        # the (tree, row) pairs whose node splits: each needs one bin
        bins_read = int((feature.long().gather(1, node.long()) >= 0).sum())
        timed(
            "route", key,
            lambda: trees.route(bins, node, feature, bin_index),
            lambda: trees._route(bins, node, feature, bin_index),
            None, n_nodes, K, bins_read, trees_=TREES,
        )
    for result in results.values():
        # a fit's mean call: over the levels, dt and gb channels alike (the
        # forest's apart)
        for into in (result, result.get("forest")):
            if into is None:
                continue
            levels = list(into["by_level"].values())
            for field in ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms"):
                values = [level[field] for level in levels]
                into[field] = None if None in values else sum(values) / len(values)
            into["bound_by"] = levels[0]["bound_by"]
    # K3 also at the deep dt's last level (2,048 nodes x 10 classes) and at
    # 255 bins x 10 classes (16 nodes), beside the card's launch floor
    by_shape = results["select_splits"]["by_shape"] = {}
    for name in ("2048_nodes_10_classes", "255_bins_10_classes"):
        hist, mode = k3_edges["cases"][name]
        n_nodes, B, K = hist.shape[0], hist.shape[2], hist.shape[3]
        bound_ms, bound_by = _fit_bound("select_splits", rows, n_nodes, K, max_bins=B)
        by_shape[name] = {
            "ms": _event_ms(torch, lambda: trees.select_splits(hist, mode), 20, flush),
            "device_ms": _device_ms(torch, lambda: trees.select_splits(hist, mode),
                                    DEVICE_KERNELS["select_splits"], 20, flush),
            "plain_ms": _event_ms(torch, lambda: trees._select_plain(hist, mode), 3, flush),
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
        }
    results["select_splits"]["launch_floor_ms"] = _launch_floor_ms(torch, flush)
    forest_checks = {"subset_edges": forest["subset_edges"], "wide_level": forest["wide_level"]}
    X, y = bench_synthetic(FIT_ROWS)
    repairs = check_repairs(torch, X, y)
    results.update(check_logistic_kernels(torch, X, y, flush))
    emit({
        "phase": "fit-kernels", "rows": rows, "features": FEATURES, "max_bins": MAX_BINS,
        **results, "repairs": repairs, "forest_checks": forest_checks,
        "k7_wide": check_k7_wide(torch),
        "k7_empty": check_k7_empty(torch),
        "k1_edges": k1_edges, "k3_edges": k3_edges["outcomes"],
    })
    return results


def _fit_launches(before: dict, after: dict) -> dict:
    return {name: after[name] - before[name] for name in FIT_KERNELS}


@contextlib.contextmanager
def _plain_level_loop():
    """Within the block, the fits of ``trees`` run the level loop's plain
    versions in place of its kernels, on any device: the yardstick that a
    fit by the kernels is held to. Raises if a kernel launched."""
    with _plain(trees, {
        "level_histograms": _plain_histograms,
        "select_splits": trees._select_plain,
        "route": trees._route,
        "leaf_sums": _plain_leaf_sums,
    }):
        yield


def _plain_histograms(bins, node, channels, n_nodes, max_bins, integer=False):
    """K2's plain version in the wrappers' signature (the plain version's
    float64 sums are the same for integer channels and any others)."""
    return trees._level_histograms(bins, node, channels, n_nodes, max_bins)


def _plain_leaf_sums(leaf_of_row, channels, n_leaves, integer=False):
    """K5's plain version in the wrappers' signature (as K2's)."""
    return trees._leaf_sums(leaf_of_row, channels, n_leaves)


@contextlib.contextmanager
def _plain_k7():
    """Within the block, the lr fit runs K7's plain twin in place of the
    kernel, on any device. Raises if a kernel launched."""
    with _plain(logistic, {
        "loss_and_grad": logistic._loss_fn,
        "trial_losses": logistic._trial_losses,
    }):
        yield


@contextlib.contextmanager
def _plain(module, plain: dict):
    wrappers = {name: getattr(module, name) for name in plain}
    before = kernels.launches()
    for name, function in plain.items():
        setattr(module, name, function)
    try:
        yield
    finally:
        for name, function in wrappers.items():
            setattr(module, name, function)
    if kernels.launches() != before:
        raise AssertionError("a plain-version fit launched a kernel")


def _tree_launches(depth: int, rounds: int = 1) -> dict:
    return {
        "apply_bins": 1, "level_histograms": depth * rounds, "select_splits": depth * rounds,
        "route": depth * rounds, "leaf_sums": rounds,
        "logistic_loss_grad": 0, "logistic_trial_losses": 0,
    }


def phase_fit(torch, card: str) -> dict:
    X, y = bench_synthetic(FIT_ROWS)
    rows = X.shape[0]
    started = time.perf_counter()
    thresholds_np = binning.make_thresholds(X)
    thresholds_s = time.perf_counter() - started
    torch.cuda.synchronize()
    started = time.perf_counter()
    X_dev = torch.from_numpy(X).cuda()
    y_dev = torch.from_numpy(y.astype(np.int64)).cuda()
    torch.cuda.synchronize()
    h2d_s = time.perf_counter() - started

    # the main path: fit, evaluate, save, serve
    models, record = {}, {"phase": "fit", "rows": rows, "features": FEATURES}
    no_launches = {name: 0 for name in FIT_KERNELS}
    expected = {
        "dt": _tree_launches(DEPTH),
        # the 20 trees in one chunk: one launch a level for all of them
        "rf": _tree_launches(DEPTH),
        "gb": _tree_launches(DEPTH, GBT_ROUNDS),
        "lr": None,   # from the direct fit's iterations, below
        "nb": no_launches,
    }
    kernels.reset_launches()
    for name in ("dt", "rf", "gb", "lr", "nb"):
        before = kernels.launches()
        torch.cuda.synchronize()
        started = time.perf_counter()
        model = make_classifier(name).fit(X, y)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - started
        launches = _fit_launches(before, kernels.launches())
        if expected[name] is not None and launches != expected[name]:
            raise AssertionError(f"{name} fit launched {launches}, expected {expected[name]}")
        before = kernels.launches()
        accuracy, weighted_f1, labels, probs = model.evaluate_predict(X, y, X)
        evaluate_launches = {
            kernel: count - before.get(kernel, 0)
            for kernel, count in kernels.launches().items() if count != before.get(kernel, 0)
        }
        if probs.shape != (rows, CLASSES) or not np.isfinite(probs).all():
            raise AssertionError(f"{name}: probabilities of shape {probs.shape}")
        if not 0.5 < accuracy <= 1.0:
            raise AssertionError(f"{name}: accuracy {accuracy}")
        models[name] = model
        record[name] = {
            "wall_s": wall_s,
            "launches": launches,
            "evaluate_launches": evaluate_launches,
            "accuracy": accuracy,
            "weighted_f1": weighted_f1,
        }
        if name in ("dt", "rf", "gb"):
            record[name].update(host_thresholds_s=thresholds_s, h2d_s=h2d_s)
    serve_rows = bench_rows(np.random.default_rng(13), 8)
    with tempfile.TemporaryDirectory() as models_dir:
        for name, model in models.items():
            save_model(model, checkpoint_path(models_dir, f"{name}_fit"))
        plane = ServePlane()
        server = ServerThread(create_app(InMemoryStore(), models_dir=models_dir, serve=plane)).start()
        try:
            client = _Client(server.port)
            for name, model in models.items():
                status, body = client.call("POST", f"/models/{name}_fit/predict", {"rows": serve_rows.tolist()})
                tolerance = LINEAR_TOL if name in ("lr", "nb") else TREE_TOL
                _check_answer(name, status, body, serve_rows, model.predict_proba(serve_rows), tolerance)
        finally:
            server.stop()
            plane.close()
    torch.cuda.synchronize()
    record["launches"] = kernels.launches()
    missing = [name for name in FIT_KERNELS if record["launches"][name] == 0]
    if missing:
        raise AssertionError(f"the fit path never launched {missing}")

    check_tree_fits(torch, X, y, X_dev, y_dev, thresholds_np, models, record)
    check_rf_fit(torch, X, y, X_dev, y_dev, thresholds_np, models["rf"], record)
    check_lr_fit(torch, X, y, models["lr"], record)
    check_nb_fit(torch, X, y, models["nb"], record)
    record["dt_deep"] = check_deep_dt(torch, X)
    record["K9"] = time_metrics(torch, y_dev)
    # the device's share of a fit's wall time: the trace's kernel time of
    # one more fit through the estimator
    for name in models:
        record[name]["device_busy_ms"] = _busy_ms(torch, lambda: make_classifier(name).fit(X, y))
    record["host_syncs_in_fit_loops"] = 0
    record["nvidia_smi"] = card
    emit(record)
    return record


def check_tree_fits(torch, X, y, X_dev, y_dev, thresholds_np, models, record) -> None:
    """dt and gb held against fits by the plain versions on the card; gb
    refit bit for bit; no host sync in a level or boosting loop."""
    rows = X.shape[0]
    thresholds = torch.from_numpy(thresholds_np.astype(np.float32)).cuda()
    weights = torch.ones(rows, dtype=torch.float32, device=X_dev.device)
    plain_bins = binning._apply_bins(X_dev, thresholds)
    with _plain_level_loop():
        features_heap, bins_heap, leaf_probs = trees._dt_fit(
            plain_bins, y_dev, weights, CLASSES, DEPTH, MAX_BINS
        )
    plain_dt = trees._TreeEnsembleModel(
        features_heap[None], trees._heap_thresholds(features_heap, bins_heap, thresholds)[None],
        leaf_probs[None], DEPTH,
    )
    dt = models["dt"]
    if not (
        torch.equal(dt.features_heap, plain_dt.features_heap)
        and torch.equal(dt.thresholds_heap, plain_dt.thresholds_heap)
        and torch.equal(dt.leaf_probs, plain_dt.leaf_probs)
    ):
        raise AssertionError("dt: the kernels' heaps differ from the plain-version fit")
    plain_metrics = plain_dt.evaluate_predict(X, y, X)[:2]
    if plain_metrics != (record["dt"]["accuracy"], record["dt"]["weighted_f1"]):
        raise AssertionError(f"dt: metrics {plain_metrics} of the plain-version fit differ")

    bins = binning.apply_bins(X_dev, thresholds)

    def gb_fit():
        return trees._gbt_fit(bins, y_dev, weights, DEPTH, MAX_BINS, GBT_ROUNDS, GBT_STEP)

    # no host sync anywhere in a level or boosting loop: any would raise here
    torch.cuda.set_sync_debug_mode("error")
    try:
        first = gb_fit()
        direct_dt = trees._dt_fit(bins, y_dev, weights, CLASSES, DEPTH, MAX_BINS)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if not torch.equal(direct_dt[0], dt.features_heap[0]):
        raise AssertionError("dt: the estimator's fit differs from the same fit run directly")
    second = gb_fit()
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError("gb: a second fit with the kernels is not bit identical")
    gb = models["gb"]
    if not (
        float(first[0]) == gb.f0
        and torch.equal(first[1], gb.features_heap)
        and torch.equal(first[3], gb.leaf_values)
    ):
        raise AssertionError("gb: the estimator's fit differs from the same fit run directly")
    with _plain_level_loop():
        plain = gb_fit()
    differing = int(((first[1] != plain[1]) | (first[2] != plain[2])).sum())
    margin_error = float((first[4] - plain[4]).abs().max())
    y_dev_f = y_dev.to(torch.float32)
    accuracy = float(((first[4] > 0).to(torch.float32) == y_dev_f).to(torch.float32).mean())
    plain_accuracy = float(((plain[4] > 0).to(torch.float32) == y_dev_f).to(torch.float32).mean())
    if margin_error > FIT_MARGIN_TOL or abs(accuracy - plain_accuracy) > FIT_MARGIN_TOL:
        raise AssertionError(
            f"gb: margins differ by {margin_error}, accuracy {accuracy} against {plain_accuracy}"
        )
    record["gb"].update(
        heap_nodes_differing_from_plain=differing,
        heap_nodes=int(first[1].numel()),
        max_margin_err=margin_error,
        train_accuracy_from_margins=accuracy,
        plain_train_accuracy_from_margins=plain_accuracy,
        rerun_bit_identical=True,
    )
    record["dt"]["heaps_identical_to_plain"] = True


def check_rf_fit(torch, X, y, X_dev, y_dev, thresholds_np, model, record) -> None:
    """The estimator's rf fit against the same fit run directly on its
    draws (made again from the seed), with host syncs made errors; a
    second fit through the estimator bit for bit; and a fit by the plain
    versions on the card from the same draws: heaps identical, leaf
    probabilities within TREE_TOL."""
    rows = X.shape[0]
    thresholds = torch.from_numpy(thresholds_np.astype(np.float32)).cuda()
    weights = torch.ones(rows, dtype=torch.float32, device=X_dev.device)
    draws = _card_draws(torch, rows, 0, X_dev.device)
    bins = binning.apply_bins(X_dev, thresholds)

    def rf_fit(level_bins):
        return trees._rf_fit(
            level_bins, y_dev, weights, draws, CLASSES, DEPTH, MAX_BINS, TREES, SUBSET_K
        )

    torch.cuda.set_sync_debug_mode("error")
    try:
        features_heap, bins_heap, leaf_probs = rf_fit(bins)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    thresholds_heap = trees._heap_thresholds(features_heap, bins_heap, thresholds)
    if not (
        torch.equal(features_heap, model.features_heap)
        and torch.equal(thresholds_heap, model.thresholds_heap)
        and torch.equal(leaf_probs, model.leaf_probs)
    ):
        raise AssertionError("rf: the estimator's fit differs from the same fit run directly")
    again = make_classifier("rf").fit(X, y)
    if not all(
        torch.equal(getattr(again, name), getattr(model, name))
        for name in ("features_heap", "thresholds_heap", "leaf_probs")
    ):
        raise AssertionError("rf: a second fit with the same seed is not bit identical")
    with _plain_level_loop():
        plain = rf_fit(binning._apply_bins(X_dev, thresholds))
    if not (torch.equal(plain[0], features_heap) and torch.equal(plain[1], bins_heap)):
        raise AssertionError("rf: the kernels' heaps differ from the plain-version fit")
    prob_error = float((plain[2] - leaf_probs).abs().max())
    if prob_error > TREE_TOL:
        raise AssertionError(f"rf: leaf probabilities differ from the plain-version fit by {prob_error}")
    record["rf"].update(
        trees=TREES,
        subset_k=SUBSET_K,
        splits=int((features_heap >= 0).sum()),
        heaps_identical_to_plain=True,
        max_leaf_prob_err_to_plain=prob_error,
        refit_bit_identical=True,
    )


def check_lr_fit(torch, X, y, model, record) -> None:
    """The estimator's lr fit against the same fit run directly (its K7
    launches: two an iteration, one a segment), a second run bit for bit,
    segments run with host syncs made errors, and a fit by the plain twin
    on the card: losses within LR_LOSS_RTOL, the same stop segment and
    probabilities within LR_PROB_TOL."""
    started = time.perf_counter()
    mean, scale = logistic.scaler_stats(X)
    X_std = logistic._standardized(X, mean, scale)
    host_scaler_s = time.perf_counter() - started
    X_dev = torch.from_numpy(X_std).cuda()
    y_dev = torch.from_numpy(y.astype(np.int32)).cuda()

    def start():
        W = torch.zeros((FEATURES, CLASSES), dtype=torch.float32, device=X_dev.device)
        return W, torch.zeros(CLASSES, dtype=torch.float32, device=X_dev.device)

    def fit():
        return logistic._fit(*start(), X_dev, y_dev, 100, 0.0)

    torch.cuda.synchronize()
    started = time.perf_counter()
    W, b, losses = fit()
    torch.cuda.synchronize()
    lbfgs_s = time.perf_counter() - started
    iterations = losses.shape[0]
    iters = logistic._segment_iters(100, X.shape[0], FEATURES, logistic._LR_TOL)
    expected = {
        **{name: 0 for name in FIT_KERNELS},
        "logistic_loss_grad": iterations + iterations // iters,
        "logistic_trial_losses": iterations,
    }
    if record["lr"]["launches"] != expected:
        raise AssertionError(f"lr fit launched {record['lr']['launches']}, expected {expected}")
    if not (torch.equal(W, model.w) and torch.equal(b, model.b)):
        raise AssertionError("lr: the estimator's fit differs from the same fit run directly")
    again = fit()
    if not all(torch.equal(a, c) for a, c in zip((W, b, losses), again)):
        raise AssertionError("lr: a second fit with the kernel is not bit identical")
    # no host sync inside a segment: the loss copy between segments is the
    # fit's one transfer
    W_s, b_s = start()
    state = logistic._lbfgs_state(W_s, b_s)
    segment_losses = []
    for _ in range(iterations // iters):
        torch.cuda.set_sync_debug_mode("error")
        try:
            W_s, b_s, state, part = logistic._fit_segment_impl(W_s, b_s, state, X_dev, y_dev, iters, 0.0)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        segment_losses.append(part.cpu())
    if not torch.equal(torch.cat(segment_losses), losses.cpu()):
        raise AssertionError("lr: the segments run one by one differ from the fit")
    with _plain_k7():
        plain_W, plain_b, plain_losses = fit()
    if plain_losses.shape != losses.shape:
        raise AssertionError(
            f"lr: {iterations} iterations with the kernel, {plain_losses.shape[0]} with the plain twin"
        )
    loss_rel = float(((losses - plain_losses).abs() / plain_losses.abs()).max())
    probs = logistic._forward(X_dev, W, b, 0.0, 1.0)
    plain_probs = logistic._forward(X_dev, plain_W, plain_b, 0.0, 1.0)
    prob_err = float((probs - plain_probs).abs().max())
    if loss_rel > LR_LOSS_RTOL or prob_err > LR_PROB_TOL:
        raise AssertionError(f"lr: losses {loss_rel} relative, probabilities {prob_err} from the plain fit")
    record["lr"].update(
        host_scaler_s=host_scaler_s,
        lbfgs_s=lbfgs_s,
        lbfgs_device_busy_ms=_busy_ms(torch, fit),
        iterations=iterations,
        segments=iterations // iters,
        first_loss=float(losses[0]),
        last_loss=float(losses[-1]),
        max_loss_rel_err_to_plain=loss_rel,
        max_prob_err_to_plain=prob_err,
        rerun_bit_identical=True,
    )


def check_nb_fit(torch, X, y, model, record) -> None:
    """nb's theta and prior against a float64 computation on the host, and
    a second fit bit for bit."""
    classes = int(y.max()) + 1
    sums = np.stack([X[y == c].astype(np.float64).sum(axis=0) for c in range(classes)])
    counts = np.bincount(y, minlength=classes).astype(np.float64)
    smoothed = sums + 1.0
    theta = np.log(smoothed) - np.log(smoothed.sum(axis=1, keepdims=True))
    prior = np.log(counts) - np.log(len(y))
    theta_err = float(np.abs(model.theta.cpu().numpy() - theta).max())
    prior_err = float(np.abs(model.prior.cpu().numpy() - prior).max())
    if theta_err > NB_TOL or prior_err > NB_TOL:
        raise AssertionError(f"nb: theta {theta_err}, prior {prior_err} from float64")
    again = naive_bayes.NaiveBayes().fit(X, y)
    if not (torch.equal(again.theta, model.theta) and torch.equal(again.prior, model.prior)):
        raise AssertionError("nb: a second fit is not bit identical")
    record["nb"].update(max_theta_err_to_f64=theta_err, max_prior_err_to_f64=prior_err, rerun_bit_identical=True)


def check_deep_dt(torch, X) -> dict:
    """A depth-12 dt of 10 classes (2,048 nodes at its last level, past
    one block's shared memory) through the estimator, its heaps identical
    to a fit by the plain versions on the card."""
    y10 = ten_classes(X)
    estimator = make_classifier("dt")
    estimator.max_depth = DEEP_DEPTH
    torch.cuda.synchronize()
    started = time.perf_counter()
    model = estimator.fit(X, y10)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - started
    X_dev = torch.from_numpy(X).cuda()
    y_dev = torch.from_numpy(y10.astype(np.int64)).cuda()
    thresholds = torch.from_numpy(binning.make_thresholds(X).astype(np.float32)).cuda()
    weights = torch.ones(X.shape[0], dtype=torch.float32, device=X_dev.device)
    with _plain_level_loop():
        features_heap, bins_heap, leaf_probs = trees._dt_fit(
            binning._apply_bins(X_dev, thresholds), y_dev, weights, DEEP_CLASSES, DEEP_DEPTH, MAX_BINS
        )
    if not (
        torch.equal(model.features_heap[0], features_heap)
        and torch.equal(model.thresholds_heap[0], trees._heap_thresholds(features_heap, bins_heap, thresholds))
        and torch.equal(model.leaf_probs[0], leaf_probs)
    ):
        raise AssertionError("deep dt: the kernels' heaps differ from the plain-version fit")
    splits = int((features_heap >= 0).sum())
    last_level = int((features_heap[2 ** (DEEP_DEPTH - 1) - 1 :] >= 0).sum())
    if last_level == 0:
        raise AssertionError("deep dt: the last level does not split")
    return {
        "depth": DEEP_DEPTH, "classes": DEEP_CLASSES, "wall_s": wall_s,
        "splits": splits, "last_level_splits": last_level, "heaps_identical_to_plain": True,
        "device_busy_ms": _busy_ms(torch, lambda: estimator.fit(X, y10)),
    }


def time_metrics(torch, y_dev) -> dict:
    """K9 (the confusion matrix and its metrics, torch ops) at the fit's
    rows, cold and warm, beside its bound: the two int64 label vectors
    read once over HBM bandwidth."""
    predicted = (y_dev + (torch.arange(y_dev.shape[0], device=y_dev.device) % 7 == 0)) % CLASSES
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=y_dev.device)

    def call():
        return evaluation.masked_metrics(y_dev, predicted, None, CLASSES)

    return {
        "ms": _event_ms(torch, call, 20, flush),
        "warm_ms": _event_ms(torch, call, 50),
        "bound_ms": 2 * y_dev.numel() * 8 / PEAK_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
    }


# --------------------------------------------------------------------------
# The image lane: t-SNE's kernels K11-K13 and the tsne and pca services
# --------------------------------------------------------------------------

def embed_blobs(rows: int, seed: int = 7):
    """bench.py's embedding data (its ``blobs``): 16 float32 features
    around 10 centres drawn at 8 times the unit noise; and each row's
    centre."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(10, FEATURES)) * 8.0
    labels = rng.integers(0, 10, size=rows)
    X = (centres[labels] + rng.normal(size=(rows, FEATURES))).astype(np.float32)
    return X, labels


def _tsne_bound(name: str, rows: int, columns: int, features: int) -> tuple[float, str]:
    """Least milliseconds the card could take for one call: bytes (inputs
    read once, outputs written once) over HBM bandwidth against the
    float32 instructions of its pairs over the card's instruction rate:
    ``rows`` x ``columns`` for K11 and K13, the ``rows (rows - 1) / 2``
    unordered pairs for K12. K11: X in, P out; K12: Y in (and P for the
    gradient), Z or the gradient out; K13: rows, landmarks and their
    embedding in, (rows, 2) out."""
    pairs = rows * columns
    unordered = rows * (rows - 1) // 2
    distance = features + 3
    if name == "tsne_affinities":
        bytes_moved = rows * features * 4 + pairs * 4
        instructions = pairs * (distance + TSNE_AFFINITY_INSTRUCTIONS)
    elif name == "tsne_z":
        bytes_moved = rows * 8 + 4
        instructions = unordered * (TSNE_INVERSE_INSTRUCTIONS + 1)
    elif name == "tsne_grad":
        bytes_moved = pairs * 4 + rows * 8 * 2 + 4
        instructions = unordered * TSNE_GRADIENT_PAIR_INSTRUCTIONS
    else:
        bytes_moved = (rows + columns) * features * 4 + columns * 8 + rows * 8
        instructions = pairs * (distance + TSNE_INTERPOLATION_INSTRUCTIONS)
    byte_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
    op_ms = instructions / PEAK_FP32_INSTRUCTIONS_PER_S * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


@contextlib.contextmanager
def _plain_tsne():
    """Within the block, the t-SNE fits run K11-K13's plain versions in
    place of the kernels, on any device. Raises if a kernel launched."""
    with _plain(tsne, {
        "conditional_affinities": tsne._conditional_affinities,
        "tsne_z": tsne._tsne_z,
        "tsne_grad": tsne._tsne_grad,
        "interpolate": tsne._interpolate,
    }):
        yield


@contextlib.contextmanager
def _distances_in_global_memory():
    """Within the block, K11 and K13 keep a row's distances in global
    memory, as past ~57,000 columns, and not in shared memory."""
    saved = tsne._SHARED_DISTANCE_BYTES
    tsne._SHARED_DISTANCE_BYTES = 0
    try:
        yield
    finally:
        tsne._SHARED_DISTANCE_BYTES = saved


# K12 on a seeded non-symmetric P (the kernels assume no symmetry): no
# pair, one pair, and ragged tiles at n % 4 != 0 (4-byte copies of P) and
# n % 4 == 0 (16-byte copies)
K12_EDGE_ROWS = (1, 2, 2 * tsne.PAIR_TILE + 5, 300)


def check_k12_edges(torch, device, held, failures) -> dict:
    """Z and the gradient on a non-symmetric P at ``K12_EDGE_ROWS``,
    against the plain versions with the main path's tolerances (the
    gradient no farther from float64 than the plain version), and a
    second launch bit identical. Where there is no pair (n = 1) both are
    0: errors are absolute there."""
    rng = np.random.default_rng(11)
    edges = {}
    for n in K12_EDGE_ROWS:
        key = f"{n}:non-symmetric"
        Y = torch.from_numpy((rng.normal(size=(n, 2)) * 10.0).astype(np.float32)).to(device)
        P = torch.from_numpy(rng.random((n, n), dtype=np.float32)).to(device)
        P /= P.sum()
        exaggeration = tsne.EARLY_EXAGGERATION
        Z, Z_plain = tsne.tsne_z(Y), tsne._tsne_z(Y)
        grad = tsne.tsne_grad(Y, P, Z, exaggeration)
        grad_plain = tsne._tsne_grad(Y, P, Z_plain, exaggeration)
        Y64 = Y.double()
        grad64 = tsne._tsne_grad(Y64, P.double(), tsne._tsne_z(Y64), exaggeration)
        z_difference = float((Z.double() - Z_plain.double()).abs())
        z_checked = held("tsne_z", key, z_difference, z_difference / (float(Z_plain) or 1.0), K12_Z_RTOL)
        scale64 = float(grad64.abs().max()) or 1.0
        float64_err = float((grad - grad64).abs().max()) / scale64
        plain_float64_err = float((grad_plain - grad64).abs().max()) / scale64
        difference = float((grad - grad_plain).abs().max())
        grad_checked = held(
            "tsne_grad", key, difference, difference / (float(grad_plain.abs().max()) or 1.0),
            max(K12_PLAIN_TOL, 2.0 * plain_float64_err + K12_FLOAT64_SLACK),
            {"float64_err": float64_err, "plain_float64_err": plain_float64_err},
        )
        if not float64_err <= plain_float64_err + K12_FLOAT64_SLACK:
            failures.append(
                f"tsne_grad at {key}: {float64_err} from float64, farther "
                f"than the plain version's {plain_float64_err}"
            )
        if not (torch.equal(tsne.tsne_z(Y), Z) and torch.equal(tsne.tsne_grad(Y, P, Z, exaggeration), grad)):
            failures.append(f"K12 at {key}: a second launch differs")
        edges[key] = {"z": z_checked, "grad": grad_checked}
    return edges


def _card(torch):
    return torch.device("cuda", torch.cuda.current_device())


def embed_store():
    """bench.py's blobs in the port's store, as the image requests read
    them: ``blobs_1m`` (1,000,000 rows, class numbers in the label
    column) and ``blobs_20k`` (20,000 rows, class names, label-encoded in
    sorted order, c0 < c1 < ...). Returns the store, each collection's
    labels and the seconds the writes took."""
    from learningorchestra_tpu_torch.core.table import ColumnTable, write_table

    started = time.perf_counter()
    store = InMemoryStore()
    labels_by_name = {}
    for name, rows, seed, string_labels in (
        ("blobs_1m", EMBED_ROWS, 7, False), ("blobs_20k", EXACT_ROWS, 8, True),
    ):
        X, labels = embed_blobs(rows, seed)
        columns = {f"f{k}": X[:, k].astype(np.float64) for k in range(FEATURES)}
        columns["label"] = (
            np.array([f"c{label}" for label in labels], dtype=object)
            if string_labels else labels.astype(np.float64)
        )
        write_table(
            store, name, ColumnTable(columns),
            {"filename": name, "finished": True, "fields": list(columns)},
        )
        labels_by_name[name] = labels
    return store, labels_by_name, time.perf_counter() - started


def phase_embed_kernels(torch, store) -> dict:
    """K11, K12 and K13 against their plain versions on the card, on the
    main path's own matrices (the store's blobs as the image requests read
    them, label column included), each timed cold beside its bound. Every
    check runs and is reported; the phase raises at its end if any
    failed."""
    from learningorchestra_tpu_torch.core.devcache import dataset_embedding_inputs

    started = time.perf_counter()
    device = _card(torch)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
    results = {name: {"max_abs_err": 0.0, "max_rel_err": 0.0, "by_rows": {}} for name in TSNE_KERNELS}
    failures: list = []

    def held(name, key, abs_err, rel_err, tolerance, extra=None):
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], abs_err)
        results[name]["max_rel_err"] = max(results[name]["max_rel_err"], rel_err)
        if not rel_err <= tolerance:
            failures.append(f"{name} at {key}: error {rel_err} against a tolerance of {tolerance}")
        return {"abs_err": abs_err, "rel_err": rel_err, "tolerance": tolerance, **(extra or {})}

    def plain_call(fn):
        """One call of a plain version, cold: its result and milliseconds."""
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        result = fn()
        end.record()
        torch.cuda.synchronize()
        return result, start.elapsed_time(end)

    def timed(name, key, kernel, plain_ms, bound, repeats, checked):
        bound_ms, bound_by = bound
        results[name]["by_rows"][key] = {
            "ms": _event_ms(torch, kernel, repeats, flush),
            "device_ms": _device_ms(torch, kernel, DEVICE_KERNELS[name], repeats, flush),
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            **checked,
        }

    # the main path's matrices: the 20,000-row exact fit's, and the
    # landmark fit's 5,000 rows of the 1,000,000 (the requests' seed, 0)
    _, _, X_exact = dataset_embedding_inputs(store, "blobs_20k", device)
    _, _, X_all = dataset_embedding_inputs(store, "blobs_1m", device)
    chosen = torch.from_numpy(tsne._choose_landmarks(len(X_all), tsne.LANDMARKS, 0)).to(device)
    fit_inputs = {tsne.LANDMARKS: X_all[chosen], EXACT_ROWS: X_exact}
    features = X_all.shape[1]

    # K11: each row's calibrated p, at the two fits' rows and at the
    # 2,048-row quality fit's (the 20,000 rows' first)
    for rows, X in {QUALITY_ROWS: X_exact[:QUALITY_ROWS].contiguous(), **fit_inputs}.items():
        perplexity = tsne._clamped_perplexity(tsne.PERPLEXITY, rows)
        got = tsne.conditional_affinities(X, perplexity)
        want, plain_ms = plain_call(lambda: tsne._conditional_affinities(X, perplexity))
        again = tsne.conditional_affinities(X, perplexity)
        torch.cuda.synchronize()
        difference = (got - want).abs_()
        row_error = (difference / want.amax(dim=1, keepdim=True)).amax(dim=1)
        checked = held(
            "tsne_affinities", rows, float(difference.max()), float(row_error.max()), K11_TOL,
            {
                # rows past the tolerance: a bisection step that took the
                # other branch on a knife edge
                "rows_past_tolerance": int((row_error > K11_TOL).sum()),
                "rows_past_1e-5": int((row_error > 1e-5).sum()),
                "row_sums_err": float((got.double().sum(dim=1) - 1.0).abs().max()),
            },
        )
        del difference, row_error
        if not torch.equal(got, again):
            failures.append(f"tsne_affinities at {rows}: a second launch differs")
        if not (torch.isfinite(got).all() and bool((got.diagonal() == 0).all())):
            failures.append(f"tsne_affinities at {rows}: non-finite p or self affinity")
        if rows == tsne.LANDMARKS:
            # the distances in global memory (past ~57,000 rows) give the
            # same bits as in shared memory
            with _distances_in_global_memory():
                in_global = tsne.conditional_affinities(X, perplexity)
            checked["global_distances_identical"] = bool(torch.equal(in_global, got))
            if not checked["global_distances_identical"]:
                failures.append("tsne_affinities: distances in global memory change the result")
            del in_global
        del got, want, again
        timed(
            "tsne_affinities", rows,
            lambda: tsne.conditional_affinities(X, perplexity), plain_ms,
            _tsne_bound("tsne_affinities", rows, rows, features), 3, checked,
        )
        torch.cuda.empty_cache()

    # K12 on each fit's own P: Z and the gradient at its start Y0
    # (exaggerated) and at its final embedding (late); then three
    # iterations of the optimizer from each
    fitted = {}
    for rows, X in fit_inputs.items():
        P = tsne.affinities(X, tsne._clamped_perplexity(tsne.PERPLEXITY, rows))
        Y0 = tsne._initial_embedding(rows, 0, device)
        fitted[rows] = tsne._tsne_exact(X, tsne.PERPLEXITY, tsne.ITERATIONS, tsne.LEARNING_RATE, Y0)
        for phase, Y, exaggeration in (
            ("early", Y0, tsne.EARLY_EXAGGERATION), ("late", fitted[rows], 1.0),
        ):
            key = f"{rows}:{phase}"
            Z = tsne.tsne_z(Y)
            Z_plain, z_plain_ms = plain_call(lambda: tsne._tsne_z(Y))
            grad = tsne.tsne_grad(Y, P, Z, exaggeration)
            grad_plain, grad_plain_ms = plain_call(lambda: tsne._tsne_grad(Y, P, Z_plain, exaggeration))
            z_error = float((Z.double() - Z_plain.double()).abs() / Z_plain.double())
            z_checked = held("tsne_z", key, float((Z - Z_plain).abs()), z_error, K12_Z_RTOL)
            Y64, P64 = Y.double(), P.double()
            grad64 = tsne._tsne_grad(Y64, P64, tsne._tsne_z(Y64), exaggeration)
            del P64
            scale64 = float(grad64.abs().max())
            float64_err = float((grad - grad64).abs().max()) / scale64
            plain_float64_err = float((grad_plain - grad64).abs().max()) / scale64
            del grad64
            difference = float((grad - grad_plain).abs().max())
            grad_checked = held(
                "tsne_grad", key, difference, difference / float(grad_plain.abs().max()),
                max(K12_PLAIN_TOL, 2.0 * plain_float64_err + K12_FLOAT64_SLACK),
                {
                    "float64_err": float64_err, "plain_float64_err": plain_float64_err,
                    # the (tiles, n, 3) float64 partials beside P's bytes
                    "partials_bytes": tsne._tile_pairs(rows)[0] * rows * 3 * 8,
                    "p_bytes": rows * rows * 4,
                },
            )
            if not float64_err <= plain_float64_err + K12_FLOAT64_SLACK:
                failures.append(
                    f"tsne_grad at {key}: {float64_err} from float64, farther "
                    f"than the plain version's {plain_float64_err}"
                )
            torch.cuda.empty_cache()
            if not (torch.equal(tsne.tsne_z(Y), Z) and torch.equal(tsne.tsne_grad(Y, P, Z, exaggeration), grad)):
                failures.append(f"K12 at {key}: a second launch differs")
            early_phase = 3 if phase == "early" else 0
            stepped = tsne._optimize(P, Y, 3, early_phase, tsne.LEARNING_RATE, tsne.EARLY_EXAGGERATION)
            with _plain_tsne():
                stepped_plain = tsne._optimize(
                    P, Y, 3, early_phase, tsne.LEARNING_RATE, tsne.EARLY_EXAGGERATION
                )
            step_error = float((stepped - stepped_plain).abs().max() / stepped_plain.abs().max())
            grad_checked["three_iterations_err"] = step_error
            if not step_error <= K12_TOL:
                failures.append(f"K12 at {key}: three iterations apart by {step_error}")
            timed(
                "tsne_z", key, lambda: tsne.tsne_z(Y), z_plain_ms,
                _tsne_bound("tsne_z", rows, rows, features), 20, z_checked,
            )
            timed(
                "tsne_grad", key, lambda: tsne.tsne_grad(Y, P, Z, exaggeration), grad_plain_ms,
                _tsne_bound("tsne_grad", rows, rows, features), 20, grad_checked,
            )
        del P
        torch.cuda.empty_cache()
    results["tsne_grad"]["edges"] = check_k12_edges(torch, device, held, failures)

    # K13: the 1,000,000 rows onto the landmarks' fitted embedding, the
    # main path's one launch; and their first 65,536 rows
    L, Y_L = fit_inputs[tsne.LANDMARKS], fitted[tsne.LANDMARKS]
    perplexity = tsne._clamped_perplexity(tsne.PERPLEXITY, tsne.LANDMARKS)
    for rows in (EMBED_ROWS, INTERP_ROWS):
        X = X_all[:rows]
        key = f"{rows}x{tsne.LANDMARKS}"
        got = tsne.interpolate(X, L, Y_L, perplexity)
        want, plain_ms = plain_call(lambda: tsne._interpolate(X, L, Y_L, perplexity))
        difference = float((got - want).abs().max())
        checked = held("tsne_interpolate", key, difference, difference / float(Y_L.abs().max()), K13_TOL)
        if not torch.equal(tsne.interpolate(X, L, Y_L, perplexity), got):
            failures.append(f"tsne_interpolate at {key}: a second launch differs")
        # the main path keeps a row's 5,000 distances in shared memory; in
        # global scratch (a grid of fewer blocks walking the rows) they
        # give the same bits
        with _distances_in_global_memory():
            checked["global_distances_identical"] = bool(
                torch.equal(tsne.interpolate(X, L, Y_L, perplexity), got)
            )
        if not checked["global_distances_identical"]:
            failures.append(f"tsne_interpolate at {key}: distances in global memory change the result")
        del got, want
        timed(
            "tsne_interpolate", key, lambda: tsne.interpolate(X, L, Y_L, perplexity), plain_ms,
            _tsne_bound("tsne_interpolate", rows, tsne.LANDMARKS, features), 3, checked,
        )
    pca_times = time_pca(torch, flush, X_all)
    emit({
        "phase": "embed-kernels", "features": features, **results, "pca": pca_times,
        "failures": failures, "seconds": time.perf_counter() - started,
    })
    if failures:
        raise AssertionError(f"embed-kernels: {failures}")
    return results


def time_pca(torch, flush, X) -> dict:
    """K10 (``ops/pca.py:_pca``, torch ops and ``torch.linalg.eigh``) on
    the main path's matrix ``X`` (bench.py's 1,000,000 blobs with their
    label column), cold and warm, beside its bound: the rows read once and
    the (rows, 2) embedding written once over HBM bandwidth against its
    float32 operations (the covariance's 2 n F^2 and the projection's
    4 n F, the centring's 3 n F)."""
    mask = torch.ones(X.shape[0], dtype=torch.bool, device=X.device)
    rows, features = X.shape

    def call():
        return pca._pca(X, mask, 2)

    byte_ms = (rows * features * 4 + rows * 2 * 4) / PEAK_BYTES_PER_S * 1e3
    op_ms = rows * features * (2 * features + 4 * 2 + 3) / PEAK_FP32_OPS_PER_S * 1e3
    embedded, _, _ = call()
    if embedded.shape != (rows, 2) or not bool(torch.isfinite(embedded).all()):
        raise AssertionError(f"pca: an embedding of shape {tuple(embedded.shape)}, or not finite")
    return {
        "rows": rows, "features": features,
        "ms": _event_ms(torch, call, 10, flush),
        "warm_ms": _event_ms(torch, call, 10),
        "bound_ms": max(byte_ms, op_ms),
        "bound_by": "bytes" if byte_ms >= op_ms else "operations",
    }


def knn_agreement(embedded: np.ndarray, labels: np.ndarray, sample: int, seed: int = 0) -> float:
    """The share of the k = 10 nearest neighbours (in the embedding, among
    ``sample`` rows drawn with ``seed``) that carry the row's label."""
    rows = len(embedded)
    chosen = np.random.default_rng(seed).choice(rows, size=min(sample, rows), replace=False)
    points = np.asarray(embedded, np.float64)[chosen]
    norms = (points * points).sum(axis=1)
    distances = norms[:, None] + norms[None, :] - 2.0 * points @ points.T
    np.fill_diagonal(distances, np.inf)
    nearest = np.argpartition(distances, QUALITY_K, axis=1)[:, :QUALITY_K]
    picked = labels[chosen]
    return float((picked[nearest] == picked[:, None]).mean())


def kl_divergence(torch, P, Y, block: int = 2_048) -> float:
    """t-SNE's objective: KL(P || Q) over the pairs i != j, where
    Q = (1 + |y_i - y_j|^2)^-1 / Z, in float64 on P's device, a block of
    rows at a time."""
    Y = torch.as_tensor(Y).to(P.device, torch.float64)
    n = Y.shape[0]
    norms = (Y * Y).sum(dim=1)

    def inverse(start):
        stop = min(start + block, n)
        d = norms[start:stop, None] + norms[None, :] - 2.0 * (Y[start:stop] @ Y.T)
        inv = 1.0 / (1.0 + d.clamp_min_(0.0))
        inv[torch.arange(stop - start), torch.arange(start, stop)] = 0.0
        return inv

    Z = sum(inverse(start).sum() for start in range(0, n, block))
    total = torch.zeros((), dtype=torch.float64, device=P.device)
    for start in range(0, n, block):
        stop = min(start + block, n)
        p = P[start:stop].double()
        terms = p * (torch.log(p) - torch.log(inverse(start) / Z))
        terms[torch.arange(stop - start), torch.arange(start, stop)] = 0.0
        total += terms.sum()
    return float(total)


def _read_png_header(data: bytes) -> tuple[int, int]:
    if data[:8] != b"\x89PNG\r\n\x1a\n" or data[12:16] != b"IHDR":
        raise AssertionError("the image is not a PNG")
    width, height = struct.unpack(">II", data[16:24])
    return width, height


def _kl_held(torch, X, perplexity, fit, plain_fit, what: str) -> dict:
    """KL(P || Q) of a fit and of the plain versions' fit on the same P
    (the plain version's); raises if they differ by more than KL_MARGIN
    of the plain fit's."""
    P = tsne._affinities(X, tsne._clamped_perplexity(perplexity, X.shape[0]))
    kl = {"kernels": kl_divergence(torch, P, fit), "plain": kl_divergence(torch, P, plain_fit)}
    kl["rel_diff"] = abs(kl["kernels"] - kl["plain"]) / kl["plain"]
    kl["margin"] = KL_MARGIN
    if not kl["rel_diff"] <= KL_MARGIN:
        raise AssertionError(f"{what}: KL(P || Q) of the kernels' fit and the plain fit differ: {kl}")
    return kl


def phase_embed(torch, card: str, store, labels_by_name: dict, setup_s: float) -> dict:
    """The image lane end to end: the port's tsne and pca services over
    real HTTP on ``store``, PNGs read back, the kernels' launches per
    request, each request's t-SNE fits and interpolation held against the
    plain versions on the same inputs, the embeddings' quality, and
    bit-identical refits."""
    from learningorchestra_tpu_torch.core.devcache import dataset_embedding_inputs
    from learningorchestra_tpu_torch.ops import images as image_ops
    from learningorchestra_tpu_torch.services import images as image_services

    started = time.perf_counter()
    captured, fits, interpolations = {}, {}, {}
    real_scatter, real_exact, real_interpolate = image_ops._scatter_png, tsne._tsne_exact, tsne.interpolate
    current = [None]

    # the requests' own fits and interpolation, with their inputs, for the
    # checks below (the kernels' launches are read before the checks)
    def scatter(embedded, hue, image_path):
        captured[os.path.basename(image_path)] = embedded
        real_scatter(embedded, hue, image_path)

    def exact(X, perplexity, iterations, learning_rate, Y0, mesh=None):
        Y = real_exact(X, perplexity, iterations, learning_rate, Y0, mesh)
        fits[current[0]] = (X, perplexity, iterations, learning_rate, Y0, Y)
        return Y

    def interpolate(X, landmarks, Y_landmarks, perplexity):
        out = real_interpolate(X, landmarks, Y_landmarks, perplexity)
        interpolations.setdefault(current[0], []).append((X, landmarks, Y_landmarks, perplexity, out))
        return out

    requests = (
        ("pca", "blobs_1m", "pca_1m"),
        ("tsne", "blobs_1m", "tsne_1m"),    # auto: landmark
        ("tsne", "blobs_20k", "tsne_20k"),  # auto: exact
    )
    expected_launches = {
        "pca_1m": dict.fromkeys(TSNE_KERNELS, 0),
        "tsne_1m": {"tsne_affinities": 1, "tsne_z": tsne.ITERATIONS, "tsne_grad": tsne.ITERATIONS,
                    "tsne_interpolate": 1},
        "tsne_20k": {"tsne_affinities": 1, "tsne_z": tsne.ITERATIONS, "tsne_grad": tsne.ITERATIONS,
                     "tsne_interpolate": 0},
    }
    answers = {}
    image_ops._scatter_png, tsne._tsne_exact, tsne.interpolate = scatter, exact, interpolate
    try:
        with tempfile.TemporaryDirectory() as images_dir:
            servers = {
                method: ServerThread(image_services.create_app(store, images_dir, method)).start()
                for method in ("pca", "tsne")
            }
            try:
                for method, parent, name in requests:
                    client = _Client(servers[method].port)
                    current[0] = name
                    torch.cuda.synchronize()
                    kernels.reset_launches()
                    began = time.perf_counter()
                    status, body = client.call(
                        "POST", f"/images/{parent}",
                        {f"{method}_filename": name, "label_name": "label"},
                    )
                    wall_s = time.perf_counter() - began
                    launches = {k: kernels.launches()[k] for k in TSNE_KERNELS}
                    if (status, body) != (201, {"result": "created_file"}):
                        raise AssertionError(f"POST {name}: {status} {body}")
                    if launches != expected_launches[name]:
                        raise AssertionError(
                            f"{name}: launches {launches}, expected {expected_launches[name]}"
                        )
                    with client.opener.open(f"{client.base}/images/{name}", timeout=120) as response:
                        png = response.read()
                        kind = response.headers["Content-Type"]
                    if kind != "image/png" or _read_png_header(png) != (image_ops.WIDTH, image_ops.HEIGHT):
                        raise AssertionError(f"GET {name}: {kind}, {_read_png_header(png)}")
                    answers[name] = {
                        "method": method, "rows": len(labels_by_name[parent]), "wall_s": wall_s,
                        "launches": launches, "png_bytes": len(png),
                    }
                status, body = _Client(servers["tsne"].port).call("GET", "/images")
                if status != 200 or sorted(body["result"]) != sorted(f"{n}.png" for _, _, n in requests):
                    raise AssertionError(f"GET /images: {status} {body}")
            finally:
                for server in servers.values():
                    server.stop()
    finally:
        image_ops._scatter_png, tsne._tsne_exact, tsne.interpolate = real_scatter, real_exact, real_interpolate

    # the embeddings: shape, finiteness, k = 10 label agreement
    for _, parent, name in requests:
        embedded = captured[f"{name}.png"]
        if embedded.shape != (len(labels_by_name[parent]), 2) or not np.isfinite(embedded).all():
            raise AssertionError(f"{name}: an embedding of shape {embedded.shape}, or not finite")
        answers[name]["knn_agreement"] = knn_agreement(embedded, labels_by_name[parent], QUALITY_SAMPLE)

    # each request's exact fit (the 20,000 rows; the 1,000,000 rows'
    # 5,000 landmarks) against the plain versions' fit from the same X and
    # Y0, by KL(P || Q); the landmark request's interpolation against the
    # plain version on the same rows, landmarks and fitted embedding
    if sorted(fits) != ["tsne_1m", "tsne_20k"] or sorted(interpolations) != ["tsne_1m"]:
        raise AssertionError(f"captured fits {sorted(fits)}, interpolations {sorted(interpolations)}")
    for name, (X, perplexity, iterations, learning_rate, Y0, Y) in fits.items():
        began = time.perf_counter()
        with _plain_tsne():
            plain_fit = real_exact(X, perplexity, iterations, learning_rate, Y0)
        answers[name]["fit_rows"] = X.shape[0]
        answers[name]["kl"] = _kl_held(torch, X, perplexity, Y, plain_fit, f"{name}'s fit")
        answers[name]["kl"]["plain_fit_s"] = time.perf_counter() - began
        del plain_fit
        torch.cuda.empty_cache()
    (X, L, Y_L, perplexity, out), = interpolations["tsne_1m"]
    if X.shape[0] != EMBED_ROWS or L.shape[0] != tsne.LANDMARKS or Y_L is not fits["tsne_1m"][5]:
        raise AssertionError("the landmark request interpolated other inputs than its own")
    difference = float((out - tsne._interpolate(X, L, Y_L, perplexity)).abs().max())
    answers["tsne_1m"]["interpolation"] = {
        "abs_err": difference, "rel_err": difference / float(Y_L.abs().max()), "tolerance": K13_TOL,
    }
    if not answers["tsne_1m"]["interpolation"]["rel_err"] <= K13_TOL:
        raise AssertionError(f"tsne_1m's interpolation: {answers['tsne_1m']['interpolation']}")
    del fits, interpolations, X, L, Y_L, out
    torch.cuda.empty_cache()

    # the same exact fit at 2,048 rows, by the kernels and by the plain
    # versions, from the same Y0; and two embeddings the KL gate must
    # refuse: the kernels' fit stopped at half its iterations, and the PCA
    # projection scaled to the fit's spread
    _, _, X_exact = dataset_embedding_inputs(store, "blobs_20k")
    X_small = X_exact[:QUALITY_ROWS].contiguous()
    labels_small = labels_by_name["blobs_20k"][:QUALITY_ROWS]
    Y0 = tsne._initial_embedding(QUALITY_ROWS, 0, X_small.device)
    kernel_fit = tsne._tsne_exact(X_small, tsne.PERPLEXITY, tsne.ITERATIONS, tsne.LEARNING_RATE, Y0)
    with _plain_tsne():
        plain_fit = tsne._tsne_exact(X_small, tsne.PERPLEXITY, tsne.ITERATIONS, tsne.LEARNING_RATE, Y0)
    quality = {
        "rows": QUALITY_ROWS,
        "kernels": knn_agreement(kernel_fit.cpu().numpy(), labels_small, QUALITY_SAMPLE),
        "plain": knn_agreement(plain_fit.cpu().numpy(), labels_small, QUALITY_SAMPLE),
        "margin": QUALITY_MARGIN,
        "kl": _kl_held(torch, X_small, tsne.PERPLEXITY, kernel_fit, plain_fit, "the 2,048-row fit"),
    }
    if abs(quality["kernels"] - quality["plain"]) > QUALITY_MARGIN:
        raise AssertionError(f"the kernels' fit and the plain fit differ in quality: {quality}")
    for name in ("tsne_1m", "tsne_20k"):
        if answers[name]["knn_agreement"] < quality["plain"] - QUALITY_MARGIN:
            raise AssertionError(f"{name}: quality {answers[name]['knn_agreement']} below {quality}")
    half_fit = tsne._tsne_exact(X_small, tsne.PERPLEXITY, tsne.ITERATIONS // 2, tsne.LEARNING_RATE, Y0)
    projected = torch.from_numpy(pca.pca_embedding(X_small, device=X_small.device)).to(X_small.device)
    projected *= (kernel_fit.square().sum(dim=1).mean() / projected.square().sum(dim=1).mean()).sqrt()
    P_small = tsne._affinities(X_small, tsne.PERPLEXITY)
    quality["kl_controls"] = {}
    for control, embedded in (("half_iterations", half_fit), ("pca_scaled", projected)):
        kl = kl_divergence(torch, P_small, embedded)
        quality["kl_controls"][control] = kl
        if abs(kl - quality["kl"]["plain"]) <= KL_MARGIN * quality["kl"]["plain"]:
            raise AssertionError(f"the KL gate takes {control} ({kl}) for a fit: {quality['kl']}")

    # refits from the same seed, through the same reads
    refits = {}
    for parent, name in (("blobs_20k", "tsne_20k"), ("blobs_1m", "tsne_1m")):
        _, _, X = dataset_embedding_inputs(store, parent)
        began = time.perf_counter()
        again = tsne.tsne_embedding(X, device=X.device)
        refits[name] = {"seconds": time.perf_counter() - began,
                        "identical": bool(np.array_equal(again, captured[f"{name}.png"]))}
        if not refits[name]["identical"]:
            raise AssertionError(f"{name}: a refit from the same seed differs")
    launches_total = {
        kernel: sum(answer["launches"][kernel] for answer in answers.values()) for kernel in TSNE_KERNELS
    }
    record = {
        "phase": "embed", "setup_s": setup_s, "requests": answers,
        "quality": quality, "refits": refits, "launches": launches_total, "nvidia_smi": card,
        "seconds": time.perf_counter() - started,
    }
    emit(record)
    return record


# --------------------------------------------------------------------------
# Sweeps and job coalescing: the fused programs (K14) over the job axis of
# K7, K1, K2, K4, K5 and K6
# --------------------------------------------------------------------------

SWEEP_SOURCE = "learningorchestra_tpu_torch/ml/sweep.py"
# job-axis rows of the kernels line: (kernel counter, source, what it replaces)
JOB_KERNELS = {
    "logistic_loss_grad:jobs": (
        "logistic_loss_grad", LOGISTIC_SOURCE,
        "learningorchestra_tpu/ml/logistic.py:35 _loss_fn (masked) under value_and_grad, "
        "vmapped in learningorchestra_tpu/ml/sweep.py:237 _lr_fused_segment",
    ),
    "logistic_trial_losses:jobs": (
        "logistic_trial_losses", LOGISTIC_SOURCE,
        "learningorchestra_tpu/ml/logistic.py:35 _loss_fn (masked) in the Armijo loop, "
        "vmapped in learningorchestra_tpu/ml/sweep.py:237 _lr_fused_segment",
    ),
    "apply_bins:jobs": (
        "apply_bins", FIT_SOURCE,
        "learningorchestra_tpu/ml/binning.py:37 apply_bins, vmapped in "
        "learningorchestra_tpu/ml/sweep.py:263 _dt_fused",
    ),
    "level_histograms:jobs": (
        "level_histograms", FIT_SOURCE,
        "learningorchestra_tpu/ml/trees.py:66 _level_histograms, vmapped in "
        "learningorchestra_tpu/ml/sweep.py:263 _dt_fused",
    ),
    "select_splits:jobs": (
        "select_splits", FIT_SOURCE,
        "learningorchestra_tpu/ml/trees.py:160 _gini_gain and :196 _select_splits, vmapped in "
        "learningorchestra_tpu/ml/sweep.py:263 _dt_fused",
    ),
    "route:jobs": (
        "route", FIT_SOURCE,
        "learningorchestra_tpu/ml/trees.py:235 _route, vmapped in "
        "learningorchestra_tpu/ml/sweep.py:263 _dt_fused",
    ),
    "leaf_sums:jobs": (
        "leaf_sums", FIT_SOURCE,
        "learningorchestra_tpu/ml/trees.py:142 _leaf_sums, vmapped in "
        "learningorchestra_tpu/ml/sweep.py:263 _dt_fused",
    ),
    "tree_ensemble_forward:jobs": (
        "tree_ensemble_forward", KERNEL_SOURCE,
        "learningorchestra_tpu/ml/trees.py:303 _descend under :364 _ensemble_forward, "
        "vmapped in learningorchestra_tpu/ml/sweep.py:263 _dt_fused",
    ),
}
PROGRAM_REPLACES = {
    "lr_fused_segment": "learningorchestra_tpu/ml/sweep.py:237 _lr_fused_segment",
    "lr_fused_eval": "learningorchestra_tpu/ml/sweep.py:249 _lr_fused_eval",
    "dt_fused": "learningorchestra_tpu/ml/sweep.py:263 _dt_fused",
}
SWEEP_ROWS = FIT_ROWS          # bench.py's synthetic rows, seed 0
SWEEP_EVAL_ROWS = 200_000      # an eval draw of the same data, seed 1
SWEEP_POINTS = 100             # bench.py's sweep_100 grid: linspace(0, 1, 100)
SWEEP_MAX_ITER = 25            # bench.py's max_iter
SWEEP_DEPTHS = (2, 5, 8)
JOB_CHECK_JOBS = 8             # jobs of the per-job kernel checks
BIT_ROWS = FIT_ROWS            # rows of each bit-identity member
FLOOD_JOBS, FLOOD_ROWS = 64, 1024   # bench.py's coalesce flood
FLOOD_WINDOW_S = 0.010


@contextlib.contextmanager
def _plain_sweep():
    """Within the block, the fused programs run the plain versions of
    every job-axis kernel (K7's twins, K1, the level loop, K6), on any
    device. Raises if a kernel launched."""
    from learningorchestra_tpu_torch.ml import sweep

    with _plain(logistic, {
        "job_loss_and_grad": logistic._job_loss_fn,
        "job_trial_losses": logistic._job_trial_losses,
    }), _plain(sweep, {
        "apply_bins": binning._apply_bins,
        "job_apply_bins": binning._job_apply_bins,
    }), _plain(trees, {"job_ensemble_forward": trees._job_ensemble_forward}), _plain_level_loop():
        yield


def _outcome(outcomes):
    (status, value), = outcomes
    if status != "ok":
        raise AssertionError(f"a sweep member failed: {value!r}")
    return value


def _job_bound(name: str, rows: int, jobs: int, *, features: int = FEATURES, classes: int = CLASSES,
               x_shared: bool = False, weighted: bool = True, n_nodes: int = 1,
               bins_read: int = 0, depth: int = 0, bins_shared: bool = False) -> tuple[float, str]:
    """Least milliseconds for one job-axis call: each input read once
    (a shared X once, not once a job; K2's bins once when the jobs share
    them) and each output written once over HBM bandwidth, against its
    operations at their type's peak."""
    F, C, J, B = features, classes, jobs, MAX_BINS
    x_bytes = rows * F * 4 * (1 if x_shared else J)
    row_bytes = rows * (4 + (4 if weighted else 0)) * (1 if x_shared else J)
    fp64_ops = 0
    if name in ("logistic_loss_grad", "logistic_trial_losses"):
        trial = name == "logistic_trial_losses"
        candidates = 4 if trial else 1
        bytes_moved = x_bytes + row_bytes + J * candidates * (F * C + C) * 4 * 2
        fp32_ops = J * rows * candidates * (2 * F * C + 4 * C)
        fp64_ops = 0 if trial else J * rows * (2 * F * C + 2 * C + 2)
    elif name == "apply_bins":       # X, thresholds -> int8 bins; a 5-step search
        bytes_moved = x_bytes + J * F * (B - 1) * 4 + J * rows * F
        fp32_ops = J * rows * F * int(np.ceil(np.log2(B)))
    elif name == "level_histograms":  # each job's bins (or shared ones), node, channels -> histogram
        bytes_moved = rows * F * (1 if bins_shared else J) + J * (rows * 4 + rows * C * 4 + n_nodes * F * B * C * 4)
        fp32_ops = J * rows * F * C
    elif name == "route":            # node, a bin per split row, split -> node
        bytes_moved = J * (rows * 4 * 2 + n_nodes * 8) + bins_read
        fp32_ops = J * rows * 2
    elif name == "leaf_sums":
        bytes_moved = J * (rows * 4 + rows * C * 4 + n_nodes * C * 4)
        fp32_ops = J * rows * C
    elif name == "select_splits":
        bytes_moved = J * n_nodes * (F * B * C * 4 + 8)
        fp32_ops = J * n_nodes * F * B * (5 * C + 5)
    else:                            # tree_ensemble_forward: X, one tree a job -> probs
        nodes, leaves = 2**depth - 1, 2**depth
        bytes_moved = x_bytes + J * (nodes * 8 + leaves * C * 4) + J * rows * C * 4
        fp32_ops = J * rows * (depth + C)
    byte_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
    op_ms = (fp32_ops / PEAK_FP32_OPS_PER_S + fp64_ops / PEAK_FP64_OPS_PER_S) * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def _bit_equal_per_job(name: str, got, alone) -> None:
    """Raise unless job j of ``got`` equals ``alone(j)``, the same launch
    over job j alone, bit for bit."""
    import torch

    for j in range(got[0].shape[0]):
        for part, single in zip(got, alone(j)):
            if not torch.equal(part[j], single[0]):
                raise AssertionError(f"{name}: job {j} differs from a launch of that job alone")


K7_GROUP_JOBS = (1, 7, 112, 113)   # shared-X jobs: narrow groups, one wide group, and past it


def _job_rows_of(X, y, weights, j: int):
    """Job j's rows, labels and weights as a one-job launch takes them."""
    if X.dim() == 2:
        return X, y, weights
    return X[j:j + 1], y[j:j + 1], None if weights is None else weights[j:j + 1]


def check_k7_groups(torch, X_std, y_dev, mask) -> dict:
    """K7 over a job axis in each geometry its wrappers choose
    (``logistic._k7_geometry``), against its plain twins at K7_LOSS_RTOL
    and K7_GRAD_ATOL: jobs sharing the sweep's X in groups of 1, 7, 112 and
    113, and the flood's 64 stacked jobs of 1,024 rows (each its own data,
    its last 100 rows weighing 0), weighted and not, 2 and 10 classes.
    Each job bit-equal to a launch of it alone, a second launch bit
    identical. Returns the largest differences from the plain twins."""
    device = X_std.device
    rng = np.random.default_rng(62)
    boundaries = torch.linspace(-1.5, 1.5, DEEP_CLASSES - 1, device=device)

    def ten(X):
        return torch.bucketize(X[..., 0].contiguous(), boundaries).to(torch.int32)

    flood = [bench_synthetic(FLOOD_ROWS, seed=100 + i) for i in range(FLOOD_JOBS)]
    flood_X = torch.from_numpy(np.stack([
        logistic._standardized(X, *logistic.scaler_stats(X)) for X, _ in flood
    ])).to(device)
    flood_y = torch.from_numpy(np.stack([y for _, y in flood]).astype(np.int32)).to(device)
    flood_mask = torch.ones((FLOOD_JOBS, FLOOD_ROWS), dtype=torch.float32, device=device)
    flood_mask[:, -100:] = 0.0
    labels = {(CLASSES, 2): y_dev, (DEEP_CLASSES, 2): ten(X_std),
              (CLASSES, 3): flood_y, (DEEP_CLASSES, 3): ten(flood_X)}
    steps = torch.tensor([1.0, 0.5, 0.25, 0.125], device=device)
    errors = {"logistic_loss_grad:jobs": 0.0, "logistic_trial_losses:jobs": 0.0}
    cases = [(jobs, X_std, mask) for jobs in K7_GROUP_JOBS] + [(FLOOD_JOBS, flood_X, flood_mask)]
    for classes in (CLASSES, DEEP_CLASSES):
        for jobs, X, all_weights in cases:
            y = labels[classes, X.dim()]
            for weights in (all_weights, None):
                what = (f"{jobs} jobs, {'shared' if X.dim() == 2 else 'stacked'} X, {classes} classes, "
                        f"{'weighted' if weights is not None else 'unweighted'}")

                def on_card(*shape):
                    return torch.from_numpy((rng.normal(size=shape) * 0.3).astype(np.float32)).to(device)

                W, b = on_card(jobs, FEATURES, classes), on_card(jobs, classes)
                D, d = on_card(jobs, FEATURES, classes), on_card(jobs, classes)
                W4 = (W[:, None] + steps[None, :, None, None] * D[:, None]).contiguous()
                b4 = (b[:, None] + steps[None, :, None] * d[:, None]).contiguous()
                l2s = torch.from_numpy(rng.uniform(0.0, 1.0, jobs).astype(np.float32)).to(device)
                got = logistic.job_loss_and_grad(W, b, X, y, weights, l2s)
                again = logistic.job_loss_and_grad(W, b, X, y, weights, l2s)
                if not all(torch.equal(first, second) for first, second in zip(got, again)):
                    raise AssertionError(f"logistic_loss_grad:jobs ({what}): a second launch differs")
                _bit_equal_per_job(f"logistic_loss_grad:jobs ({what})", got, lambda j: logistic.job_loss_and_grad(
                    W[j:j + 1], b[j:j + 1], *_job_rows_of(X, y, weights, j), l2s[j:j + 1]))
                want = logistic._job_loss_fn(W, b, X, y, weights, l2s)
                loss_rel = float(((got[0] - want[0]).abs() / want[0].abs()).max())
                grad_err = max(float((got[i] - want[i]).abs().max()) for i in (1, 2))
                if not loss_rel <= K7_LOSS_RTOL or not grad_err <= K7_GRAD_ATOL:
                    raise AssertionError(
                        f"logistic_loss_grad:jobs ({what}): loss {loss_rel} relative, gradient {grad_err}")
                errors["logistic_loss_grad:jobs"] = max(
                    errors["logistic_loss_grad:jobs"], grad_err, float((got[0] - want[0]).abs().max()))
                trial = logistic.job_trial_losses(W4, b4, X, y, weights, l2s)
                if not torch.equal(trial, logistic.job_trial_losses(W4, b4, X, y, weights, l2s)):
                    raise AssertionError(f"logistic_trial_losses:jobs ({what}): a second launch differs")
                _bit_equal_per_job(f"logistic_trial_losses:jobs ({what})", (trial,), lambda j: (
                    logistic.job_trial_losses(W4[j:j + 1], b4[j:j + 1], *_job_rows_of(X, y, weights, j),
                                              l2s[j:j + 1]),))
                plain_trial = logistic._job_trial_losses(W4, b4, X, y, weights, l2s)
                trial_rel = float(((trial - plain_trial).abs() / plain_trial.abs()).max())
                if not trial_rel <= K7_LOSS_RTOL:
                    raise AssertionError(f"logistic_trial_losses:jobs ({what}): {trial_rel} relative")
                errors["logistic_trial_losses:jobs"] = max(
                    errors["logistic_trial_losses:jobs"], float((trial - plain_trial).abs().max()))
    return errors


def check_job_kernels(torch, X_std, y_dev, mask, X_raw, thresholds, X_eval) -> dict:
    """K7, K1, K2 (each job's own bins), K3, K4, K5 and K6 over JOB_CHECK_JOBS
    jobs, each job its own rows (the main rows rolled a job apart, so
    every job has its own padded rows), parameters and λ: each job's
    output bit-equal to a launch over that job alone, and within the
    existing tolerances of the plain version. Returns each kernel's
    largest difference from its plain version."""
    J, rows = JOB_CHECK_JOBS, X_std.shape[0]
    rng = np.random.default_rng(60)
    shifts = [j * (rows // J + 12_345) for j in range(J)]

    def rolled(tensor):
        return torch.stack([torch.roll(tensor, s, dims=0) for s in shifts])

    Xs, ys, ms, Xr = rolled(X_std), rolled(y_dev), rolled(mask), rolled(X_raw)
    device = X_std.device

    def on_card(array):
        return torch.from_numpy(np.ascontiguousarray(array)).to(device)

    errors = {}
    W = on_card((rng.normal(size=(J, FEATURES, CLASSES)) * 0.3).astype(np.float32))
    b = on_card((rng.normal(size=(J, CLASSES)) * 0.3).astype(np.float32))
    D = on_card((rng.normal(size=(J, FEATURES, CLASSES)) * 0.3).astype(np.float32))
    d = on_card((rng.normal(size=(J, CLASSES)) * 0.3).astype(np.float32))
    l2s = on_card(np.array([0.0, 0.1, 0.01, 0.5, 0.0, 0.2, 0.05, 1.0][:J], np.float32))
    steps = torch.tensor([1.0, 0.5, 0.25, 0.125], device=device)
    W4 = (W[:, None] + steps[None, :, None, None] * D[:, None]).contiguous()
    b4 = (b[:, None] + steps[None, :, None] * d[:, None]).contiguous()
    got = logistic.job_loss_and_grad(W, b, Xs, ys, ms, l2s)
    _bit_equal_per_job("logistic_loss_grad:jobs", got, lambda j: logistic.job_loss_and_grad(
        W[j:j + 1], b[j:j + 1], Xs[j:j + 1], ys[j:j + 1], ms[j:j + 1], l2s[j:j + 1]))
    want = logistic._job_loss_fn(W, b, Xs, ys, ms, l2s)
    loss_rel = float(((got[0] - want[0]).abs() / want[0].abs()).max())
    grad_err = max(float((got[i] - want[i]).abs().max()) for i in (1, 2))
    if not loss_rel <= K7_LOSS_RTOL or not grad_err <= K7_GRAD_ATOL:
        raise AssertionError(f"logistic_loss_grad:jobs: loss {loss_rel} relative, gradient {grad_err}")
    errors["logistic_loss_grad:jobs"] = max(grad_err, float((got[0] - want[0]).abs().max()))
    trial = logistic.job_trial_losses(W4, b4, Xs, ys, ms, l2s)
    _bit_equal_per_job("logistic_trial_losses:jobs", (trial,), lambda j: (logistic.job_trial_losses(
        W4[j:j + 1], b4[j:j + 1], Xs[j:j + 1], ys[j:j + 1], ms[j:j + 1], l2s[j:j + 1]),))
    plain_trial = logistic._job_trial_losses(W4, b4, Xs, ys, ms, l2s)
    trial_rel = float(((trial - plain_trial).abs() / plain_trial.abs()).max())
    if not trial_rel <= K7_LOSS_RTOL:
        raise AssertionError(f"logistic_trial_losses:jobs: {trial_rel} relative")
    errors["logistic_trial_losses:jobs"] = float((trial - plain_trial).abs().max())
    for name, error in check_k7_groups(torch, X_std, y_dev, mask).items():
        errors[name] = max(errors[name], error)

    # each job its own thresholds: the main ones stretched a little a job
    ths = torch.stack([thresholds * (1.0 + 1e-3 * j) for j in range(J)]).contiguous()
    bins = binning.job_apply_bins(Xr, ths)
    _bit_equal_per_job("apply_bins:jobs", (bins,), lambda j: (binning.job_apply_bins(Xr[j:j + 1], ths[j:j + 1]),))
    if not torch.equal(bins, binning._job_apply_bins(Xr, ths)):
        raise AssertionError("apply_bins:jobs: bins differ from the plain version")
    errors["apply_bins:jobs"] = 0.0

    n_nodes, n_leaves = 16, 2**DEPTH
    node = on_card(rng.integers(0, n_nodes, (J, rows)).astype(np.int32))
    channels = (torch.nn.functional.one_hot(ys.long(), CLASSES).to(torch.float32) * ms[..., None]).contiguous()
    hist = trees.level_histograms(bins, node, channels, n_nodes, MAX_BINS, integer=True)
    _bit_equal_per_job("level_histograms:jobs", (hist,), lambda j: (trees.level_histograms(
        bins[j:j + 1], node[j:j + 1], channels[j:j + 1], n_nodes, MAX_BINS, integer=True),))
    if not torch.equal(hist, trees._level_histograms(bins, node, channels, n_nodes, MAX_BINS)):
        raise AssertionError("level_histograms:jobs: class counts differ from the plain version")
    errors["level_histograms:jobs"] = 0.0
    chosen = trees.select_splits(hist, "gini")
    _bit_equal_per_job("select_splits:jobs", chosen, lambda j: trees.select_splits(hist[j:j + 1], "gini"))
    plain_chosen = trees._select_plain(hist, "gini")
    if not all(torch.equal(a, c) for a, c in zip(chosen, plain_chosen)):
        raise AssertionError("select_splits:jobs: splits differ from the plain version")
    errors["select_splits:jobs"] = 0.0
    feature = on_card(rng.integers(-1, FEATURES, (J, n_nodes)).astype(np.int32))
    split = on_card(rng.integers(0, MAX_BINS, (J, n_nodes)).astype(np.int32))
    routed = trees.route(bins, node, feature, split)
    _bit_equal_per_job("route:jobs", (routed,), lambda j: (trees.route(
        bins[j:j + 1], node[j:j + 1], feature[j:j + 1], split[j:j + 1]),))
    if not torch.equal(routed, trees._route(bins, node, feature, split)):
        raise AssertionError("route:jobs: nodes differ from the plain version")
    errors["route:jobs"] = 0.0
    leaf = on_card(rng.integers(0, n_leaves, (J, rows)).astype(np.int32))
    sums = trees.leaf_sums(leaf, channels, n_leaves)
    _bit_equal_per_job("leaf_sums:jobs", (sums,), lambda j: (trees.leaf_sums(
        leaf[j:j + 1], channels[j:j + 1], n_leaves),))
    if not torch.equal(sums, trees._leaf_sums(leaf, channels, n_leaves)):
        raise AssertionError("leaf_sums:jobs: class counts differ from the plain version")
    # the sweep's call: the counts path (0/1 masks times one-hots)
    counted = trees.leaf_sums(leaf, channels, n_leaves, integer=True)
    _bit_equal_per_job("leaf_sums:jobs (counts)", (counted,), lambda j: (trees.leaf_sums(
        leaf[j:j + 1], channels[j:j + 1], n_leaves, integer=True),))
    if not torch.equal(counted, sums):
        raise AssertionError("leaf_sums:jobs: the counts path's counts differ")
    errors["leaf_sums:jobs"] = 0.0

    thresholds_np = thresholds.cpu().numpy()
    heaps = [_heaps(rng, thresholds_np, 1, DEPTH) for _ in range(J)]
    fh = on_card(np.stack([h[0] for h in heaps]))
    th = on_card(np.stack([h[1] for h in heaps]))
    lp = on_card(rng.dirichlet(np.ones(CLASSES), size=(J, 1, n_leaves)).astype(np.float32))
    Xe = torch.stack([torch.roll(X_eval, s, dims=0) for s in shifts])
    probs = trees.job_ensemble_forward(Xe, fh, th, lp, DEPTH)
    _bit_equal_per_job("tree_ensemble_forward:jobs", (probs,), lambda j: (trees.job_ensemble_forward(
        Xe[j:j + 1], fh[j:j + 1], th[j:j + 1], lp[j:j + 1], DEPTH),))
    plain = trees._job_ensemble_forward(Xe, fh, th, lp, DEPTH)
    error = float((probs - plain).abs().max())
    if error > TREE_TOL or not torch.equal(probs.argmax(2), plain.argmax(2)):
        raise AssertionError(f"tree_ensemble_forward:jobs: {error} from the plain version")
    errors["tree_ensemble_forward:jobs"] = error
    return errors


def time_job_kernels(torch, X_std, y_dev, mask, X_raw, thresholds, X_eval, flush) -> dict:
    """Each job-axis kernel at the main path's shapes, cold (L2
    overwritten before each call), beside its bound and its plain
    version: K7 over the λ sweep's 112 slots of 1,048,576 rows, one shared
    X, weighted; K1, K2, K3, K4, K5 and K6 over the depth sweep's 8 slots,
    one shared X (K2, K4: each slot's own bins, a 16-node level; K3 on K2's
    16-node histograms; K5: 256
    leaves; K6: depth 8 on the shared eval rows)."""
    from learningorchestra_tpu_torch.ml import sweep

    rows, device = X_std.shape[0], X_std.device
    jobs_lr = sweep._job_axis(SWEEP_POINTS)
    rng = np.random.default_rng(61)

    def on_card(array):
        return torch.from_numpy(np.ascontiguousarray(array)).to(device)

    # CUDA events only: in a process that ran the other phases first, the
    # profiler's trace read these kernels at a fifth of their event times,
    # below what the bytes allow (PERF.md section 7)
    def timed(name, kernel, plain, bound, library=None):
        bound_ms, bound_by = bound
        return {
            "ms": _event_ms(torch, kernel, 5, flush),
            "plain_ms": _event_ms(torch, plain, 1, flush),
            "library_ms": None if library is None else _event_ms(torch, library, 3, flush),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
        }

    W = on_card((rng.normal(size=(jobs_lr, FEATURES, CLASSES)) * 0.3).astype(np.float32))
    b = on_card((rng.normal(size=(jobs_lr, CLASSES)) * 0.3).astype(np.float32))
    W4 = on_card((rng.normal(size=(jobs_lr, 4, FEATURES, CLASSES)) * 0.3).astype(np.float32))
    b4 = on_card((rng.normal(size=(jobs_lr, 4, CLASSES)) * 0.3).astype(np.float32))
    l2s = on_card(np.linspace(0.0, 1.0, jobs_lr).astype(np.float32))
    results = {
        "logistic_loss_grad:jobs": timed(
            "logistic_loss_grad:jobs",
            lambda: logistic.job_loss_and_grad(W, b, X_std, y_dev, mask, l2s),
            lambda: logistic._job_loss_fn(W, b, X_std, y_dev, mask, l2s),
            _job_bound("logistic_loss_grad", rows, jobs_lr, x_shared=True),
        ),
        "logistic_trial_losses:jobs": timed(
            "logistic_trial_losses:jobs",
            lambda: logistic.job_trial_losses(W4, b4, X_std, y_dev, mask, l2s),
            lambda: logistic._job_trial_losses(W4, b4, X_std, y_dev, mask, l2s),
            _job_bound("logistic_trial_losses", rows, jobs_lr, x_shared=True),
        ),
    }
    for name, result in results.items():
        result.update(jobs=jobs_lr, rows=rows, x_shared=True, geometry=logistic._k7_geometry(
            FEATURES, CLASSES, jobs_lr, True, trial=name == "logistic_trial_losses:jobs", weighted=True))
    J = sweep._job_axis(1)
    ths = torch.stack([thresholds * (1.0 + 1e-3 * j) for j in range(J)]).contiguous()
    bins = binning.job_apply_bins(X_raw, ths)
    n_nodes, n_leaves, depth = 16, 2 ** max(SWEEP_DEPTHS), max(SWEEP_DEPTHS)
    y_jobs = y_dev[None].expand(J, rows)
    channels = (torch.nn.functional.one_hot(y_jobs.long(), CLASSES).to(torch.float32) * mask[None, :, None]).contiguous()
    node = on_card(rng.integers(0, n_nodes, (J, rows)).astype(np.int32))
    feature = on_card(rng.integers(-1, FEATURES, (J, n_nodes)).astype(np.int32))
    split = on_card(rng.integers(0, MAX_BINS, (J, n_nodes)).astype(np.int32))
    leaf = on_card(rng.integers(0, n_leaves, (J, rows)).astype(np.int32))
    bins_read = int((feature.long().gather(1, node.long()) >= 0).sum())
    thresholds_np = thresholds.cpu().numpy()
    heaps = [_heaps(rng, thresholds_np, 1, depth) for _ in range(J)]
    fh = on_card(np.stack([h[0] for h in heaps]))
    th = on_card(np.stack([h[1] for h in heaps]))
    lp = on_card(rng.dirichlet(np.ones(CLASSES), size=(J, 1, n_leaves)).astype(np.float32))
    rows_e = X_eval.shape[0]
    # the library yardsticks: one batched searchsorted (K1); bincount, one
    # a channel, over (job, node, feature, bin) and (job, leaf) cells (K2, K5)
    X_columns = X_raw.T[None].expand(J, -1, -1).contiguous()
    job_ids = torch.arange(J, device=device)[:, None]
    feature_offsets = torch.arange(FEATURES, device=device) * MAX_BINS
    flat = (
        ((job_ids * n_nodes + node.long())[:, :, None] * (FEATURES * MAX_BINS)) + feature_offsets + bins.long()
    ).reshape(-1)
    cell_weights = [channels[:, :, k : k + 1].expand(J, rows, FEATURES).reshape(-1) for k in range(CLASSES)]
    leaf_index = (job_ids * n_leaves + leaf.long()).reshape(-1)
    leaf_weights = [channels[:, :, k].reshape(-1) for k in range(CLASSES)]
    hist = trees.level_histograms(bins, node, channels, n_nodes, MAX_BINS, integer=True)
    results.update({
        "apply_bins:jobs": timed(
            "apply_bins:jobs",
            lambda: binning.job_apply_bins(X_raw, ths),
            lambda: binning._job_apply_bins(X_raw, ths),
            _job_bound("apply_bins", rows, J, x_shared=True),
            lambda: torch.searchsorted(ths, X_columns, side="left"),
        ),
        "level_histograms:jobs": timed(
            "level_histograms:jobs",
            lambda: trees.level_histograms(bins, node, channels, n_nodes, MAX_BINS, integer=True),
            lambda: trees._level_histograms(bins, node, channels, n_nodes, MAX_BINS),
            _job_bound("level_histograms", rows, J, n_nodes=n_nodes),
            lambda: [torch.bincount(flat, weights=w, minlength=J * n_nodes * FEATURES * MAX_BINS)
                     for w in cell_weights],
        ),
        "select_splits:jobs": timed(
            "select_splits:jobs",
            lambda: trees.select_splits(hist, "gini"),
            lambda: trees._select_plain(hist, "gini"),
            _job_bound("select_splits", rows, J, n_nodes=n_nodes),
        ),
        "route:jobs": timed(
            "route:jobs",
            lambda: trees.route(bins, node, feature, split),
            lambda: trees._route(bins, node, feature, split),
            _job_bound("route", rows, J, n_nodes=n_nodes, bins_read=bins_read),
        ),
        "leaf_sums:jobs": timed(
            "leaf_sums:jobs",
            lambda: trees.leaf_sums(leaf, channels, n_leaves, integer=True),
            lambda: trees._leaf_sums(leaf, channels, n_leaves),
            _job_bound("leaf_sums", rows, J, n_nodes=n_leaves),
            lambda: [torch.bincount(leaf_index, weights=w, minlength=J * n_leaves) for w in leaf_weights],
        ),
        "tree_ensemble_forward:jobs": timed(
            "tree_ensemble_forward:jobs",
            lambda: trees.job_ensemble_forward(X_eval, fh, th, lp, depth),
            lambda: trees._job_ensemble_forward(X_eval, fh, th, lp, depth),
            _job_bound("tree_ensemble_forward", rows_e, J, x_shared=True, depth=depth),
        ),
    })
    del flat, cell_weights, leaf_index, leaf_weights, X_columns
    for name in ("apply_bins:jobs", "level_histograms:jobs", "select_splits:jobs", "route:jobs",
                 "leaf_sums:jobs"):
        results[name].update(jobs=J, rows=rows, x_shared=name == "apply_bins:jobs")
    results["tree_ensemble_forward:jobs"].update(jobs=J, rows=rows_e, x_shared=True, depth=depth)
    results["level_histograms:jobs"]["nodes"] = results["route:jobs"]["nodes"] = n_nodes
    results["select_splits:jobs"]["nodes"] = n_nodes
    results["leaf_sums:jobs"]["leaves"] = n_leaves
    return results


def check_dt_binned_once(torch, dt_inputs) -> dict:
    """The depth program over shared thresholds (K1 once, the jobs growing
    over one bins matrix) against the same program over the thresholds
    stacked slot by slot (K1 over the job axis, each job its own bins), at
    every depth of the sweep: heaps, leaf probabilities and metrics
    bit-equal, and the K1 and K2-K4 launches each makes."""
    from learningorchestra_tpu_torch.ml import sweep

    Xs, ys, ws, thresholds, Xe, ye, we, _ = dt_inputs
    stacked_thresholds = thresholds[None].expand(ys.shape[0], -1, -1).contiguous()
    launches = {}
    for depth in SWEEP_DEPTHS:
        outputs = {}
        for form, table in (("shared", thresholds), ("stacked", stacked_thresholds)):
            torch.cuda.synchronize()
            kernels.reset_launches()
            outputs[form] = sweep._dt_fused(Xs, ys, ws, table, Xe, ye, we, CLASSES, depth, MAX_BINS)
            torch.cuda.synchronize()
            launches[f"{form}:{depth}"] = {k: v for k, v in kernels.launches().items() if v}
        for got, want in zip(outputs["shared"], outputs["stacked"]):
            if not torch.equal(got, want):
                raise AssertionError(f"dt sweep, depth {depth}: the shared bins' program differs from the stacked one")
    return {"bit_equal": True, "launches": launches}


def time_programs(torch, lr_inputs, dt_inputs, flush) -> dict:
    """The three fused programs (K14) at the main path's shapes: one L-BFGS
    segment of the λ sweep (112 slots; its seed pass and one iteration),
    its evaluation, and the depth sweep's depth-8 program (8 slots),
    each beside its bound (the sum of its kernels' bounds; for the
    evaluation its bytes) and the same program through the plain
    versions."""
    from learningorchestra_tpu_torch.ml import sweep

    W, b, state, Xs, ys, masks, l2s, Xe, means, scales, ye, we = lr_inputs
    jobs, rows = W.shape[0], Xs.shape[-2]
    # the runner's segment at this shape
    iters = segment_steps(SWEEP_MAX_ITER, rows * jobs, logistic._LR_ROW_ITERS_BUDGET, FEATURES)

    def segment():
        return sweep._lr_fused_segment(W, b, state, Xs, ys, masks, l2s, iters)

    def evaluate():
        return sweep._lr_fused_eval(W, b, Xe, means, scales, ye, we, CLASSES)

    def plain_segment():
        with _plain_sweep():
            return segment()

    loss_ms, _ = _job_bound("logistic_loss_grad", rows, jobs, x_shared=Xs.dim() == 2)
    trial_ms, _ = _job_bound("logistic_trial_losses", rows, jobs, x_shared=Xs.dim() == 2)
    rows_e = Xe.shape[1]
    eval_bytes = jobs * rows_e * (FEATURES * 4 + 8) + jobs * (FEATURES * CLASSES + CLASSES + 2 * FEATURES) * 4
    results = {
        "lr_fused_segment": {
            "ms": _event_ms(torch, segment, 3, flush),
            "plain_ms": _event_ms(torch, plain_segment, 1, flush),
            "bound_ms": (1 + iters) * loss_ms + iters * trial_ms,
            "bound_by": "operations" if Xs.dim() == 2 else "bytes",
            "jobs": jobs, "rows": rows, "iterations": iters,
        },
        "lr_fused_eval": {
            "ms": _event_ms(torch, evaluate, 5, flush),
            "bound_ms": eval_bytes / PEAK_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "jobs": jobs, "rows": rows_e,
        },
    }
    # the evaluation is torch ops (a batched torch.matmul, as K8's forward,
    # and K9's metrics): it is its own plain version
    results["lr_fused_eval"]["plain_ms"] = results["lr_fused_eval"]["ms"]
    Xs_t, ys_t, ws_t, ths_t, Xe_t, ye_t, we_t, depth = dt_inputs
    J, rows_t = ys_t.shape[0], Xs_t.shape[-2]

    def dt_program():
        return sweep._dt_fused(Xs_t, ys_t, ws_t, ths_t, Xe_t, ye_t, we_t, CLASSES, depth, MAX_BINS)

    def plain_dt():
        with _plain_sweep():
            return dt_program()

    # one shared table: the rows are binned once, and the jobs share the bins
    shared = ths_t.dim() == 2
    bound = _job_bound("apply_bins", rows_t, 1 if shared else J, x_shared=Xs_t.dim() == 2)[0]
    for level in range(depth):
        for name in ("level_histograms", "select_splits", "route"):
            bound += _job_bound(name, rows_t, J, n_nodes=2**level, bins_shared=shared)[0]
    bound += _job_bound("leaf_sums", rows_t, J, n_nodes=2**depth)[0]
    bound += _job_bound("tree_ensemble_forward", Xe_t.shape[-2], J, x_shared=Xe_t.dim() == 2, depth=depth)[0]
    results["dt_fused"] = {
        "ms": _event_ms(torch, dt_program, 3, flush),
        "plain_ms": _event_ms(torch, plain_dt, 1, flush),
        "bound_ms": bound,
        "bound_by": "bytes",
        "jobs": J, "rows": rows_t, "depth": depth,
    }
    return results


def _coalesced(torch, coalescer, members_data, runner, kind: str, grids, max_iter: int):
    """Register every member with ``coalescer`` and run each: returns the
    results and the coalescer's stats."""
    from learningorchestra_tpu_torch.ml import sweep

    device = _card(torch)
    members = []
    for i, ((X, y), grid) in enumerate(zip(members_data, grids)):
        key, payload = sweep.prepare_member(kind, X, y, X, y, grid, device=device, max_iter=max_iter)
        members.append(coalescer.register(key, payload, runner, name=f"{kind}-{i}"))
    results = [coalescer.run_member(member) for member in members]
    return results, coalescer.stats()


def check_bit_identity(torch) -> dict:
    """Five single-point lr members (λ 0, 0.1, 0.01, 0.5, 0; each its own
    seeded data at BIT_ROWS rows) fused through a Coalescer in one
    dispatch, against each run alone at the same width (window 0): w, b,
    accuracy and F1 identical. The same for three dt members at depths
    {2, 3}."""
    from learningorchestra_tpu_torch.ml import sweep
    from learningorchestra_tpu_torch.sched.coalesce import Coalescer

    runner = sweep.group_runner(_card(torch))
    record = {}
    for kind, data, grids, max_iter in (
        ("lr", [bench_synthetic(BIT_ROWS, seed=20 + i) for i in range(5)],
         [[{"reg_param": l2}] for l2 in (0.0, 0.1, 0.01, 0.5, 0.0)], SWEEP_MAX_ITER),
        ("dt", [bench_synthetic(BIT_ROWS, seed=30 + i) for i in range(3)],
         [[{"max_depth": 2}, {"max_depth": 3}]] * 3, SWEEP_MAX_ITER),
    ):
        started = time.perf_counter()
        fused, fused_stats = _coalesced(torch, Coalescer(window_s=0.05, max_jobs=8), data, runner, kind, grids, max_iter)
        torch.cuda.synchronize()
        fused_s = time.perf_counter() - started
        if fused_stats["fused_dispatches"] != 1:
            raise AssertionError(f"{kind} bit identity: {fused_stats['fused_dispatches']} fused dispatches, not 1")
        solo, _ = _coalesced(torch, Coalescer(window_s=0.0, max_jobs=8), data, runner, kind, grids, max_iter)
        fields = ("w", "b") if kind == "lr" else ("features_heap", "thresholds_heap", "leaf_probs")
        for i, (f_result, s_result) in enumerate(zip(fused, solo)):
            for f_point, s_point in zip(f_result["points"], s_result["points"]):
                if (f_point["accuracy"], f_point["weighted_f1"]) != (s_point["accuracy"], s_point["weighted_f1"]):
                    raise AssertionError(f"{kind} member {i}: fused metrics differ from its solo run")
            for f_params, s_params in zip(f_result["params"], s_result["params"]):
                for field in fields:
                    if not np.array_equal(f_params[field], s_params[field]):
                        raise AssertionError(f"{kind} member {i}: fused {field} differs from its solo run")
        record[kind] = {
            "members": len(data), "rows": BIT_ROWS, "fused_dispatches": 1, "fused_s": fused_s,
            "accuracies": [p["accuracy"] for result in fused for p in result["points"]],
            "bit_identical": True,
        }
    return record


def coalescing_flood(torch) -> dict:
    """bench.py's flood: FLOOD_JOBS concurrent lr members of FLOOD_ROWS
    rows, each its own seeded data, max_iter 25, from as many threads
    through one Coalescer, with the window at 10 ms and at 0. A lock
    stands in for the scheduler's width-1 device class (the scheduler
    comes with the builder): one member runs at a time, and a leader's
    fused dispatch serves the members it collected."""
    from learningorchestra_tpu_torch.ml import sweep
    from learningorchestra_tpu_torch.sched.coalesce import Coalescer

    device = _card(torch)
    runner = sweep.group_runner(device)
    prepared = []
    for i in range(FLOOD_JOBS):
        X, y = bench_synthetic(FLOOD_ROWS, seed=100 + i)
        prepared.append(sweep.prepare_member(
            "lr", X, y, X, y, [{"reg_param": 0.0}], device=device, max_iter=SWEEP_MAX_ITER
        ))
    # both shapes once before the clock: the 8-slot floor and the 64-slot batch
    sweep.run_group([prepared[0][1]], device)
    sweep.run_group([payload for _, payload in prepared], device)
    torch.cuda.synchronize()

    def flood(window_s: float) -> dict:
        coalescer = Coalescer(window_s=window_s, max_jobs=FLOOD_JOBS)
        lane = threading.Lock()
        barrier = threading.Barrier(FLOOD_JOBS + 1)
        results, failures = [None] * FLOOD_JOBS, []

        def client(index: int) -> None:
            key, payload = prepared[index]
            member = coalescer.register(key, payload, runner, name=f"flood-{index}")
            barrier.wait()
            try:
                with lane:
                    results[index] = coalescer.run_member(member)
                    torch.cuda.synchronize()
            except Exception as error:  # noqa: BLE001 — surfaced below
                failures.append(error)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(FLOOD_JOBS)]
        for thread in threads:
            thread.start()
        barrier.wait()
        started = time.perf_counter()
        for thread in threads:
            thread.join(timeout=600)
        elapsed = time.perf_counter() - started
        if failures or any(result is None for result in results):
            raise AssertionError(f"flood at window {window_s}: {len(failures)} failed, {failures[:1]!r}")
        stats = coalescer.stats()
        return {
            "jobs_per_s": FLOOD_JOBS / elapsed,
            "wall_s": elapsed,
            "fused_dispatches": stats["fused_dispatches"],
            "mean_batch_size": stats["mean_batch_size"],
            "finished": sum(result is not None for result in results),
        }

    coalesced = flood(FLOOD_WINDOW_S)
    uncoalesced = flood(0.0)
    if coalesced["fused_dispatches"] != 1:
        raise AssertionError(f"the 10 ms flood made {coalesced['fused_dispatches']} fused dispatches, not 1")
    if uncoalesced["fused_dispatches"] != FLOOD_JOBS:
        raise AssertionError(f"the window-0 flood made {uncoalesced['fused_dispatches']} dispatches")
    return {
        "jobs": FLOOD_JOBS, "rows": FLOOD_ROWS,
        "coalesced": coalesced, "uncoalesced_window0": uncoalesced,
        "coalesce_speedup": coalesced["jobs_per_s"] / uncoalesced["jobs_per_s"],
    }


def _sweep_launches(kind: str, payload, padded: int) -> tuple[dict, dict]:
    """The kernel launches and program calls one sweep of ``payload``
    makes: one launch a level or an iteration for the whole group."""
    expected = {name: 0 for name in kernels.KERNEL_NAMES}
    if kind == "lr":
        iters = segment_steps(
            SWEEP_MAX_ITER, payload["X"].shape[0] * padded, logistic._LR_ROW_ITERS_BUDGET, FEATURES
        )
        segments = max(1, SWEEP_MAX_ITER // iters)
        expected.update(logistic_loss_grad=segments + segments * iters,
                        logistic_trial_losses=segments * iters)
        return expected, {"lr_fused_segment": segments, "lr_fused_eval": 1, "dt_fused": 0}
    levels = sum(SWEEP_DEPTHS)
    programs = len(SWEEP_DEPTHS)
    expected.update(apply_bins=programs, level_histograms=levels, select_splits=levels, route=levels,
                    leaf_sums=programs, tree_ensemble_forward=programs)
    return expected, {"lr_fused_segment": 0, "lr_fused_eval": 0, "dt_fused": programs}


def sweep_members(device=None, mesh=None) -> dict:
    """The sweep phase's two members, prepared for ``device`` or over the
    data ranks of ``mesh``: bench.py's sweep_100 λ grid over lr and the
    depth grid over dt, on its 1,000,000 rows (seed 0) and an eval draw of
    200,000 (seed 1)."""
    from learningorchestra_tpu_torch.ml import sweep

    X, y = bench_synthetic(SWEEP_ROWS, seed=0)
    X_eval, y_eval = bench_synthetic(SWEEP_EVAL_ROWS, seed=1)
    lambdas = [{"reg_param": float(v)} for v in np.linspace(0.0, 1.0, SWEEP_POINTS)]
    depths = [{"max_depth": depth} for depth in SWEEP_DEPTHS]
    return {
        "lr": sweep.prepare_member("lr", X, y, X_eval, y_eval, lambdas, device=device,
                                   max_iter=SWEEP_MAX_ITER, mesh=mesh)[1],
        "dt": sweep.prepare_member("dt", X, y, X_eval, y_eval, depths, device=device, mesh=mesh)[1],
    }


def phase_sweep(torch, card: str) -> dict:
    """The fused programs on the card at full width: bench.py's sweep_100
    λ grid over lr and a depth grid over dt on 1,000,000 rows, each one
    member through run_group, launches counted, held against the same
    group through the plain versions; the per-job kernel checks; the
    bit-identity of fused and solo members; the coalescing flood."""
    from learningorchestra_tpu_torch.ml import sweep

    device = _card(torch)
    record = {"phase": "sweep", "rows": SWEEP_ROWS, "eval_rows": SWEEP_EVAL_ROWS, "features": FEATURES}
    started = time.perf_counter()
    members = sweep_members(device=device)
    lr_payload, dt_payload = members["lr"], members["dt"]
    X_eval, _ = bench_synthetic(SWEEP_EVAL_ROWS, seed=1)
    record["prepare_s"] = time.perf_counter() - started

    # the main path: each sweep with the counts set to 0 just before it
    # and read just after
    runs = {}
    for kind, payload, padded in (
        ("lr", lr_payload, sweep._job_axis(SWEEP_POINTS)), ("dt", dt_payload, sweep._job_axis(1)),
    ):
        expected, expected_programs = _sweep_launches(kind, payload, padded)
        torch.cuda.synchronize()
        kernels.reset_launches()
        sweep.reset_program_calls()
        started = time.perf_counter()
        result = _outcome(sweep.run_group([payload], device))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - started
        launches, programs = kernels.launches(), sweep.program_calls()
        if launches != expected or programs != expected_programs:
            raise AssertionError(
                f"{kind} sweep launched {launches} in {programs}, expected {expected} in {expected_programs}"
            )
        accuracies = [point["accuracy"] for point in result["points"]]
        if not all(0.5 < accuracy <= 1.0 for accuracy in accuracies):
            raise AssertionError(f"{kind} sweep: accuracies {accuracies}")
        runs[kind] = result
        record[kind] = {
            "points": len(payload["grid"]), "padded_slots": padded, "wall_s": wall_s,
            "points_per_s": len(payload["grid"]) / wall_s,
            "launches": {name: count for name, count in launches.items() if count},
            "programs": programs, "best": result["best"],
            "best_accuracy": accuracies[result["best"]],
        }

    # the same groups through the plain versions on the card
    with _plain_sweep():
        started = time.perf_counter()
        plain_lr = _outcome(sweep.run_group([lr_payload], device))
        torch.cuda.synchronize()
        record["lr"]["plain_wall_s"] = time.perf_counter() - started
        started = time.perf_counter()
        plain_dt = _outcome(sweep.run_group([dt_payload], device))
        torch.cuda.synchronize()
        record["dt"]["plain_wall_s"] = time.perf_counter() - started
    lr, X_eval_dev = runs["lr"], torch.from_numpy(X_eval).to(device)
    if lr["best"] != plain_lr["best"]:
        raise AssertionError(f"lr sweep: winner {lr['best']}, the plain versions' {plain_lr['best']}")
    prob_err = 0.0
    for params, plain_params in zip(lr["params"], plain_lr["params"]):
        probs = sweep.model_from_params(params, device)._forward(X_eval_dev)
        plain_probs = sweep.model_from_params(plain_params, device)._forward(X_eval_dev)
        prob_err = max(prob_err, float((probs - plain_probs).abs().max()))
    if prob_err > LR_PROB_TOL:
        raise AssertionError(f"lr sweep: probabilities {prob_err} from the plain versions' fits")
    dt = runs["dt"]
    leaf_err = 0.0
    for params, plain_params in zip(dt["params"], plain_dt["params"]):
        for field in ("features_heap", "thresholds_heap"):
            if not np.array_equal(params[field], plain_params[field]):
                raise AssertionError(f"dt sweep, depth {params['max_depth']}: {field} differs from the plain versions'")
        leaf_err = max(leaf_err, float(np.abs(params["leaf_probs"] - plain_params["leaf_probs"]).max()))
    if leaf_err > TREE_TOL:
        raise AssertionError(f"dt sweep: leaf probabilities {leaf_err} from the plain versions'")
    if [p["accuracy"] for p in dt["points"]] != [p["accuracy"] for p in plain_dt["points"]]:
        raise AssertionError("dt sweep: accuracies differ from the plain versions'")
    record["lr"]["max_prob_err_to_plain"] = prob_err
    record["dt"]["max_leaf_err_to_plain"] = leaf_err

    # the kernels on the main path's own inputs
    X_raw = torch.from_numpy(lr_payload["X"]).to(device)
    mean = torch.from_numpy(lr_payload["mean"]).to(device)
    scale = torch.from_numpy(lr_payload["scale"]).to(device)
    X_std = (X_raw - mean) / scale
    y_dev = torch.from_numpy(lr_payload["y"]).to(device)
    mask = torch.from_numpy(lr_payload["mask"]).to(device)
    thresholds = torch.from_numpy(dt_payload["thresholds"]).to(device)
    Xe_dev = torch.from_numpy(dt_payload["X_eval"]).to(device)
    errors = check_job_kernels(torch, X_std, y_dev, mask, X_raw, thresholds, Xe_dev)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=device)
    timings = time_job_kernels(torch, X_std, y_dev, mask, X_raw, thresholds, Xe_dev, flush)
    for name, result in timings.items():
        result["max_abs_err"] = errors[name]
        result["launches"] = record["lr" if name.startswith("logistic") else "dt"]["launches"].get(
            JOB_KERNELS[name][0], 0
        )
    padded = sweep._job_axis(SWEEP_POINTS)
    W0 = torch.zeros((padded, FEATURES, CLASSES), dtype=torch.float32, device=device)
    b0 = torch.zeros((padded, CLASSES), dtype=torch.float32, device=device)
    ones = torch.ones(padded, 1, device=device)
    lr_inputs = (
        W0, b0, sweep._job_lbfgs_state(W0, b0), X_std, y_dev, mask,
        torch.linspace(0.0, 1.0, padded, device=device),
        Xe_dev[None].expand(padded, -1, -1).contiguous(), mean * ones, scale * ones,
        torch.from_numpy(lr_payload["y_eval"]).to(device)[None].expand(padded, -1).contiguous(),
        torch.from_numpy(lr_payload["mask_eval"]).to(device)[None].expand(padded, -1).contiguous(),
    )
    slots = sweep._job_axis(1)
    # the runner's call: one member's slots share X and its thresholds
    dt_inputs = (
        X_raw, y_dev[None].expand(slots, -1).contiguous(), mask[None].expand(slots, -1).contiguous(),
        thresholds, Xe_dev,
        lr_inputs[10][:slots].contiguous(), lr_inputs[11][:slots].contiguous(), max(SWEEP_DEPTHS),
    )
    record["dt"]["binned_once"] = check_dt_binned_once(torch, dt_inputs)
    programs = time_programs(torch, lr_inputs, dt_inputs, flush)
    for name, result in programs.items():
        result["launches"] = (record["lr"] if name.startswith("lr") else record["dt"])["programs"][name]
    program_errors = {"lr_fused_segment": prob_err, "lr_fused_eval": 0.0, "dt_fused": leaf_err}
    for name, result in programs.items():
        result["max_abs_err"] = program_errors[name]
    del lr_inputs, dt_inputs, flush
    record["bit_identity"] = check_bit_identity(torch)
    record["flood"] = coalescing_flood(torch)
    record["kernels"] = timings
    record["programs"] = programs
    record["nvidia_smi"] = card
    emit(record)
    return record


# --------------------------------------------------------------------------
# The model builder: POST /models end to end
# --------------------------------------------------------------------------

ROOT = os.path.dirname(os.path.abspath(__file__))
MODEL_NAMES = ("lr", "dt", "rf", "gb", "nb")
# tests/test_titanic_golden.py's documented projection and casts
TITANIC_FIELDS = ("PassengerId", "Survived", "Pclass", "Name", "Sex", "Age", "SibSp", "Parch", "Embarked")
TITANIC_NUMBERS = ("Age", "Parch", "PassengerId", "Pclass", "SibSp")
PRODUCT_ROWS = 100_000   # bench.py's product path (its PRODUCT_ROWS), the first rows of its data
PRODUCT_PREPROCESSOR = (  # bench.py's bench_product preprocessor
    "from pyspark.ml.feature import VectorAssembler\n"
    "feature_cols = [c for c in training_df.schema.names if c != 'label']\n"
    "assembler = VectorAssembler(inputCols=feature_cols, outputCol='features')\n"
    "features_training = assembler.transform(training_df)\n"
    "features_testing = assembler.transform(testing_df)\n"
    "features_evaluation = assembler.transform(testing_df)\n"
)
BUILD_KERNELS = (
    "apply_bins", "level_histograms", "select_splits", "route", "leaf_sums",
    "logistic_loss_grad", "logistic_trial_losses", "tree_ensemble_forward", "gbt_forward",
)
METRIC_TOL = 1e-6
PREDICT_ROWS = 8
# a build against the same build by the plain versions: the fit phase's
# tolerance of each classifier, on probabilities and metrics; labels equal
PLAIN_BUILD_TOL = {"dt": 0.0, "rf": TREE_TOL, "gb": FIT_MARGIN_TOL, "lr": LR_PROB_TOL, "nb": NB_TOL}


def documented_preprocessor() -> str:
    """The documented preprocessor, read from ``tests/test_frame.py``'s
    source without importing it (that module imports the JAX package)."""
    import ast

    with open(os.path.join(ROOT, "tests", "test_frame.py")) as handle:
        tree = ast.parse(handle.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
            getattr(target, "id", None) == "DOCUMENTED_PREPROCESSOR" for target in node.targets
        ):
            return ast.literal_eval(node.value)
    raise AssertionError("tests/test_frame.py defines no DOCUMENTED_PREPROCESSOR")


def titanic_store(folder: str, store=None):
    """``tests/data``'s Titanic CSVs (891 and 418 rows) in the port's
    store (``store``, else a new in-process one) as the golden flow reads
    them: projected to its field set (on the CSV, so that this phase
    stays the builder's alone: the ``stack`` phase runs the projection
    service), through ``ingest_csv``, then ``convert_field_types``."""
    import csv

    from learningorchestra_tpu_torch.core.ingest import ingest_csv, write_ingest_metadata
    from learningorchestra_tpu_torch.ops.dtype import convert_field_types

    store = InMemoryStore() if store is None else store
    for name, labelled in (("titanic_train", True), ("titanic_test", False)):
        fields = [field for field in TITANIC_FIELDS if labelled or field != "Survived"]
        path = os.path.join(folder, f"{name}.csv")
        with open(os.path.join(ROOT, "tests", "data", f"{name}.csv"), newline="") as source, \
                open(path, "w", newline="") as projected:
            writer = csv.writer(projected)
            writer.writerow(fields)
            writer.writerows([row[field] for field in fields] for row in csv.DictReader(source))
        write_ingest_metadata(store, name, path)
        ingest_csv(store, name, path)
        numbers = TITANIC_NUMBERS + (("Survived",) if labelled else ())
        convert_field_types(store, name, {field: "number" for field in numbers})
    return store


def product_store(store=None):
    """bench.py's product-path collections: its synthetic rows' first
    100,000 (16 features + label) written to ``bench_train`` and
    ``bench_test`` as its ``bench_product`` writes them (into ``store``,
    else a new one)."""
    X, y = bench_synthetic(FIT_ROWS)
    X, y = X[:PRODUCT_ROWS], y[:PRODUCT_ROWS]
    store = InMemoryStore() if store is None else store
    for name in ("bench_train", "bench_test"):
        store.create_collection(name)
        store.insert_one(name, {
            "_id": 0, "filename": name, "finished": True,
            "fields": [f"f{i}" for i in range(FEATURES)] + ["label"],
        })
        columns = {f"f{i}": X[:, i].tolist() for i in range(FEATURES)}
        columns["label"] = y.tolist()
        store.insert_columns(name, columns)
    return store


def numpy_metrics(y_true: np.ndarray, y_pred: np.ndarray) -> tuple[float, float]:
    """Accuracy and Spark's weighted F1 in float64 numpy."""
    classes = int(max(y_true.max(), y_pred.max())) + 1
    cm = np.zeros((classes, classes))
    np.add.at(cm, (y_true.astype(np.int64), y_pred.astype(np.int64)), 1.0)
    true_positive, support, predicted = np.diag(cm), cm.sum(axis=1), cm.sum(axis=0)
    with np.errstate(invalid="ignore", divide="ignore"):
        precision = np.where(predicted > 0, true_positive / predicted, 0.0)
        recall = np.where(support > 0, true_positive / support, 0.0)
        f1 = np.where(precision + recall > 0, 2 * precision * recall / (precision + recall), 0.0)
    return float(true_positive.sum() / cm.sum()), float((f1 * support).sum() / cm.sum())


@contextlib.contextmanager
def _counting_metrics():
    """Count the calls of K9 (``evaluation.masked_metrics``, torch ops, no
    kernel of its own)."""
    calls = [0]
    original = evaluation.masked_metrics

    def counted(*args, **kwargs):
        calls[0] += 1
        return original(*args, **kwargs)

    evaluation.masked_metrics = counted
    try:
        yield calls
    finally:
        evaluation.masked_metrics = original


def _span_seconds(trace: dict, names) -> dict:
    found = {}
    pending = list(trace["spans"])
    while pending:
        span = pending.pop()
        if span["name"] in names:
            found[span["name"]] = span["duration_s"]
        pending += span["children"]
    return found


def _build_body(training: str, test: str, code: str, run_async: bool) -> dict:
    body = {
        "training_filename": training, "test_filename": test,
        "preprocessor_code": code, "classificators_list": list(MODEL_NAMES),
    }
    if run_async:
        body["async"] = True
    return body


def _stored_outputs(store, test: str) -> dict:
    """Each classifier's stored labels and probabilities, and its
    metadata's accuracy and F1, as a build left them in ``store``."""
    outputs = {}
    for name in MODEL_NAMES:
        collection = f"{test}_prediction_{name}"
        metadata = store.find_one(collection, {"_id": 0})
        columns = store.read_column_arrays(collection, ["prediction", "probability"])
        outputs[name] = {
            "labels": columns["prediction"].to_float64(),
            "probability": np.array(columns["probability"].tolist(), dtype=np.float64),
            "metrics": np.array([float(metadata["accuracy"]), float(metadata["F1"])]),
        }
    return outputs


@contextlib.contextmanager
def _plain_build():
    """Within the block, a build runs the plain version of every kernel
    it launches (K1, the level loop, K6's two forwards, K7's twins), on
    any device. Raises if a kernel launched."""
    with _plain(trees, {
        "apply_bins": binning._apply_bins,
        "ensemble_forward": trees._ensemble_forward,
        "gbt_forward": trees._gbt_forward,
    }), _plain_level_loop(), _plain_k7():
        yield


def plain_build(torch, client, store, what: str, training: str, test: str, code: str) -> tuple:
    """The same request as the kernels' builds, synchronous, with the plain
    versions swapped in: their yardstick at the shapes a build gives its
    kernels. Returns its stored outputs and its wall."""
    torch.cuda.synchronize()
    started = time.perf_counter()
    with _plain_build():
        status, answer = client.call("POST", "/models", _build_body(training, test, code, False))
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - started
    if (status, answer) != (201, {"result": "created_file"}):
        raise AssertionError(f"{what}: the plain-version build answered {status} {answer}")
    return _stored_outputs(store, test), wall_s


def held_to_plain(what: str, outputs: dict, plain: dict) -> dict:
    """A kernels' build against the plain-version build of the same
    request: equal labels, probabilities and metrics within the fit
    phase's tolerance of each classifier (PLAIN_BUILD_TOL)."""
    errors = {}
    for name in MODEL_NAMES:
        got, want = outputs[name], plain[name]
        if not np.array_equal(got["labels"], want["labels"]):
            differing = int((got["labels"] != want["labels"]).sum())
            raise AssertionError(f"{what} {name}: {differing} labels differ from the plain-version build")
        prob_err = float(np.abs(got["probability"] - want["probability"]).max())
        metric_err = float(np.abs(got["metrics"] - want["metrics"]).max())
        if prob_err > PLAIN_BUILD_TOL[name] or metric_err > PLAIN_BUILD_TOL[name]:
            raise AssertionError(
                f"{what} {name}: probabilities {prob_err}, metrics {metric_err} from the "
                f"plain-version build (tolerance {PLAIN_BUILD_TOL[name]})"
            )
        errors[name] = {"max_prob_err": prob_err, "max_metric_err": metric_err}
    return errors


def run_build(torch, client, store, what: str, training: str, test: str, code: str,
              run_async: bool) -> tuple:
    """One ``POST /models`` of all five classifiers with the launch counts
    set to 0 just before it and read just after, then its checks: every
    prediction collection has the test rows, its labels are those its
    ``.model`` gives through ``load_model`` on the card, its accuracy and
    F1 numpy's on that model's eval labels (within 1e-6), and a
    ``POST /models/<name>/predict`` answers the same labels. Returns its
    record and its stored outputs."""
    from learningorchestra_tpu_torch.frame.pyspark_compat import run_preprocessor
    from learningorchestra_tpu_torch.ml.builder import _alias_if_equal, load_dataframe

    job = f"build:{test}:{'+'.join(MODEL_NAMES)}"
    body = _build_body(training, test, code, run_async)
    with _counting_metrics() as k9_calls:
        torch.cuda.synchronize()
        kernels.reset_launches()
        started = time.perf_counter()
        status, answer = client.call("POST", "/models", body)
        expected = {"result": "created_file", **({"job": job} if run_async else {})}
        if (status, answer) != (201, expected):
            raise AssertionError(f"{what}: POST /models answered {status} {answer}")
        waits = 0
        while run_async:
            status, waited = client.call("GET", f"/jobs/{job}/wait?timeout=60")
            waits += 1
            if status != 200:
                raise AssertionError(f"{what}: /wait answered {status} {waited}")
            if waited["result"] != "timeout":
                if waited["result"]["state"] != "finished":
                    raise AssertionError(f"{what}: the job ended {waited['result']}")
                break
        wall_s = time.perf_counter() - started
        torch.cuda.synchronize()
        launches = kernels.launches()
        k9 = k9_calls[0]
    missing = [name for name in BUILD_KERNELS if launches[name] == 0]
    if missing or k9 == 0:
        raise AssertionError(f"{what}: the build never launched {missing} (K9 calls {k9})")
    status, traced = client.call("GET", f"/jobs/{job}/trace")
    spans = _span_seconds(traced["result"]["trace"], ("load_data", "preprocess"))
    frames = run_preprocessor(code, load_dataframe(store, training), load_dataframe(store, test))
    testing = frames["features_testing"]
    evaluation_frame = _alias_if_equal(frames["features_evaluation"], testing)
    X_test = testing.feature_matrix("features")
    X_eval, y_eval = evaluation_frame.feature_matrix("features"), evaluation_frame.label_vector("label")
    classifiers = {}
    outputs = _stored_outputs(store, test)
    for name in MODEL_NAMES:
        collection = f"{test}_prediction_{name}"
        metadata = store.find_one(collection, {"_id": 0})
        stored = outputs[name]["labels"]
        if len(stored) != len(X_test):
            raise AssertionError(f"{what} {name}: {len(stored)} predictions for {len(X_test)} test rows")
        model = load_model(metadata["model_checkpoint"])
        if not np.array_equal(model.predict(X_test), stored):
            raise AssertionError(f"{what} {name}: the stored labels are not its checkpoint's")
        accuracy, weighted_f1 = numpy_metrics(y_eval, model.predict(X_eval))
        got = (float(metadata["accuracy"]), float(metadata["F1"]))
        if max(abs(got[0] - accuracy), abs(got[1] - weighted_f1)) > METRIC_TOL:
            raise AssertionError(f"{what} {name}: metrics {got} against numpy's {(accuracy, weighted_f1)}")
        status, answered = client.call(
            "POST", f"/models/{collection}/predict", {"rows": X_test[:PREDICT_ROWS].tolist()}
        )
        if status != 200 or answered["result"]["predictions"] != stored[:PREDICT_ROWS].tolist():
            raise AssertionError(f"{what} {name}: the predict lane answered {status} {answered}")
        classifiers[name] = {
            "timings": metadata["timings"], "accuracy": metadata["accuracy"], "F1": metadata["F1"],
        }
    return {
        "build": what,
        "async": run_async,
        "wall_s": wall_s,
        "waits": waits,
        "rows": {"train": frames["features_training"].count(), "eval": len(X_eval), "test": len(X_test)},
        "spans_s": spans,
        "classifiers": classifiers,
        "launches": {name: launches[name] for name in BUILD_KERNELS},
        "k9_calls": k9,
    }, outputs


def phase_models(torch, card: str) -> dict:
    """Two builds through the port's model_builder app over HTTP, on the
    card (``device=None``): the Titanic flow synchronously, then
    bench.py's product path synchronously and ``async``. Each data set's
    request is then built once more by the plain versions, and every
    kernels' build is held to that build."""
    builds = []
    with tempfile.TemporaryDirectory() as folder:
        stores = {"titanic": titanic_store(folder)}
        started = time.perf_counter()
        stores["product"] = product_store()
        product_setup_s = time.perf_counter() - started
        code = documented_preprocessor()
        for what, store, training, test, preprocessor, modes in (
            ("titanic", stores["titanic"], "titanic_train", "titanic_test", code, (False,)),
            ("product", stores["product"], "bench_train", "bench_test", PRODUCT_PREPROCESSOR, (False, True)),
        ):
            plane = ServePlane()
            models_dir = os.path.join(folder, f"models_{what}")
            server = ServerThread(create_app(store, models_dir=models_dir, serve=plane)).start()
            try:
                client = _Client(server.port)
                built = [
                    run_build(torch, client, store, what, training, test, preprocessor, run_async)
                    for run_async in modes
                ]
                plain, plain_wall_s = plain_build(torch, client, store, what, training, test, preprocessor)
                for record, outputs in built:
                    record["plain_build_wall_s"] = plain_wall_s
                    record["held_to_plain"] = held_to_plain(what, outputs, plain)
                    builds.append(record)
            finally:
                server.stop()
                plane.close()
    record = {
        "phase": "models",
        "builds": builds,
        "product_setup_s": product_setup_s,
        "nvidia_smi": card,
    }
    emit(record)
    return record


# --------------------------------------------------------------------------
# The whole stack: crash resume, the services, sweeps over REST, kill -9
# --------------------------------------------------------------------------

# LO_PROGRAM_ROW_STEPS for the in-process resume: at 1,000,000 x 16, gb's
# 20 rounds in 5 chunks of 4 and lr's 100 iterations (tol 0, no plateau
# stop) in 10 segments of 10, so that a stop after the first saved
# segment leaves most of each fit to the resumed run
STACK_SEGMENT_SCALE = 0.1
RESUME_KERNELS = {
    "gbt": ("apply_bins", "level_histograms", "select_splits", "route", "leaf_sums"),
    "logistic": ("logistic_loss_grad", "logistic_trial_losses"),
}
SWEEP_KERNELS = {
    "lr": ("logistic_loss_grad", "logistic_trial_losses"),
    "dt": ("apply_bins", "level_histograms", "select_splits", "route", "leaf_sums", "tree_ensemble_forward"),
}
TITANIC_TYPES = {field: "number" for field in TITANIC_NUMBERS}
DRILL_ROWS = 20_000           # the kill -9 drill's CSV: bench.py's rows, its first 20,000
DRILL_ROW_STEPS = "0.002"     # LO_PROGRAM_ROW_STEPS of the drill: gb 5 chunks, lr 10 segments
DRILL_DELAY = "delay:0.5@100"  # every builder phase delayed, as tests/test_chaos.py delays it
RUNNER_COMMAND = [sys.executable, "-m", "learningorchestra_tpu_torch.services.runner"]
STACK_DEVICE = None           # every entry point's default: the CUDA card


def _counter_value(name: str) -> float:
    from learningorchestra_tpu_torch.telemetry.metrics import global_registry

    return global_registry().counter(name, "probe").value()


def _resume_fit(torch, kind: str, X: np.ndarray, y: np.ndarray, folder: str) -> dict:
    """One fit stopped after its first saved segment and resumed: the
    resumed model bit-equal to an uninterrupted fit, the segments skipped
    counted, the fit's kernels launched in the resumed part."""
    from learningorchestra_tpu_torch.device import resolve_device
    from learningorchestra_tpu_torch.ml import builder, progress
    from learningorchestra_tpu_torch.testing import faults

    def fit():
        if kind == "gbt":
            model = trees.GBTClassifier(device=STACK_DEVICE).fit(X, y)
            tensors = [model.features_heap, model.thresholds_heap, model.leaf_values]
        else:
            model = logistic.LogisticRegression(tol=0.0, device=STACK_DEVICE).fit(X, y)
            tensors = [model.w, model.b]
        torch.cuda.synchronize()
        return model, tensors

    started = time.perf_counter()
    control, control_tensors = fit()
    fit_s = time.perf_counter() - started
    sink = progress.ProgressSink(
        os.path.join(folder, f"{kind}.progress"), {"mesh": builder._device_key(resolve_device(STACK_DEVICE))}
    )
    faults.install("fit.segment", "error@1", where={"kind": kind})
    try:
        with progress.bind_sink(sink):
            fit()
    except faults.FaultInjected:
        pass
    else:
        raise AssertionError(f"{kind}: the fit.segment fault never stopped the fit")
    finally:
        faults.reset()
    saved_segment = sink.load(kind)[0]
    skipped = _counter_value("lo_build_segments_skipped_total")
    saved = _counter_value("lo_build_segments_saved_total")
    torch.cuda.synchronize()
    kernels.reset_launches()
    started = time.perf_counter()
    with progress.bind_sink(sink):
        resumed, resumed_tensors = fit()
    resumed_s = time.perf_counter() - started
    launches = kernels.launches()
    skipped = _counter_value("lo_build_segments_skipped_total") - skipped
    segments = saved_segment + _counter_value("lo_build_segments_saved_total") - saved
    if saved_segment != 1 or skipped != 1 or segments < 3:
        raise AssertionError(f"{kind}: saved {saved_segment}, skipped {skipped} of {segments} segments")
    if not all(torch.equal(got, want) for got, want in zip(resumed_tensors, control_tensors)):
        raise AssertionError(f"{kind}: the resumed fit is not bit-equal to the uninterrupted one")
    if kind == "gbt" and resumed.f0 != control.f0:
        raise AssertionError("gbt: the resumed fit's f0 differs")
    idle = [name for name in RESUME_KERNELS[kind] if launches[name] == 0]
    if idle:
        raise AssertionError(f"{kind}: the resumed part never launched {idle}")
    return {
        "segments": int(segments), "skipped": int(skipped), "fit_s": fit_s, "resumed_s": resumed_s,
        "bit_equal": True,
        "launches": {name: launches[name] for name in RESUME_KERNELS[kind]},
    }


def _service_clients(servers) -> dict:
    from learningorchestra_tpu_torch.services.runner import SERVICES

    names = {port: name for name, port in SERVICES.items()}
    return {names[server.canonical_port]: _Client(server.port) for server in servers}


def _timed(walls: dict, key: str, client, method: str, path: str, payload=None, expect=(200, 201)):
    started = time.perf_counter()
    status, answer = client.call(method, path, payload)
    walls[key] = time.perf_counter() - started
    if status not in expect:
        raise AssertionError(f"{method} {path} answered {status} {answer}")
    return answer


def _ingest_over_rest(client, walls: dict, name: str, path: str) -> None:
    started = time.perf_counter()
    answer = _timed(walls, f"POST /files {name}", client, "POST", "/files",
                    {"filename": name, "url": "file://" + path}, expect=(201,))
    if answer != {"result": "file_created"}:
        raise AssertionError(f"POST /files {name}: {answer}")
    deadline = time.time() + 300
    while time.time() < deadline:
        status, page = client.call("GET", f"/files/{name}?skip=0&limit=1&query={{}}")
        if status == 200 and page["result"] and page["result"][0].get("finished"):
            walls[f"ingest {name}"] = time.perf_counter() - started
            return
        time.sleep(0.02)
    raise AssertionError(f"the ingest of {name} never finished")


def _stack_titanic(torch, clients: dict, store, folder: str, walls: dict) -> dict:
    """The documented walkthrough over REST, then the same build through
    ``build_model`` directly: equal metrics."""
    from learningorchestra_tpu_torch.ml.builder import build_model

    files = clients["database_api"]
    for name in ("titanic_train", "titanic_test"):
        _ingest_over_rest(files, walls, name, os.path.join(ROOT, "tests", "data", f"{name}.csv"))
        fields = [field for field in TITANIC_FIELDS if name == "titanic_train" or field != "Survived"]
        _timed(walls, f"POST /projections {name}", clients["projection"], "POST", f"/projections/{name}",
               {"projection_filename": f"{name}_projection", "fields": fields}, expect=(201,))
        types = {**TITANIC_TYPES, **({"Survived": "number"} if name == "titanic_train" else {})}
        _timed(walls, f"PATCH /fieldtypes {name}", clients["data_type_handler"], "PATCH",
               f"/fieldtypes/{name}_projection", types, expect=(200,))
    _timed(walls, "POST /histograms", clients["histogram"], "POST", "/histograms/titanic_train_projection",
           {"histogram_filename": "titanic_histogram", "fields": ["Sex", "Pclass"]}, expect=(201,))
    histogram = store.find_one("titanic_histogram", {"_id": 1})
    if sum(entry["count"] for entry in histogram["Sex"]) != 891:
        raise AssertionError(f"the Sex histogram counts {histogram['Sex']}")
    code = documented_preprocessor()
    training, test = "titanic_train_projection", "titanic_test_projection"
    job = f"build:{test}:{'+'.join(MODEL_NAMES)}"
    torch.cuda.synchronize()
    kernels.reset_launches()
    started = time.perf_counter()
    answer = _timed(walls, "POST /models titanic (async)", clients["model_builder"], "POST", "/models",
                    _build_body(training, test, code, True), expect=(201,))
    while True:
        status, waited = clients["model_builder"].call("GET", f"/jobs/{job}/wait?timeout=60")
        if status != 200:
            raise AssertionError(f"/wait answered {status} {waited}")
        if waited["result"] != "timeout":
            break
    walls["build titanic (async, to finished)"] = time.perf_counter() - started
    launches = kernels.launches()
    if waited["result"]["state"] != "finished" or answer.get("job") != job:
        raise AssertionError(f"the titanic build ended {waited['result']}")
    missing = [name for name in BUILD_KERNELS if launches[name] == 0]
    if missing:
        raise AssertionError(f"the titanic build never launched {missing}")
    over_rest = {
        name: store.find_one(f"{test}_prediction_{name}", {"_id": 0}) for name in MODEL_NAMES
    }
    started = time.perf_counter()
    direct = build_model(store, training, test, code, list(MODEL_NAMES), device=STACK_DEVICE,
                         models_dir=os.path.join(folder, "direct_models"))
    walls["build titanic (build_model)"] = time.perf_counter() - started
    metrics = {}
    for metadata in direct:
        name = metadata["classificator"]
        got = (over_rest[name]["accuracy"], over_rest[name]["F1"])
        if got != (metadata["accuracy"], metadata["F1"]):
            raise AssertionError(f"titanic {name}: REST {got}, build_model {(metadata['accuracy'], metadata['F1'])}")
        metrics[name] = {"accuracy": got[0], "F1": got[1]}
    return {"metrics": metrics, "launches": {name: launches[name] for name in BUILD_KERNELS}}


@contextlib.contextmanager
def _counting_job_metrics():
    """Count the calls of K9 over a job axis (``evaluation.job_masked_metrics``
    as the sweep module holds it)."""
    from learningorchestra_tpu_torch.ml import sweep

    calls = [0]
    original = sweep.job_masked_metrics

    def counted(*args, **kwargs):
        calls[0] += 1
        return original(*args, **kwargs)

    sweep.job_masked_metrics = counted
    try:
        yield calls
    finally:
        sweep.job_masked_metrics = original


def _stack_sweeps(torch, client, store, folder: str, walls: dict) -> dict:
    """``POST /models/sweep`` over bench.py's product collections: the
    points bit-equal to a direct ``run_sweep``, the winner served."""
    from learningorchestra_tpu_torch.core.jobs import JobManager
    from learningorchestra_tpu_torch.ml import sweep
    from learningorchestra_tpu_torch.sched import Coalescer

    X_rows = bench_synthetic(FIT_ROWS)[0][:PREDICT_ROWS]
    grids = {
        "lr": [{"reg_param": float(v)} for v in np.linspace(0.0, 1.0, SWEEP_POINTS)],
        "dt": [{"max_depth": depth} for depth in SWEEP_DEPTHS],
    }
    results = {}
    for kind, grid in grids.items():
        body = {
            "training_filename": "bench_train", "test_filename": "bench_test",
            "preprocessor_code": PRODUCT_PREPROCESSOR, "classificator": kind, "grid": grid,
            "sweep_name": f"product_{kind}_sweep",
            **({"max_iter": SWEEP_MAX_ITER} if kind == "lr" else {}),
        }
        with _counting_job_metrics() as k9_calls:
            torch.cuda.synchronize()
            kernels.reset_launches()
            answer = _timed(walls, f"POST /models/sweep {kind}", client, "POST", "/models/sweep", body,
                            expect=(201,))["result"]
            torch.cuda.synchronize()
            launches = kernels.launches()
        idle = [name for name in SWEEP_KERNELS[kind] if launches[name] == 0]
        if idle or k9_calls[0] == 0:
            raise AssertionError(f"{kind} sweep route never launched {idle} (K9 calls {k9_calls[0]})")
        started = time.perf_counter()
        direct = sweep.run_sweep(
            store, {**body, "sweep_name": f"product_{kind}_direct"}, jobs=JobManager(),
            coalescer=Coalescer(window_s=0.0), models_dir=os.path.join(folder, "direct_sweeps"),
            device=STACK_DEVICE,
        )
        walls[f"run_sweep {kind} (direct)"] = time.perf_counter() - started
        if answer["points"] != direct["points"] or answer["best"] != direct["best"]:
            raise AssertionError(f"{kind} sweep: the route's points differ from run_sweep's")
        expected = load_model(answer["model_checkpoint"], device=STACK_DEVICE).predict(X_rows).tolist()
        status, predicted = client.call(
            "POST", f"/models/{answer['model']}/predict", {"rows": X_rows.tolist()}
        )
        if status != 200 or predicted["result"]["predictions"] != expected:
            raise AssertionError(f"{kind} sweep winner answered {status} {predicted}")
        results[kind] = {
            "points": len(answer["points"]), "best": answer["best"],
            "best_accuracy": answer["points"][answer["best"]]["accuracy"],
            "bit_equal_to_run_sweep": True,
            "launches": {name: launches[name] for name in SWEEP_KERNELS[kind]}, "k9_calls": k9_calls[0],
        }
    return results


class _LoggedChild:
    """A child process of this repository's code (the repository on its
    ``PYTHONPATH``), its output in a log file."""

    def __init__(self, command: list, env: dict, log_path: str):
        env = {**env, "PYTHONPATH": ROOT + os.pathsep + env.get("PYTHONPATH", ""), "PYTHONUNBUFFERED": "1"}
        self.log_path = log_path
        self.log = open(log_path, "w")
        self.process = subprocess.Popen(command, env=env, stdout=self.log, stderr=subprocess.STDOUT, cwd=ROOT)

    def lines(self) -> list:
        with open(self.log_path) as handle:
            return handle.read().splitlines()

    def wait_for(self, marker: str, timeout_s: float, what: str) -> list:
        """The log's lines once one holds ``marker``; raises when the
        child dies or the time passes first (:class:`_PortTaken` when it
        died because its port was taken)."""
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            lines = self.lines()
            if any(marker in line for line in lines):
                return lines
            if self.process.poll() is not None:
                break
            time.sleep(0.05)
        lines = self.lines()
        if self.process.poll() is not None and _port_taken(lines):
            raise _PortTaken(f"{what}: its port was taken")
        raise AssertionError(f"{what} never served:\n" + "\n".join(lines[-40:]))

    def stop(self) -> None:
        if self.process.poll() is None:
            self.process.terminate()
            try:
                self.process.wait(timeout=15)
            except subprocess.TimeoutExpired:
                self.process.kill()
                self.process.wait(timeout=15)
        self.log.close()


class _RunnerChild(_LoggedChild):
    """``python -m learningorchestra_tpu_torch.services.runner`` as a child
    on the card."""

    def __init__(self, folder: str, log_name: str, extra_env: dict):
        env = {
            **os.environ, "LO_EPHEMERAL": "1",
            "LO_DATA_DIR": os.path.join(folder, "lo_data"),
            "LO_MODELS_DIR": os.path.join(folder, "models"),
            "LO_BUILD_WORKERS": "1", "LO_PROGRAM_ROW_STEPS": DRILL_ROW_STEPS,
        }
        env.pop("LO_FAULT_BUILDER_PHASE", None)
        super().__init__(RUNNER_COMMAND, {**env, **extra_env}, os.path.join(folder, log_name))
        self.clients: dict = {}

    def wait_serving(self, timeout_s: float = 300) -> None:
        import re

        for line in self.wait_for("serving all services", timeout_s, "the runner"):
            match = re.search(r"service (\w+) on [\d.]+:(\d+)", line)
            if match:
                self.clients[match.group(1)] = _Client(int(match.group(2)))


def _metric_total(text: str, name: str) -> float:
    total, seen = 0.0, False
    for line in text.splitlines():
        if line.startswith(name) and (line[len(name)] in " {"):
            total += float(line.rsplit(" ", 1)[1])
            seen = True
    if not seen:
        raise AssertionError(f"{name} missing from /metrics")
    return total


def _segment_journaled(client) -> bool:
    skip = 0
    while True:
        status, page = client.call("GET", f"/files/__lo_jobs__?skip={skip}&limit=20&query={{}}")
        if status != 200 or not page["result"]:
            return False
        if any(doc.get("event") == "progress" and doc.get("kind") == "segment" for doc in page["result"]):
            return True
        skip += len(page["result"])


def _drill_metrics(client, name: str) -> "dict | None":
    metrics = {}
    for classifier in MODEL_NAMES:
        status, page = client.call("GET", f"/files/{name}_prediction_{classifier}?skip=0&limit=1&query={{}}")
        if status != 200 or not page["result"] or "accuracy" not in page["result"][0]:
            return None
        metrics[classifier] = (page["result"][0]["accuracy"], page["result"][0]["F1"])
    return metrics


def _drill_ingest(runner: "_RunnerChild", walls: dict, name: str, path: str) -> None:
    _ingest_over_rest(runner.clients["database_api"], walls, name, path)
    types = {f"f{i}": "number" for i in range(FEATURES)}
    types["label"] = "number"
    _timed(walls, f"PATCH /fieldtypes {name}", runner.clients["data_type_handler"], "PATCH",
           f"/fieldtypes/{name}", types, expect=(200,))


def _stack_drill(torch, folder: str, walls: dict) -> dict:
    """kill -9 mid-build, restart on the same data directory, and the
    build finishes with the metrics of an uninterrupted one."""
    X, y = bench_synthetic(FIT_ROWS)
    csv_path = os.path.join(folder, "drill.csv")
    with open(csv_path, "w") as handle:
        handle.write(",".join([f"f{i}" for i in range(FEATURES)] + ["label"]) + "\n")
        for row, label in zip(X[:DRILL_ROWS], y[:DRILL_ROWS]):
            handle.write(",".join(repr(float(v)) for v in row) + f",{int(label)}\n")
    body = _build_body("drill", "drill", PRODUCT_PREPROCESSOR, True)
    job = f"build:drill:{'+'.join(MODEL_NAMES)}"
    first = _RunnerChild(folder, "first.log", {"LO_FAULT_BUILDER_PHASE": DRILL_DELAY})
    second = None
    try:
        started = time.perf_counter()
        first.wait_serving()
        walls["drill boot"] = time.perf_counter() - started
        _drill_ingest(first, walls, "drill", csv_path)
        answer = _timed(walls, "POST /models drill (async)", first.clients["model_builder"], "POST",
                        "/models", body, expect=(201,))
        if answer.get("job") != job:
            raise AssertionError(f"the drill build answered {answer}")
        deadline = time.time() + 300
        while not _segment_journaled(first.clients["database_api"]):
            if time.time() > deadline:
                raise AssertionError("no segment progress was ever journaled")
            time.sleep(0.05)
        first.process.kill()   # SIGKILL
        first.process.wait(timeout=30)
        if first.process.returncode != -9:
            raise AssertionError(f"the runner ended {first.process.returncode}, not by SIGKILL")
        restarted = time.perf_counter()
        second = _RunnerChild(folder, "second.log", {})
        second.wait_serving()
        walls["drill restart to serving"] = time.perf_counter() - restarted
        if not any("job recovery: 1 re-enqueued" in line for line in second.lines()):
            raise AssertionError("the restarted runner re-enqueued nothing:\n" + "\n".join(second.lines()))
        files = second.clients["database_api"]
        deadline = time.time() + 600
        while True:
            status, record = second.clients["model_builder"].call("GET", f"/jobs/{job}")
            if status == 200 and record["result"]["state"] in ("finished", "failed", "cancelled"):
                break
            if time.time() > deadline:
                raise AssertionError(f"the resumed build never ended: {status} {record}")
            time.sleep(0.1)
        walls["drill restart to finished"] = time.perf_counter() - restarted
        if record["result"]["state"] != "finished":
            raise AssertionError(f"the resumed build ended {record['result']}")
        resumed = _drill_metrics(files, "drill")
        status, page = files.call("GET", f"/files/drill?skip={DRILL_ROWS}&limit=20&query={{}}")
        if status != 200 or [doc["_id"] for doc in page["result"]] != [DRILL_ROWS]:
            raise AssertionError(f"the drill collection lost rows: {status} {page}")
        metrics_text = files.opener.open(files.base + "/metrics", timeout=60).read().decode()
        skipped = _metric_total(metrics_text, "lo_build_segments_skipped_total")
        resumed_jobs = _metric_total(metrics_text, "lo_sched_resumed_total")
        if skipped < 1 or resumed_jobs < 1:
            raise AssertionError(f"segments skipped {skipped}, jobs resumed {resumed_jobs}")
        _drill_ingest(second, walls, "drill_ctl", csv_path)
        started = time.perf_counter()
        _timed(walls, "POST /models drill_ctl (sync)", second.clients["model_builder"], "POST", "/models",
               _build_body("drill_ctl", "drill_ctl", PRODUCT_PREPROCESSOR, False), expect=(201,))
        control = _drill_metrics(files, "drill_ctl")
        if resumed != control:
            raise AssertionError(f"resumed metrics {resumed}, uninterrupted {control}")
        return {
            "rows": DRILL_ROWS, "segments_skipped": skipped, "jobs_resumed": resumed_jobs,
            "metrics": {name: {"accuracy": a, "F1": f} for name, (a, f) in resumed.items()},
            "equal_to_uninterrupted": True, "rows_kept": DRILL_ROWS,
        }
    finally:
        first.stop()
        if second is not None:
            second.stop()


def phase_stack(torch, card: str) -> dict:
    """Crash resume in process on the kernels, the runner's stack over
    HTTP (the Titanic walkthrough, the sweep routes), and the kill -9
    drill on a child runner; ``device=None`` throughout."""
    from learningorchestra_tpu_torch.ml import base
    from learningorchestra_tpu_torch.services.runner import start_all

    record = {"phase": "stack", "nvidia_smi": card}
    walls: dict = {}
    with tempfile.TemporaryDirectory() as folder:
        X, y = bench_synthetic(FIT_ROWS)
        scale, base._PROGRAM_BUDGET_SCALE = base._PROGRAM_BUDGET_SCALE, STACK_SEGMENT_SCALE
        try:
            record["resume"] = {kind: _resume_fit(torch, kind, X, y, folder) for kind in ("gbt", "logistic")}
        finally:
            base._PROGRAM_BUDGET_SCALE = scale
        del X, y
        store = InMemoryStore(data_dir=os.path.join(folder, "lo_data"))
        started = time.perf_counter()
        _, servers = start_all(
            store, os.path.join(folder, "images"), ephemeral=True, models_dir=os.path.join(folder, "models"),
            device=STACK_DEVICE,
        )
        walls["start_all"] = time.perf_counter() - started
        try:
            clients = _service_clients(servers)
            record["titanic"] = _stack_titanic(torch, clients, store, folder, walls)
            started = time.perf_counter()
            product_store(store)
            walls["product collections"] = time.perf_counter() - started
            record["sweeps"] = _stack_sweeps(torch, clients["model_builder"], store, folder, walls)
        finally:
            for server in servers:
                server.stop()
        record["drill"] = _stack_drill(torch, folder, walls)
    record["walls_s"] = walls
    emit(record)
    return record


# --------------------------------------------------------------------------
# The batch predictions lane and the device cache
# --------------------------------------------------------------------------

BATCH_ROWS = 1_000_000        # the batch lane's test collection
BATCH_TEST = "batch_1m"
# the store and shards phases' test collection: their checks (labels equal
# to the in-process store's, the ring and the body, the slabs and the
# stripes over both groups) hold at any size, and the host's parse, write
# and cast of 1,000,000 rows took most of their minutes
STORE_BATCH_ROWS = 250_000


def batch_test_collection(store, seed: int = 2, rows: "int | None" = None) -> float:
    """A test collection of the product path's schema (16 features and
    the label, bench.py's synthetic rows from another seed), ``rows``
    rows (BATCH_ROWS when None) written columnar as ``embed_store`` writes
    ``blobs_1m``; returns the seconds the write took."""
    from learningorchestra_tpu_torch.core.table import ColumnTable, write_table

    started = time.perf_counter()
    X, y = bench_synthetic(BATCH_ROWS if rows is None else rows, seed)
    columns = {f"f{i}": X[:, i].astype(np.float64) for i in range(FEATURES)}
    columns["label"] = y.astype(np.float64)
    write_table(
        store, BATCH_TEST, ColumnTable(columns),
        {"filename": BATCH_TEST, "finished": True, "fields": list(columns)},
    )
    return time.perf_counter() - started


def _batch_body(out: str) -> dict:
    return {
        "training_filename": "bench_train", "test_filename": BATCH_TEST,
        "preprocessor_code": PRODUCT_PREPROCESSOR, "prediction_filename": out,
    }


def _batch_request(torch, client, store, name: str, out: str) -> dict:
    """One ``POST /models/<name>/predictions`` over HTTP: its wall and the
    stored metadata's ``timings``."""
    torch.cuda.synchronize()
    started = time.perf_counter()
    status, answer = client.call(
        "POST", f"/models/bench_test_prediction_{name}/predictions", _batch_body(out)
    )
    wall_s = time.perf_counter() - started
    if (status, answer) != (201, {"result": "created_file"}):
        raise AssertionError(f"batch {name}: POST /predictions answered {status} {answer}")
    metadata = store.find_one(out, {"_id": 0})
    return {"wall_s": wall_s, "timings": metadata["timings"], "rows": store.count(out) - 1}


def _f32_metrics(store) -> dict:
    return {
        name: {
            key: float(store.find_one(f"bench_test_prediction_{name}", {"_id": 0})[key])
            for key in ("accuracy", "F1")
        }
        for name in MODEL_NAMES
    }


def phase_batch(torch, card: str) -> dict:
    """The batch predictions lane over HTTP on the card. The five
    classifiers are built on the product store (100,000 rows), a
    1,000,000-row test collection is added, and ``POST
    /models/<name>/predictions`` predicts it from each ``.model`` (the
    launch counts set to 0 just before the five requests and read just
    after: K6's ensemble and gb forwards must have launched). Every
    written prediction equals ``load_model``'s prediction of the
    preprocessed test frame. A second request over the same collections
    reads and copies nothing again (devcache hits, no new misses, no
    host-to-device bytes); a row inserted into the test collection moves
    its rev and the next request reads it again. Evicting the cached
    device matrices frees their bytes on the card."""
    import gc

    from learningorchestra_tpu_torch.core import devcache
    from learningorchestra_tpu_torch.frame.pyspark_compat import run_preprocessor
    from learningorchestra_tpu_torch.ml import base
    from learningorchestra_tpu_torch.ml.builder import load_dataframe

    cache = devcache.global_devcache()
    with tempfile.TemporaryDirectory() as folder:
        store = product_store()
        write_s = batch_test_collection(store)
        plane = ServePlane()
        server = ServerThread(create_app(store, models_dir=os.path.join(folder, "models"), serve=plane)).start()
        try:
            client = _Client(server.port)
            started = time.perf_counter()
            status, answer = client.call("POST", "/models", _build_body("bench_train", "bench_test", PRODUCT_PREPROCESSOR, False))
            build_s = time.perf_counter() - started
            if (status, answer) != (201, {"result": "created_file"}):
                raise AssertionError(f"batch: the build answered {status} {answer}")
            _settled_jobs(client, BENCH_WARMUPS)   # they copy rows too: done before the cache checks
            torch.cuda.synchronize()
            kernels.reset_launches()
            requests = {name: _batch_request(torch, client, store, name, f"batch_{name}") for name in MODEL_NAMES}
            torch.cuda.synchronize()
            launches = kernels.launches()
            for name in ("tree_ensemble_forward", "gbt_forward"):
                if launches[name] == 0:
                    raise AssertionError(f"batch: {name} never launched")
            frames = run_preprocessor(
                PRODUCT_PREPROCESSOR, load_dataframe(store, "bench_train"), load_dataframe(store, BATCH_TEST)
            )
            X_test = frames["features_testing"].feature_matrix("features")
            for name in MODEL_NAMES:
                stored = store.read_column_arrays(f"batch_{name}", ["prediction"])["prediction"].to_float64()
                model = load_model(store.find_one(f"batch_{name}", {"_id": 0})["model_checkpoint"])
                if len(stored) != BATCH_ROWS or not np.array_equal(model.predict(X_test), stored):
                    raise AssertionError(f"batch {name}: the written predictions are not its checkpoint's")
            # the same collections again: every read and copy is a cache hit
            before, copied = cache.stats(), base.h2d_bytes()
            again = _batch_request(torch, client, store, "gb", "batch_gb_again")
            after = cache.stats()
            if after["misses"] != before["misses"] or after["hits"] < before["hits"] + 3 or (
                base.h2d_bytes() != copied
            ):
                raise AssertionError(
                    f"batch: the second request missed the cache ({before} -> {after}, "
                    f"{base.h2d_bytes() - copied} bytes copied)"
                )
            # a write moves the test collection's rev: the next request reads it again
            row = {f"f{i}": 1.0 for i in range(FEATURES)}
            store.insert_one(BATCH_TEST, {**row, "label": 0.0})
            moved = _batch_request(torch, client, store, "gb", "batch_gb_moved")
            reloaded = cache.stats()
            if moved["rows"] != BATCH_ROWS + 1 or reloaded["invalidations"] <= after["invalidations"] or (
                base.h2d_bytes() <= copied
            ):
                raise AssertionError(f"batch: the insert did not reload the collection ({reloaded})")
            f32_metrics = _f32_metrics(store)
        finally:
            server.stop()
            plane.close()
        # evicting the cached device matrices frees them on the card
        del frames, X_test
        gc.collect()
        torch.cuda.synchronize()
        held = sum(
            entry.nbytes for key, entry in cache._entries.items()
            if key[0] == devcache.CONTENT and key[2][0] in ("devmat", "devlab")
        )
        allocated = torch.cuda.memory_allocated()
        dropped = cache.invalidate(devcache.CONTENT)
        gc.collect()
        torch.cuda.synchronize()
        freed = allocated - torch.cuda.memory_allocated()
        if freed < held:
            raise AssertionError(f"batch: evicting {held} cached bytes freed {freed} on the card")
    record = {
        "phase": "batch",
        "test_rows": BATCH_ROWS,
        "test_write_s": write_s,
        "build_s": build_s,
        "requests": requests,
        "launches": {name: launches[name] for name in ("tree_ensemble_forward", "gbt_forward")},
        "cached_request": again,
        "devcache": {"first": before, "second": after, "after_insert": reloaded},
        "moved_request": moved,
        "evicted": {"entries": dropped, "bytes": held, "freed_bytes": freed},
        "f32_metrics": f32_metrics,
        "nvidia_smi": card,
    }
    emit(record)
    return record


# --------------------------------------------------------------------------
# The networked store: a primary and a follower store server in child
# processes, the stack in this process over a RemoteStore
# --------------------------------------------------------------------------

STORE_SERVER_COMMAND = [sys.executable, "-m", "learningorchestra_tpu_torch.core.store_service"]
# the ring a client creates: a 1,000,000-row frame of the test collection
# (17 float64 columns and the ids, ~136 MB in one LO_WIRE_ROWS_BIN chunk)
# fits, with room for the read-ahead's frame
STORE_SHM_BYTES = 512 * 2**20
STORE_AUTO_PROMOTE_S = "2"       # the follower's LO_AUTO_PROMOTE_S
STORE_ACK_TIMEOUT_S = "60"       # sync replication waits this long for the follower
STORE_BOOT_TIMEOUT_S = 120
STORE_PROMOTE_TIMEOUT_S = 60
STORE_DEVICE = None              # the stack's device: the CUDA card
STORE_FAILOVER_TEST = "bench_test_failover"   # the test rows of the build after the kill


def _free_port() -> int:
    """A port free now. Another process may bind it before the child it
    is meant for does, so only a port that must be known before its
    child binds is picked here (a peer's URL, ``LO_PLANE_MEMBERS``, the
    ranks' rendezvous), and :func:`_on_new_ports` starts again when it
    was taken; every other HTTP child binds port 0 and names its port in
    its log."""
    import socket

    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


PORT_RETRIES = 2   # starts again on new ports after a taken one, at most


class _PortTaken(AssertionError):
    """A child found the port picked for it taken."""


def _port_taken(lines) -> bool:
    return any("address already in use" in line.lower() for line in lines)


def _on_new_ports(start, what: str):
    """``start()``, which picks its ports with :func:`_free_port`, starts
    its children on them, waits until they serve and stops them before
    it raises; where a child found its port taken (:class:`_PortTaken`),
    once more on new ports, at most ``PORT_RETRIES`` times, each retry
    printed."""
    for attempt in range(PORT_RETRIES + 1):
        try:
            return start()
        except _PortTaken as taken:
            if attempt == PORT_RETRIES:
                raise
            print(f"chip_smoke: {what}: {taken}; starting again on new ports "
                  f"(retry {attempt + 1} of {PORT_RETRIES})", flush=True)


def _stop_collectors(stores) -> None:
    """Stop the TSDB collectors ``start_all`` started in this process for
    ``stores`` (``services/runner._COLLECTORS``), before their servers
    stop: a collector left running posts to a store that is gone."""
    from learningorchestra_tpu_torch.services import runner

    with runner._COLLECTORS_LOCK:
        collectors = [runner._COLLECTORS.pop(id(store), None) for store in stores]
    for collector in collectors:
        if collector is not None:
            collector.stop()


class _StoreServer(_LoggedChild):
    """``python -m learningorchestra_tpu_torch.core.store_service`` as a
    child process, on ``port`` (0: one the system picks, read from its
    boot line). A new start of ``name`` begins on an empty data folder."""

    def __init__(self, folder: str, name: str, port: int = 0, extra_env: "dict | None" = None):
        import shutil

        data_dir = os.path.join(folder, name)
        shutil.rmtree(data_dir, ignore_errors=True)
        env = {
            **os.environ, "LO_STORE_PORT": str(port), "LO_DATA_DIR": data_dir,
            "LO_NODE_ID": name, "LO_SHM_BYTES": str(STORE_SHM_BYTES), **(extra_env or {}),
        }
        super().__init__(STORE_SERVER_COMMAND, env, os.path.join(folder, f"{name}.log"))
        self.name = name
        self.url = f"http://127.0.0.1:{port}" if port else None

    def wait_serving(self) -> None:
        import re

        for line in self.wait_for("store server on", STORE_BOOT_TIMEOUT_S, f"store server {self.name}"):
            match = re.search(r"store server on [\d.]+:(\d+)", line)
            if match:
                self.url = f"http://127.0.0.1:{match.group(1)}"


def _replicated_pairs(folder: str, names: list) -> list:
    """A primary and its follower (sync replication, each the other's
    peer, the follower promoting itself after ``STORE_AUTO_PROMOTE_S``)
    for each ``(primary, follower)`` of ``names``, all serving: the
    primaries on ports the system picks, then the followers on ports
    picked first (each primary's ``LO_PEERS`` names its follower). On a
    failure every server started is stopped."""
    f_ports = [_free_port() for _ in names]
    started = []
    try:
        primaries = []
        for (primary, _), f_port in zip(names, f_ports):
            primaries.append(_StoreServer(folder, primary, 0, {
                "LO_REPLICATE": "1", "LO_STORE_SYNC_REPL": "1", "LO_STORE_ACK_TIMEOUT_S": STORE_ACK_TIMEOUT_S,
                "LO_PEERS": f"http://127.0.0.1:{f_port}",
            }))
            started.append(primaries[-1])
        for server in primaries:
            server.wait_serving()
        followers = []
        for (_, follower), f_port, primary in zip(names, f_ports, primaries):
            followers.append(_StoreServer(folder, follower, f_port, {
                "LO_PRIMARY_URL": primary.url, "LO_PEERS": primary.url,
                "LO_AUTO_PROMOTE_S": STORE_AUTO_PROMOTE_S,
            }))
            started.append(followers[-1])
        for server in followers:
            server.wait_serving()
    except BaseException:
        for server in started:
            server.stop()
        raise
    return list(zip(primaries, followers))


class _WireRoads:
    """What a RemoteStore's paged binary reads decoded, road by road:
    frames and bytes copied out of the shared-memory ring (numpy buffers)
    and read from the HTTP body (bytes); and its rev probes over the wire
    (``GET /c/<name>/rev``)."""

    def __init__(self, store):
        self.frames = {"ring": 0, "body": 0}
        self.bytes = {"ring": 0, "body": 0}
        self.rev_probes = 0
        decode, rev = store._decode_chunk, store.collection_rev

        def counted_decode(collection, fields, chunk_start, chunk_limit, raw):
            road = "ring" if isinstance(raw, np.ndarray) else "body"
            self.frames[road] += 1
            self.bytes[road] += len(raw)
            return decode(collection, fields, chunk_start, chunk_limit, raw)

        def counted_rev(collection):
            self.rev_probes += 1
            return rev(collection)

        store._decode_chunk = counted_decode
        store.collection_rev = counted_rev

    def snapshot(self) -> dict:
        return {"frames": dict(self.frames), "bytes": dict(self.bytes), "rev_probes": self.rev_probes}


def _remote_store(urls: str, shm_bytes: int):
    """``connect(urls)``, its ring of ``shm_bytes`` (what ``LO_SHM_BYTES``
    sets; 0: none), and the counter of its roads."""
    from learningorchestra_tpu_torch.core.store_service import connect

    store = connect(urls)
    store.shm_bytes = shm_bytes
    return store, _WireRoads(store)


def _copy_product_test(source, target, name: str) -> None:
    """``bench_test``'s rows under another name, written as product_store
    writes them."""
    fields = [f"f{i}" for i in range(FEATURES)] + ["label"]
    target.create_collection(name)
    target.insert_one(name, {"_id": 0, "filename": name, "finished": True, "fields": fields})
    target.insert_column_arrays(name, source.read_column_arrays("bench_test", fields))


# the publish-time warmups of a build of bench_test: each copies its rows
# to the card and runs a forward, so a check of bytes or launches after
# that build waits for them (_settled_jobs)
BENCH_WARMUPS = [f"warmup:bench_test_prediction_{name}.model" for name in MODEL_NAMES]


def _store_build(client, store, test: str, run_async: bool) -> dict:
    """One five-classifier ``POST /models`` (async: waited on through
    ``/wait``); its wall and each classifier's stored metrics."""
    job = f"build:{test}:{'+'.join(MODEL_NAMES)}"
    started = time.perf_counter()
    status, answer = client.call("POST", "/models", _build_body("bench_train", test, PRODUCT_PREPROCESSOR, run_async))
    if (status, answer) != (201, {"result": "created_file", **({"job": job} if run_async else {})}):
        raise AssertionError(f"store: the build of {test} answered {status} {answer}")
    while run_async:
        status, waited = client.call("GET", f"/jobs/{job}/wait?timeout=60")
        if status != 200:
            raise AssertionError(f"store: /wait answered {status} {waited}")
        if waited["result"] != "timeout":
            if waited["result"]["state"] != "finished":
                raise AssertionError(f"store: the async build ended {waited['result']}")
            break
    wall_s = time.perf_counter() - started
    metrics = {
        name: {key: float(store.find_one(f"{test}_prediction_{name}", {"_id": 0})[key]) for key in ("accuracy", "F1")}
        for name in MODEL_NAMES
    }
    return {"wall_s": wall_s, "metrics": metrics}


def _labels(store, collection: str) -> np.ndarray:
    return store.read_column_arrays(collection, ["prediction"])["prediction"].to_float64()


def _same_labels(what: str, got: np.ndarray, want: np.ndarray) -> None:
    if len(got) != STORE_BATCH_ROWS or not np.array_equal(got, want):
        raise AssertionError(f"store: {what}'s labels differ from the in-process store's")


def phase_store(torch, card: str) -> dict:
    """The stack over the networked store. A primary (``LO_REPLICATE=1``,
    ``LO_STORE_SYNC_REPL=1``) and a follower (``LO_PRIMARY_URL``,
    ``LO_AUTO_PROMOTE_S``; both ``LO_PEERS``) run as store server child
    processes; the seven services run in this process (``start_all``)
    on the card over ``connect("primary,follower")``, whose client owns a
    shared-memory ring. The product collections (100,000 rows) and a
    STORE_BATCH_ROWS-row test collection go in through the binary verbs.
    With the launch counts set to 0 first: a sync product build, whose
    metrics equal an in-process ``InMemoryStore`` build's on the same data;
    a batch request (gb, STORE_BATCH_ROWS rows) whose labels equal the same
    request's over the ``InMemoryStore``, with ``load_data`` read over
    the ring, and again from a client with ``LO_SHM_BYTES=0``, over the
    HTTP body (then the test collection's read alone by each road, in
    turns ring, body, body, ring); a repeat that probes the revs over the wire, hits the
    device cache and copies nothing; a ``set_column_bin`` from another
    client that rewrites one feature with its own values, which moves
    the rev, and the reread that follows. Then ``kill -9`` of the
    primary: the follower promotes itself (its time from the kill and
    its loss window, 0 under sync replication), and an async build to
    ``finished`` and a batch request give the values from before the
    kill. Every kernel of the build (K1 to K7, K6 both forwards)
    launched in the phase."""
    import signal

    from learningorchestra_tpu_torch.core import devcache
    from learningorchestra_tpu_torch.core.store_service import probe_health
    from learningorchestra_tpu_torch.ml import base
    from learningorchestra_tpu_torch.services import runner

    started = time.perf_counter()
    cache = devcache.global_devcache()
    with tempfile.TemporaryDirectory() as folder:
        # the in-process reference: the same data, the same requests
        local = product_store()
        batch_test_collection(local, rows=STORE_BATCH_ROWS)
        server = ServerThread(create_app(local, models_dir=os.path.join(folder, "local_models"))).start()
        try:
            client = _Client(server.port)
            local_build = _store_build(client, local, "bench_test", False)
            _batch_request(torch, client, local, "gb", "batch_gb")
        finally:
            server.stop()
        want_labels = _labels(local, "batch_gb")

        # the primary binds port 0; its LO_PEERS names the follower's
        # port, picked before the follower binds it
        primary, follower = _on_new_ports(lambda: _replicated_pairs(folder, [("primary", "follower")])[0],
                                          "store: the replicated pair")
        p_url, f_url = primary.url, follower.url
        servers = []
        rings = []
        try:
            boot_s = time.perf_counter() - started
            urls = f"{p_url},{f_url}"
            remote, roads = _remote_store(urls, STORE_SHM_BYTES)
            rings.append(remote)
            ingest_started = time.perf_counter()
            product_store(remote)
            batch_test_collection(remote, rows=STORE_BATCH_ROWS)
            _copy_product_test(local, remote, STORE_FAILOVER_TEST)
            ingest_s = time.perf_counter() - ingest_started

            torch.cuda.synchronize()
            kernels.reset_launches()
            _, servers = runner.start_all(
                remote, os.path.join(folder, "images"), ephemeral=True,
                models_dir=os.path.join(folder, "models"), device=STORE_DEVICE,
            )
            builder = next(s for s in servers if s.canonical_port == runner.SERVICES["model_builder"])
            client = _Client(builder.port)
            build = _store_build(client, remote, "bench_test", False)
            _settled_jobs(client, BENCH_WARMUPS)   # they copy rows too: done before the cache checks
            if build["metrics"] != local_build["metrics"]:
                raise AssertionError(
                    f"store: the build's metrics {build['metrics']} are not the in-process store's "
                    f"{local_build['metrics']}"
                )
            # a batch request: its tables read over the ring (the build's
            # cached training table dropped, so that it reads what the
            # ringless client's request reads below)
            cache.invalidate(scope=devcache.store_token(remote))
            ring_before = remote.shm_stats() or {"frames": 0, "bytes": 0}
            roads_before = roads.snapshot()
            over_ring = _batch_request(torch, client, remote, "gb", "batch_gb")
            over_ring["shm"] = _delta(remote.shm_stats(), ring_before)
            over_ring["roads"] = _roads_delta(roads.snapshot(), roads_before)
            _same_labels("the batch request over the ring", _labels(remote, "batch_gb"), want_labels)
            if over_ring["shm"]["frames"] == 0 or over_ring["roads"]["frames"]["ring"] == 0:
                raise AssertionError(f"store: the batch request read nothing over the ring {over_ring}")
            # the same request from a client without a ring: over the body
            plain, plain_roads = _remote_store(urls, 0)
            body_server = ServerThread(
                create_app(plain, models_dir=os.path.join(folder, "models"))
            ).start()
            try:
                over_body = _batch_request(torch, _Client(body_server.port), plain, "gb", "batch_gb_body")
            finally:
                body_server.stop()
            over_body["shm"] = plain.shm_stats()
            over_body["roads"] = plain_roads.snapshot()
            _same_labels("the batch request over the body", _labels(plain, "batch_gb_body"), want_labels)
            if over_body["roads"]["frames"]["ring"] or not over_body["roads"]["bytes"]["body"]:
                raise AssertionError(f"store: the ringless client's bytes took the ring {over_body}")
            # the test collection's paged read alone, by each road in turns
            reads = {"ring": [], "body": []}
            for road, reader in (("ring", remote), ("body", plain), ("body", plain), ("ring", remote)):
                read_started = time.perf_counter()
                reader.read_column_arrays(BATCH_TEST)
                reads[road].append(time.perf_counter() - read_started)
            # a repeat: revs probed over the wire, cache hits, nothing copied
            before, copied, probes = cache.stats(), base.h2d_bytes(), roads.rev_probes
            again = _batch_request(torch, client, remote, "gb", "batch_gb_again")
            after = cache.stats()
            again["rev_probes"] = roads.rev_probes - probes
            again["devcache"] = {"before": before, "after": after, "copied_bytes": base.h2d_bytes() - copied}
            if (after["misses"] != before["misses"] or after["hits"] <= before["hits"]
                    or again["devcache"]["copied_bytes"] or not again["rev_probes"]):
                raise AssertionError(f"store: the repeat missed the cache or probed no rev {again}")
            # another client rewrites a feature with its own values: the rev moves
            writer, _ = _remote_store(urls, 0)
            rev_before = remote.collection_rev(BATCH_TEST)
            values = writer.read_column_arrays(BATCH_TEST, ["f0"])["f0"].to_float64()
            writer.set_column(BATCH_TEST, "f0", values)
            rev_after = remote.collection_rev(BATCH_TEST)
            if rev_after == rev_before:
                raise AssertionError("store: set_column_bin did not move the collection's rev")
            moved = _batch_request(torch, client, remote, "gb", "batch_gb_moved")
            reread = cache.stats()
            moved["devcache"] = reread
            _same_labels("the request after the rewrite", _labels(remote, "batch_gb_moved"), want_labels)
            if reread["misses"] <= after["misses"] or reread["invalidations"] <= after["invalidations"]:
                raise AssertionError(f"store: the rewrite did not make the next request reread ({reread})")
            # failover: kill -9 the primary, the follower takes over
            health_before = probe_health(f_url)
            primary.process.send_signal(signal.SIGKILL)
            killed = time.perf_counter()
            primary.process.wait(timeout=15)
            promoted = None
            while time.perf_counter() - killed < STORE_PROMOTE_TIMEOUT_S:
                health = probe_health(f_url, timeout=1.0)
                if health and health.get("writable"):
                    promoted = time.perf_counter() - killed
                    break
                time.sleep(0.02)
            if promoted is None:
                raise AssertionError("store: the follower never promoted:\n" + "\n".join(follower.lines()[-20:]))
            loss = health.get("loss_window") or {}
            if loss.get("records") != 0 or health.get("term", 0) < 2:
                raise AssertionError(f"store: the promotion lost acknowledged records: {health}")
            failover_started = time.perf_counter()
            after_kill = _store_build(client, remote, STORE_FAILOVER_TEST, True)
            if after_kill["metrics"] != local_build["metrics"]:
                raise AssertionError(f"store: the async build after the kill gave {after_kill['metrics']}")
            after_kill_batch = _batch_request(torch, client, remote, "gb", "batch_gb_failover")
            _same_labels("the batch request after the kill", _labels(remote, "batch_gb_failover"), want_labels)
            failover_s = time.perf_counter() - failover_started
            torch.cuda.synchronize()
            launches = kernels.launches()
            missing = [name for name in BUILD_KERNELS if launches[name] == 0]
            if missing:
                raise AssertionError(f"store: the phase never launched {missing}")
            client_url = remote.base_url
        finally:
            for server in servers:
                server.stop()
            _stop_collectors(rings)
            for store in rings:
                store.close()
            primary.stop()
            follower.stop()
    record = {
        "phase": "store",
        "rows": {"train": PRODUCT_ROWS, "test": PRODUCT_ROWS, "batch_test": STORE_BATCH_ROWS},
        "shm_bytes": STORE_SHM_BYTES,
        "boot_s": boot_s,
        "ingest_s": ingest_s,
        "build": build,
        "local_build": local_build,
        "batch_over_ring": over_ring,
        "batch_over_body": over_body,
        "test_reads_s": reads,
        "batch_again": again,
        "rev": {"before": rev_before, "after": rev_after},
        "batch_after_rewrite": moved,
        "failover": {
            "health_before": health_before,
            "promote_s": promoted,
            "term": health["term"],
            "loss_window": loss,
            "client_now_at": client_url == f_url,
            "async_build": after_kill,
            "batch": after_kill_batch,
            "after_kill_s": failover_s,
        },
        "launches": {name: launches[name] for name in BUILD_KERNELS},
        "phase_s": time.perf_counter() - started,
        "nvidia_smi": card,
    }
    emit(record)
    return record


def _delta(now: "dict | None", before: dict) -> dict:
    now = now or {"frames": 0, "bytes": 0}
    return {key: now[key] - before.get(key, 0) for key in now}


def _roads_delta(now: dict, before: dict) -> dict:
    return {
        "frames": {road: now["frames"][road] - before["frames"][road] for road in now["frames"]},
        "bytes": {road: now["bytes"][road] - before["bytes"][road] for road in now["bytes"]},
        "rev_probes": now["rev_probes"] - before["rev_probes"],
    }


# --------------------------------------------------------------------------
# The sharded store: two replicated shard groups, CSVs ingested natively
# in slabs through the database service
# --------------------------------------------------------------------------

SHARDS_GROUPS = 2
SHARDS_STRIPE_ROWS = 8192      # the reference's default stripe (core/shardmap.DEFAULT_STRIPE_ROWS)
SHARDS_SLABS = 5               # LO_INGEST_SLAB_BYTES is set so that the test CSV parses in 5
SHARDS_DEVICE = None           # the stack's device: the CUDA card
SHARDS_FIELDS = tuple(f"f{i}" for i in range(FEATURES)) + ("label",)
SHARDS_INGEST_TIMEOUT_S = 600


def _write_product_csv(path: str, X: np.ndarray, y: np.ndarray) -> None:
    """bench.py's rows as a CSV: each value the shortest text that reads
    back as the same float64, the label an integer."""
    columns = [list(map(repr, X[:, i].astype(np.float64).tolist())) for i in range(X.shape[1])]
    columns.append(list(map(str, y.tolist())))
    with open(path, "w", newline="") as handle:
        handle.write(",".join(SHARDS_FIELDS) + "\n")
        handle.writelines(",".join(row) + "\n" for row in zip(*columns))


def _expected_slabs(path: str, slab_bytes: int) -> int:
    """The slabs ``core/ingest._ingest_slabbed`` cuts ``path`` into: a
    slab ends at the first record past ``slab_bytes`` (the file holds no
    quotes, so every line ends a record)."""
    slabs, filled = 0, 0
    with open(path, encoding="utf-8", newline="") as handle:
        handle.readline()
        for line in handle:
            filled += len(line)
            if filled >= slab_bytes:
                slabs, filled = slabs + 1, 0
    return slabs + (filled > 0)


def _python_ingest(store, name: str, path: str) -> float:
    """``ingest_csv`` as it runs on a host without the native loader: the
    Python parse of the whole file, the same hand-off, the metadata of
    ``POST /files`` with ``file://<path>``; returns its wall."""
    from learningorchestra_tpu_torch.core import ingest

    started = time.perf_counter()
    ingest.write_ingest_metadata(store, name, "file://" + path)
    header, raw_columns = ingest._python_raw_columns(path)
    ingest._insert_parsed(store, name, header, raw_columns, 1, None)
    store.update_one(name, {"_id": 0}, {"finished": True, "fields": header})
    return time.perf_counter() - started


def _column_bytes(column) -> tuple:
    meta, buffers = column.wire_parts()
    return meta, [np.ascontiguousarray(buffer).view(np.uint8) for buffer in buffers]


def _same_collection(what: str, got, want, name: str) -> None:
    """``name`` in ``got`` equals ``name`` in ``want``: the metadata
    document (less its creation time) and every column, byte for byte."""
    metadata = [
        {key: value for key, value in store.find_one(name, {"_id": 0}).items() if key != "time_created"}
        for store in (got, want)
    ]
    if metadata[0] != metadata[1]:
        raise AssertionError(f"shards: {what}: {name}'s metadata {metadata[0]} is not {metadata[1]}")
    fields = ["_id", *SHARDS_FIELDS]
    ours, theirs = got.read_column_arrays(name, fields), want.read_column_arrays(name, fields)
    for field in fields:
        (our_meta, our_buffers), (their_meta, their_buffers) = _column_bytes(ours[field]), _column_bytes(theirs[field])
        if our_meta != their_meta or len(our_buffers) != len(their_buffers) or not all(
            np.array_equal(a, b) for a, b in zip(our_buffers, their_buffers)
        ):
            raise AssertionError(f"shards: {what}: {name}.{field} differs ({our_meta} against {their_meta})")


def _placement(rows: int, groups: int, stripe_rows: int) -> list:
    """Block rows a group holds of ids 1..``rows``, by the port's
    ``ShardLayout`` (the reference's placement, tests/test_torch_shardstore.py)."""
    from learningorchestra_tpu_torch.core.shardmap import ShardLayout

    layout = ShardLayout(groups, stripe_rows)
    held = [0] * groups
    for stripe in range(-(-rows // stripe_rows)):
        held[layout.shard_of_stripe(stripe)] += min(stripe_rows, rows - stripe * stripe_rows)
    return held


def _held_as_placed(sharded, name: str, rows: int) -> list:
    held = [group.collection_block_rows(name) for group in sharded.groups]
    placed = _placement(rows, len(sharded.groups), SHARDS_STRIPE_ROWS)
    if held != placed or sum(held) != rows:
        raise AssertionError(f"shards: {name}'s groups hold {held} block rows, placed {placed}")
    return held


def _shard_gauges(text: str) -> dict:
    """``lo_store_shard_*`` samples of a ``/metrics`` text, by shard."""
    gauges: dict = {}
    for line in text.splitlines():
        if line.startswith("lo_store_shard_") and '{shard="' in line:
            name, rest = line.split("{", 1)
            shard = rest.split('"')[1]
            gauges.setdefault(shard, {})[name] = float(line.rsplit(" ", 1)[1])
    return gauges


def _wait_ingested(store, name: str) -> None:
    deadline = time.time() + SHARDS_INGEST_TIMEOUT_S
    while time.time() < deadline:
        metadata = store.find_one(name, {"_id": 0})
        if metadata and metadata.get("finished"):
            return
        time.sleep(0.05)
    raise AssertionError(f"shards: the ingest of {name} never finished")


@contextlib.contextmanager
def _slabs_and_stripes(slab_bytes: int):
    """The knobs of the phase: ``core/ingest._SLAB_BYTES`` (what
    ``LO_INGEST_SLAB_BYTES`` sets when the module loads) and
    ``LO_SHARD_STRIPE_ROWS``, each restored after."""
    from learningorchestra_tpu_torch.core import ingest

    slab_before, stripe_before = ingest._SLAB_BYTES, os.environ.get("LO_SHARD_STRIPE_ROWS")
    ingest._SLAB_BYTES = slab_bytes
    os.environ["LO_SHARD_STRIPE_ROWS"] = str(SHARDS_STRIPE_ROWS)
    try:
        yield
    finally:
        ingest._SLAB_BYTES = slab_before
        if stripe_before is None:
            os.environ.pop("LO_SHARD_STRIPE_ROWS", None)
        else:
            os.environ["LO_SHARD_STRIPE_ROWS"] = stripe_before


def phase_shards(torch, card: str, store_record: "dict | None" = None) -> dict:
    """The stack over two shard groups. Each group is a primary (sync
    replication) and its follower (automatic promotion) as store server
    child processes; the seven services run in this process on the card
    over ``connect("p0,f0;p1,f1")``, a ``ShardedStore`` striping 8,192-row
    stripes over both. bench.py's product rows (100,000 × 16 and the
    label) and a STORE_BATCH_ROWS-row test file of the same columns go in
    as CSVs through ``POST /files``, natively in slabs
    (``LO_INGEST_SLAB_BYTES``: the test file in at least 4, each product
    file in as many as its size gives), then through ``PATCH /fieldtypes``.
    Held, before and after the cast: each collection equals the same CSV
    ingested whole by the Python parser into an in-process
    ``InMemoryStore``, byte for byte; each group's block rows are what
    ``ShardLayout(2, 8192)`` places there; the native parser ran once a
    slab and never fell back; the shard map says 2 groups of 8,192-row
    stripes. With the launch counts set to 0: a sync product build whose
    metrics equal the in-process store's build's, a gb batch request
    over the test rows whose labels equal the in-process request's.
    Then ``kill -9`` of group 1's primary: its follower's promotion
    (seconds, a loss window of 0), a batch request with the labels from
    before, the groups' block rows as placed, model_builder's
    ``/metrics`` with the shard gauges of both groups. K1-K7 and K6
    (both forwards) must launch in the phase. The test CSV's
    ingest wall three ways: native in slabs over the shards, native
    whole and Python whole into an in-process store."""
    import signal

    from learningorchestra_tpu_torch.core import ingest
    from learningorchestra_tpu_torch.core.shardmap import SHARDMAP_COLLECTION, SHARDMAP_DOC_ID
    from learningorchestra_tpu_torch.core.shardstore import ShardedStore
    from learningorchestra_tpu_torch.core.store_service import connect, probe_health
    from learningorchestra_tpu_torch.native import loader
    from learningorchestra_tpu_torch.ops.dtype import convert_field_types
    from learningorchestra_tpu_torch.services import runner

    started = time.perf_counter()
    numbers = {field: "number" for field in SHARDS_FIELDS}
    with tempfile.TemporaryDirectory() as folder:
        X, y = bench_synthetic(FIT_ROWS)
        product_csv, test_csv = os.path.join(folder, "product.csv"), os.path.join(folder, "test_1m.csv")
        _write_product_csv(product_csv, X[:PRODUCT_ROWS], y[:PRODUCT_ROWS])
        X, y = bench_synthetic(STORE_BATCH_ROWS, 2)
        _write_product_csv(test_csv, X, y)
        del X, y
        files = {"bench_train": product_csv, "bench_test": product_csv, BATCH_TEST: test_csv}
        rows = {"bench_train": PRODUCT_ROWS, "bench_test": PRODUCT_ROWS, BATCH_TEST: STORE_BATCH_ROWS}
        test_bytes = os.path.getsize(test_csv)
        slab_bytes = -(-test_bytes // SHARDS_SLABS)
        slabs = _expected_slabs(test_csv, slab_bytes)
        product_slabs = _expected_slabs(product_csv, slab_bytes)
        if slabs < 4:
            raise AssertionError(f"shards: the test CSV cuts into {slabs} slabs of {slab_bytes} bytes")
        csv_s = time.perf_counter() - started

        # the in-process references: the Python parse whole (what every
        # collection is held to), and the native parse whole
        local, native_local = InMemoryStore(), InMemoryStore()
        python_s = {name: _python_ingest(local, name, path) for name, path in files.items()}
        loader.reset_native_stats()
        with _slabs_and_stripes(0):
            native_started = time.perf_counter()
            ingest.write_ingest_metadata(native_local, BATCH_TEST, "file://" + test_csv)
            ingest.ingest_csv(native_local, BATCH_TEST, "file://" + test_csv)
            native_s = time.perf_counter() - native_started
        _same_collection("the native parse in process", native_local, local, BATCH_TEST)
        del native_local

        boot_started = time.perf_counter()
        pairs = _on_new_ports(lambda: _replicated_pairs(
            folder, [(f"primary{group}", f"follower{group}") for group in range(SHARDS_GROUPS)]),
            "shards: the replicated pairs")
        primaries, followers = [p for p, _ in pairs], [f for _, f in pairs]
        urls = [(primary.url, follower.url) for primary, follower in pairs]
        servers, sharded = [], None
        try:
            boot_s = time.perf_counter() - boot_started

            with _slabs_and_stripes(slab_bytes):
                sharded = connect(";".join(f"{p_url},{f_url}" for p_url, f_url in urls))
                if not isinstance(sharded, ShardedStore) or len(sharded.groups) != SHARDS_GROUPS:
                    raise AssertionError(f"shards: connect() gave {sharded!r}")
                for group in sharded.groups:
                    group.shm_bytes = STORE_SHM_BYTES
                _, servers = runner.start_all(
                    sharded, os.path.join(folder, "images"), ephemeral=True,
                    models_dir=os.path.join(folder, "models"), device=SHARDS_DEVICE,
                )
                clients = _service_clients(servers)
                walls: dict = {}
                for name, path in files.items():
                    ingest_started = time.perf_counter()
                    _timed(walls, f"POST /files {name}", clients["database_api"], "POST", "/files",
                           {"filename": name, "url": "file://" + path}, expect=(201,))
                    _wait_ingested(sharded, name)
                    walls[f"ingest {name}"] = time.perf_counter() - ingest_started
            parses = loader.native_stats()
            if parses["fallbacks"] or parses["native_parses"] != 1 + 2 * product_slabs + slabs:
                raise AssertionError(
                    f"shards: the native parser ran {parses} times, not once a slab (the test file's "
                    f"{slabs}, each product file's {product_slabs}) and once the whole test file"
                )
            held = {}
            for name in files:
                _same_collection("the ingest over the shards", sharded, local, name)
                held[name] = _held_as_placed(sharded, name, rows[name])
            shardmap = sharded.groups[0].find_one(SHARDMAP_COLLECTION, {"_id": SHARDMAP_DOC_ID})
            if (shardmap or {}).get("shards") != SHARDS_GROUPS or shardmap.get("stripe_rows") != SHARDS_STRIPE_ROWS:
                raise AssertionError(f"shards: the shard map is {shardmap}")
            for name in files:
                _timed(walls, f"PATCH /fieldtypes {name}", clients["data_type_handler"], "PATCH",
                       f"/fieldtypes/{name}", numbers, expect=(200,))
                convert_field_types(local, name, numbers)
                _same_collection("the cast over the shards", sharded, local, name)

            # the in-process store's build and batch request: what the
            # shards' are held to
            server = ServerThread(create_app(local, models_dir=os.path.join(folder, "local_models"))).start()
            try:
                client = _Client(server.port)
                local_build = _store_build(client, local, "bench_test", False)
                local_batch = _batch_request(torch, client, local, "gb", "batch_gb")
            finally:
                server.stop()
            want_labels = _labels(local, "batch_gb")

            torch.cuda.synchronize()
            kernels.reset_launches()
            builder = next(s for s in servers if s.canonical_port == runner.SERVICES["model_builder"])
            client = _Client(builder.port)
            build = _store_build(client, sharded, "bench_test", False)
            if build["metrics"] != local_build["metrics"]:
                raise AssertionError(
                    f"shards: the build's metrics {build['metrics']} are not the in-process store's "
                    f"{local_build['metrics']}"
                )
            batch = _batch_request(torch, client, sharded, "gb", "batch_gb")
            _same_labels("the batch request over the shards", _labels(sharded, "batch_gb"), want_labels)

            # failover: kill -9 group 1's primary, its follower takes over
            f_url = urls[1][1]
            primaries[1].process.send_signal(signal.SIGKILL)
            killed = time.perf_counter()
            primaries[1].process.wait(timeout=15)
            promoted, health = None, None
            while time.perf_counter() - killed < STORE_PROMOTE_TIMEOUT_S:
                health = probe_health(f_url, timeout=1.0)
                if health and health.get("writable"):
                    promoted = time.perf_counter() - killed
                    break
                time.sleep(0.02)
            if promoted is None:
                raise AssertionError(
                    "shards: group 1's follower never promoted:\n" + "\n".join(followers[1].lines()[-20:])
                )
            loss = health.get("loss_window") or {}
            if loss.get("records") != 0 or health.get("term", 0) < 2:
                raise AssertionError(f"shards: the promotion lost acknowledged records: {health}")
            after_kill = _batch_request(torch, client, sharded, "gb", "batch_gb_failover")
            _same_labels("the batch request after the kill", _labels(sharded, "batch_gb_failover"), want_labels)
            held_after = {name: _held_as_placed(sharded, name, rows[name]) for name in files}
            gauges = _shard_gauges(_metrics_text(client))
            families = {"lo_store_shard_collections", "lo_store_shard_wal_bytes", "lo_store_shard_spill_bytes"}
            if sorted(gauges) != [str(group) for group in range(SHARDS_GROUPS)] or any(
                set(found) != families for found in gauges.values()
            ):
                raise AssertionError(f"shards: model_builder's /metrics shows the shard gauges {gauges}")
            torch.cuda.synchronize()
            launches = kernels.launches()
            missing = [name for name in BUILD_KERNELS if launches[name] == 0]
            if missing:
                raise AssertionError(f"shards: the phase never launched {missing}")
            client_now_at = sharded.groups[1].base_url
        finally:
            for server in servers:
                server.stop()
            if sharded is not None:
                _stop_collectors([sharded])
                sharded.close()
            for child in primaries + followers:
                child.stop()
    one_group = (store_record or {}).get("batch_over_ring")
    record = {
        "phase": "shards",
        "groups": SHARDS_GROUPS,
        "stripe_rows": SHARDS_STRIPE_ROWS,
        "rows": rows,
        "test_csv_bytes": test_bytes,
        "slab_bytes": slab_bytes,
        "slabs": slabs, "product_slabs": product_slabs, "test_rows": STORE_BATCH_ROWS,
        "native": parses,
        "csv_write_s": csv_s,
        "boot_s": boot_s,
        "ingest_1m_s": {
            "native_slabbed_over_shards": walls[f"ingest {BATCH_TEST}"],
            "native_whole_in_process": native_s,
            "python_whole_in_process": python_s[BATCH_TEST],
        },
        "walls_s": walls,
        "block_rows": held,
        "block_rows_after_kill": held_after,
        "shardmap": shardmap,
        "build": build,
        "local_build": local_build,
        "batch": batch,
        "local_batch": local_batch,
        "one_group_batch": one_group,
        "failover": {
            "promote_s": promoted,
            "term": health["term"],
            "loss_window": loss,
            "client_now_at": client_now_at == f_url,
            "batch": after_kill,
        },
        "shard_gauges": gauges,
        "launches": {name: launches[name] for name in BUILD_KERNELS},
        "phase_s": time.perf_counter() - started,
        "nvidia_smi": card,
    }
    emit(record)
    return record


# --------------------------------------------------------------------------
# LO_DTYPE_POLICY=bf16, in a child process
# --------------------------------------------------------------------------

BF16_WIDTHS = (5, 16, 17, 32)   # K1's word and value paths, K6's staging, K7's tile
BF16_EDGE_ROWS = 4_096
BF16_GLOBAL_FEATURES = 1_000    # K6 rows read from global memory
BF16_EMBED_ROWS = QUALITY_ROWS
BF16_SWEEP_ROWS = 20_000
BF16_CHILD_TIMEOUT_S = 600
# K7 on bfloat16 rows past its staged tile: 202 features (the trial losses
# from global memory, the gradient's tile staged raw), 444 and 20,000 (both
# from global memory; 20,000 x 4,096 is 164 MB of bfloat16)
BF16_K7_WIDE_FEATURES = (202, 444, 20_000)
BF16_K7_WIDE_ROWS = 4_096
BF16_LR_FEATURES = 256          # the bf16 lr build past the staged tile
BF16_LR_ROWS = 20_000
BF16_FORMS = {   # the bf16 form's name: (the float32 kernel, its source, the TPU program)
    "apply_bins:bf16": ("apply_bins", FIT_SOURCE, FIT_REPLACES["apply_bins"]),
    "tree_ensemble_forward:bf16": ("tree_ensemble_forward", KERNEL_SOURCE, REPLACES["tree_ensemble_forward"]),
    "gbt_forward:bf16": ("gbt_forward", KERNEL_SOURCE, REPLACES["gbt_forward"]),
    "logistic_loss_grad:bf16": ("logistic_loss_grad", LOGISTIC_SOURCE, LOGISTIC_REPLACES["logistic_loss_grad"]),
    "logistic_trial_losses:bf16": (
        "logistic_trial_losses", LOGISTIC_SOURCE, LOGISTIC_REPLACES["logistic_trial_losses"]
    ),
}


def _widened_equal(what: str, got, want) -> None:
    """A bfloat16 launch against the float32 launch on the widened X: the
    same bits (NaN where NaN)."""
    pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
    for a, b in pairs:
        if a.dtype != b.dtype or a.shape != b.shape or not _same_bits([a], [b]):
            raise AssertionError(f"{what}: the bfloat16 launch differs from the float32 one on the widened X")


def _bf16_forward_calls(torch, rows: int, features: int, seed: int):
    """bfloat16 rows and K6's two forwards of seeded heaps over any X,
    each with its plain version and its values a leaf."""
    X, fh, th, lp, lv = _kernel_inputs(torch, rows, TREES, seed=seed, features=features)
    return X.to(torch.bfloat16), {
        "tree_ensemble_forward:bf16": (
            lambda X: trees.ensemble_forward(X, fh, th, lp, DEPTH),
            lambda X: trees._ensemble_forward(X, fh, th, lp, DEPTH), CLASSES,
        ),
        "gbt_forward:bf16": (
            lambda X: trees.gbt_forward(X, -0.2, fh, th, lv, STEP, DEPTH),
            lambda X: trees._gbt_forward(X, -0.2, fh, th, lv, STEP, DEPTH), 1,
        ),
    }


def _k1_edge(torch, features: int, rows: int = BF16_EDGE_ROWS):
    """bfloat16 rows of ``features`` features, NaN among them, and their
    thresholds."""
    rng = np.random.default_rng(features)
    X = bench_rows(rng, rows, features)
    X[rng.random(X.shape) < 0.02] = np.nan
    thresholds = binning.make_thresholds(X).astype(np.float32)
    return torch.from_numpy(X).cuda().to(torch.bfloat16), torch.from_numpy(thresholds).cuda()


def check_bf16_kernels(torch, flush) -> dict:
    """K1, K6 (tree lanes and a thread a row, rows staged and from global
    memory) and K7 (both entry points, 2 and 10 classes) on bfloat16 X,
    each bit-equal to its float32 launch on the widened X and held to its
    plain version, at the main path's 1,000,000 (K6: 1,048,576) x 16 and
    at the edge widths (K7 also past its staged tile:
    :func:`check_k7_bf16_wide`); times cold and warm beside the float32
    form's."""
    results = {}
    # K1
    X_np, y_np = bench_synthetic(FIT_ROWS)
    X_k1 = X_np.copy()
    X_k1[:4, 0] = [np.nan, np.inf, -np.inf, -0.0]
    Xb = torch.from_numpy(X_k1).cuda().to(torch.bfloat16)
    X32 = Xb.float()
    thresholds = torch.from_numpy(binning.make_thresholds(X_np).astype(np.float32)).cuda()
    cases = {"1000000x16": (Xb, thresholds)}
    cases.update({f"{BF16_EDGE_ROWS}x{features}": _k1_edge(torch, features) for features in BF16_WIDTHS})
    cases["200000x16:255_bins"] = (
        Xb[:200_000], torch.from_numpy(binning.make_thresholds(X_np[:200_000], 255).astype(np.float32)).cuda()
    )
    shapes = {}
    for label, (X_b, th) in cases.items():
        got = binning.apply_bins(X_b, th)
        _widened_equal(f"apply_bins {label}", got, binning.apply_bins(X_b.float(), th))
        _widened_equal(f"apply_bins {label} (plain)", got, binning._apply_bins(X_b, th))
        shapes[label] = {"bins": str(got.dtype)}
    bound_ms, bound_by = _fit_bound("apply_bins", FIT_ROWS, 1, 1, x_bytes=2)
    f32_bound_ms, _ = _fit_bound("apply_bins", FIT_ROWS, 1, 1)
    results["apply_bins:bf16"] = {
        "rows": FIT_ROWS, "max_abs_err": 0.0, "by_shape": shapes,
        "ms": _event_ms(torch, lambda: binning.apply_bins(Xb, thresholds), 20, flush),
        "warm_ms": _event_ms(torch, lambda: binning.apply_bins(Xb, thresholds), 50),
        "f32_ms": _event_ms(torch, lambda: binning.apply_bins(X32, thresholds), 20, flush),
        "f32_warm_ms": _event_ms(torch, lambda: binning.apply_bins(X32, thresholds), 50),
        "plain_ms": _event_ms(torch, lambda: binning._apply_bins(Xb, thresholds), 3, flush),
        "bound_ms": bound_ms, "bound_by": bound_by, "f32_bound_ms": f32_bound_ms,
        # torch.searchsorted takes one dtype for both operands
        "library_ms": None,
    }
    # K6: tree lanes (the serve shapes) and a thread a row (the batch lane)
    forward = {"tree_ensemble_forward:bf16": {"max_abs_err": 0.0, "by_shape": {}},
               "gbt_forward:bf16": {"max_abs_err": 0.0, "by_shape": {}}}
    cases = [(KERNEL_ROWS[-1], FEATURES), (BF16_EDGE_ROWS, FEATURES), (KERNEL_ROWS[-1], WIDE_FEATURES)]
    cases += [(BF16_EDGE_ROWS, features) for features in BF16_WIDTHS if features != FEATURES]
    cases += [(256, BF16_GLOBAL_FEATURES)]
    timed = {}
    for rows, features in cases:
        X_b, calls = _bf16_forward_calls(torch, rows, features, seed=rows + features)
        for name, (kernel, plain, classes) in calls.items():
            got = kernel(X_b)
            _widened_equal(f"{name} {rows}x{features}", got, kernel(X_b.float()))
            want = plain(X_b)
            error = float((got - want).abs().max())
            if error > TREE_TOL or (name.startswith("tree") and not torch.equal(got, want)):
                raise AssertionError(f"{name} {rows}x{features}: {error} from the plain version")
            geometry = trees._forward_geometry(rows, features, TREES, DEPTH, classes)
            forward[name]["max_abs_err"] = max(forward[name]["max_abs_err"], error)
            forward[name]["by_shape"][f"{rows}x{features}"] = {
                "row_threads": geometry.row_threads, "x_staged": geometry.x_staged,
            }
            if features == FEATURES:
                timed[name, rows] = (X_b, kernel, plain)
    for name in forward:
        forms = {shape["row_threads"] for shape in forward[name]["by_shape"].values()}
        staged = {shape["x_staged"] for shape in forward[name]["by_shape"].values()}
        if forms != {True, False} or staged != {True, False}:
            raise AssertionError(f"{name}: the checks missed a geometry ({forward[name]['by_shape']})")
        for rows in (BF16_EDGE_ROWS, KERNEL_ROWS[-1]):
            X_b, kernel, plain = timed[name, rows]
            X32 = X_b.float()
            base_name = BF16_FORMS[name][0]
            bound_ms, bound_by = _bound(rows, TREES, base_name, x_bytes=2)
            forward[name][rows] = {
                "ms": _event_ms(torch, lambda: kernel(X_b), 20, flush),
                "warm_ms": _event_ms(torch, lambda: kernel(X_b), 50),
                "f32_ms": _event_ms(torch, lambda: kernel(X32), 20, flush),
                "f32_warm_ms": _event_ms(torch, lambda: kernel(X32), 50),
                "plain_ms": _event_ms(torch, lambda: plain(X_b), 3, flush),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "f32_bound_ms": _bound(rows, TREES, base_name)[0],
            }
        # the batch lane's shape
        forward[name].update(rows=KERNEL_ROWS[-1], library_ms=None, **forward[name].pop(KERNEL_ROWS[-1]))
        forward[name]["by_rows"] = {BF16_EDGE_ROWS: forward[name].pop(BF16_EDGE_ROWS)}
    results.update(forward)
    # K7
    k7 = {"logistic_loss_grad:bf16": {"max_abs_err": 0.0, "by_classes": {}},
          "logistic_trial_losses:bf16": {"max_abs_err": 0.0, "by_classes": {}}}
    mean, scale = logistic.scaler_stats(X_np)
    X_std = logistic._standardized(X_np, mean, scale)
    shapes = [(X_std, y_np, CLASSES), (X_std, ten_classes(X_np), DEEP_CLASSES)]
    for features in BF16_WIDTHS:
        rows_np = bench_rows(np.random.default_rng(100 + features), BF16_EDGE_ROWS, features)
        shapes.append((rows_np / 10.0 - 1.0, (rows_np[:, 0] > 10).astype(np.int32), CLASSES))
    for X_host, labels, classes in shapes:
        rows, features = X_host.shape
        rng = np.random.default_rng(classes + features)
        X_b = torch.from_numpy(np.ascontiguousarray(X_host, dtype=np.float32)).cuda().to(torch.bfloat16)
        y_dev = torch.from_numpy(labels.astype(np.int32)).cuda()

        def cuda(*shape):
            return torch.from_numpy((rng.normal(size=shape) * 0.3).astype(np.float32)).cuda()

        W, b, D, d = cuda(features, classes), cuda(classes), cuda(features, classes), cuda(classes)
        steps = torch.tensor([1.0, 0.5, 0.25, 0.125], device=X_b.device)
        W4 = (W[None] + steps[:, None, None] * D[None]).contiguous()
        b4 = (b[None] + steps[:, None] * d[None]).contiguous()
        calls = {
            "logistic_loss_grad:bf16": (
                lambda X: logistic.loss_and_grad(W, b, X, y_dev, 0.0),
                lambda X: logistic._loss_fn(W, b, X, y_dev, 0.0),
            ),
            "logistic_trial_losses:bf16": (
                lambda X: logistic.trial_losses(W4, b4, X, y_dev, 0.0),
                lambda X: logistic._trial_losses(W4, b4, X, y_dev, 0.0),
            ),
        }
        for name, (kernel, plain) in calls.items():
            got = kernel(X_b)
            _widened_equal(f"{name} {rows}x{features}, {classes} classes", got, kernel(X_b.float()))
            want = plain(X_b)
            got_all = torch.cat([g.reshape(-1) for g in (got if isinstance(got, tuple) else (got,))])
            want_all = torch.cat([w.reshape(-1) for w in (want if isinstance(want, tuple) else (want,))])
            error = float((got_all - want_all).abs().max())
            if error > K7_GRAD_ATOL + K7_LOSS_RTOL * float(want_all.abs().max()):
                raise AssertionError(f"{name} {rows}x{features}: {error} from the plain twin")
            k7[name]["max_abs_err"] = max(k7[name]["max_abs_err"], error)
            if features == FEATURES and rows == FIT_ROWS:
                X32 = X_b.float()
                trial = name.startswith("logistic_trial")
                bound_ms, bound_by = _k7_bound(rows, features, classes, trial, x_bytes=2)
                k7[name]["by_classes"][classes] = {
                    "ms": _event_ms(torch, lambda: kernel(X_b), 20, flush),
                    "warm_ms": _event_ms(torch, lambda: kernel(X_b), 50),
                    "f32_ms": _event_ms(torch, lambda: kernel(X32), 20, flush),
                    "f32_warm_ms": _event_ms(torch, lambda: kernel(X32), 50),
                    "plain_ms": _event_ms(torch, lambda: plain(X_b), 3, flush),
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "f32_bound_ms": _k7_bound(rows, features, classes, trial)[0],
                }
    for name in k7:
        k7[name].update(rows=FIT_ROWS, library_ms=None, **k7[name]["by_classes"][CLASSES])
        k7[name]["wide"] = check_k7_bf16_wide(torch, name)
    results.update(k7)
    return results


def check_k7_bf16_wide(torch, name: str) -> dict:
    """One K7 entry point on bfloat16 rows of BF16_K7_WIDE_FEATURES
    features, 2 and 10 classes, BF16_K7_WIDE_ROWS seeded rows: bit-equal
    to the float32 launch on the widened X and within K7_LOSS_RTOL and
    K7_GRAD_ATOL of the plain twin; with the geometry each ran in."""
    trial = name.startswith("logistic_trial")
    record = {}
    for features in BF16_K7_WIDE_FEATURES:
        for classes in (CLASSES, DEEP_CLASSES):
            rng = np.random.default_rng(features * 31 + classes)

            def cuda(array):
                return torch.from_numpy(np.ascontiguousarray(array, dtype=np.float32)).cuda()

            X_b = cuda(rng.normal(size=(BF16_K7_WIDE_ROWS, features))).to(torch.bfloat16)
            y = torch.from_numpy(rng.integers(0, classes, BF16_K7_WIDE_ROWS).astype(np.int32)).cuda()
            W = cuda(rng.normal(size=(features, classes)) * 0.3 / np.sqrt(features))
            b = cuda(rng.normal(size=classes) * 0.3)
            steps = torch.tensor([1.0, 0.5, 0.25, 0.125], device=X_b.device)
            W4 = (W[None] * (1.0 + steps[:, None, None])).contiguous()
            b4 = (b[None] * (1.0 + steps[:, None])).contiguous()
            if trial:
                kernel = lambda X: logistic.trial_losses(W4, b4, X, y, 0.0)  # noqa: E731
                plain = lambda X: logistic._trial_losses(W4, b4, X, y, 0.0)  # noqa: E731
            else:
                kernel = lambda X: logistic.loss_and_grad(W, b, X, y, 0.0)  # noqa: E731
                plain = lambda X: logistic._loss_fn(W, b, X, y, 0.0)  # noqa: E731
            what = f"{name} {BF16_K7_WIDE_ROWS}x{features}, {classes} classes"
            got = kernel(X_b)
            X32 = X_b.float()
            _widened_equal(what, got, kernel(X32))
            del X32
            got_all = torch.cat([g.reshape(-1) for g in (got if isinstance(got, tuple) else (got,))])
            want = plain(X_b)
            want_all = torch.cat([w.reshape(-1) for w in (want if isinstance(want, tuple) else (want,))])
            error = float((got_all - want_all).abs().max())
            if error > K7_GRAD_ATOL + K7_LOSS_RTOL * float(want_all.abs().max()):
                raise AssertionError(f"{what}: {error} from the plain twin")
            geometry = logistic._k7_geometry(features, classes, 1, False, trial=trial, x_bf16=True)
            record[f"{features}x{classes}"] = {
                "max_abs_err": error, "bit_equal_to_f32": True,
                "x_staged": geometry[3], "tile": geometry[1],
            }
    if not trial and {entry["x_staged"] for entry in record.values()} != {True, False}:
        raise AssertionError(f"{name}: the wide checks missed a geometry ({record})")
    return record


def bf16_lr_build(torch) -> dict:
    """One lr build (``POST /models`` over HTTP) under ``bf16`` on rows of
    BF16_LR_FEATURES features, past K7's staged tile: it fits, K7 launched,
    and its stored labels are its ``.model``'s own predictions."""
    from learningorchestra_tpu_torch.core.table import ColumnTable, write_table
    from learningorchestra_tpu_torch.frame.pyspark_compat import run_preprocessor
    from learningorchestra_tpu_torch.ml.builder import load_dataframe

    rng = np.random.default_rng(BF16_LR_FEATURES)
    store = InMemoryStore()
    for name, rows in (("wide_train", BF16_LR_ROWS), ("wide_test", BF16_LR_ROWS // 4)):
        X = rng.normal(size=(rows, BF16_LR_FEATURES))
        y = (X[:, :8].sum(axis=1) > 0).astype(np.float64)
        columns = {f"f{i}": X[:, i] for i in range(BF16_LR_FEATURES)}
        columns["label"] = y
        write_table(store, name, ColumnTable(columns), {"filename": name, "finished": True, "fields": list(columns)})
    with tempfile.TemporaryDirectory() as folder:
        server = ServerThread(create_app(store, models_dir=os.path.join(folder, "models"))).start()
        try:
            client = _Client(server.port)
            torch.cuda.synchronize()
            kernels.reset_launches()
            started = time.perf_counter()
            body = {**_build_body("wide_train", "wide_test", PRODUCT_PREPROCESSOR, False), "classificators_list": ["lr"]}
            status, answer = client.call("POST", "/models", body)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - started
            launches = kernels.launches()
            if (status, answer) != (201, {"result": "created_file"}):
                raise AssertionError(f"bf16 lr at {BF16_LR_FEATURES} features: the build answered {status} {answer}")
            if launches["logistic_loss_grad"] == 0 or launches["logistic_trial_losses"] == 0:
                raise AssertionError(f"bf16 lr at {BF16_LR_FEATURES} features: K7 never launched ({launches})")
            frames = run_preprocessor(
                PRODUCT_PREPROCESSOR, load_dataframe(store, "wide_train"), load_dataframe(store, "wide_test")
            )
            X_test = frames["features_testing"].feature_matrix("features")
            metadata = store.find_one("wide_test_prediction_lr", {"_id": 0})
            stored = store.read_column_arrays("wide_test_prediction_lr", ["prediction"])["prediction"].to_float64()
            if not np.array_equal(load_model(metadata["model_checkpoint"]).predict(X_test), stored):
                raise AssertionError("bf16 lr: the stored labels are not its checkpoint's")
        finally:
            server.stop()
    return {
        "features": BF16_LR_FEATURES, "rows": BF16_LR_ROWS, "wall_s": wall_s,
        "launches": {name: launches[name] for name in ("logistic_loss_grad", "logistic_trial_losses")},
        "accuracy": float(metadata["accuracy"]), "F1": float(metadata["F1"]),
        "geometry": logistic._k7_geometry(BF16_LR_FEATURES, CLASSES, 1, False, x_bf16=True),
        "trial_geometry": logistic._k7_geometry(BF16_LR_FEATURES, CLASSES, 1, False, trial=True, x_bf16=True),
    }


def _raw_call(port: int, method: str, path: str, payload: dict) -> tuple:
    """``(status, Content-Type, body bytes)`` of one request."""
    request = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(), method=method,
        headers={"Content-Type": "application/json"},
    )
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    try:
        with opener.open(request, timeout=300) as response:
            return response.status, response.headers.get("Content-Type"), response.read()
    except urllib.error.HTTPError as error:
        return error.code, error.headers.get("Content-Type"), error.read()


def bf16_images(torch) -> dict:
    """A t-SNE and a PCA image request over HTTP under ``bf16``: t-SNE
    answers 201; PCA the reference's 500, whose body is its ``eigh``'s
    refusal of bfloat16."""
    from learningorchestra_tpu_torch.core.table import ColumnTable, write_table
    from learningorchestra_tpu_torch.services import images

    X, labels = embed_blobs(BF16_EMBED_ROWS, 9)
    store = InMemoryStore()
    columns = {f"f{k}": X[:, k].astype(np.float64) for k in range(FEATURES)}
    columns["label"] = labels.astype(np.float64)
    write_table(store, "blobs", ColumnTable(columns), {"filename": "blobs", "finished": True, "fields": list(columns)})
    answers = {}
    with tempfile.TemporaryDirectory() as folder:
        for method in ("tsne", "pca"):
            server = ServerThread(images.create_app(store, folder, method)).start()
            try:
                started = time.perf_counter()
                status, content_type, body = _raw_call(
                    server.port, "POST", "/images/blobs", {f"{method}_filename": method, "label_name": "label"}
                )
                answers[method] = {"status": status, "content_type": content_type,
                                   "body": body.decode(), "wall_s": time.perf_counter() - started}
            finally:
                server.stop()
    if answers["tsne"]["status"] != 201:
        raise AssertionError(f"bf16: the t-SNE request answered {answers['tsne']}")
    refusal = f"NotImplementedError: {pca.EIGH_BF16_REFUSAL}"
    if (answers["pca"]["status"], answers["pca"]["body"]) != (500, refusal):
        raise AssertionError(f"bf16: the PCA request answered {answers['pca']}, not the reference's refusal")
    return answers


def bf16_sweep(torch) -> dict:
    """A λ sweep under ``bf16``: its payload and its job kernels stay
    float32 (the job wrappers refuse bfloat16)."""
    from learningorchestra_tpu_torch.ml import sweep

    X, y = bench_synthetic(BF16_SWEEP_ROWS, 4)
    grid = [{"reg_param": value} for value in (0.0, 0.1, 0.5, 1.0)]
    _, payload = sweep.prepare_member("lr", X, y, X[:5000], y[:5000], grid, device=_card(torch), max_iter=5)
    if payload["X"].dtype != np.float32:
        raise AssertionError(f"bf16: the sweep's payload is {payload['X'].dtype}")
    (status, result), = sweep.run_group([payload], _card(torch))
    if status != "ok":
        raise AssertionError(f"bf16: the sweep failed {result}")
    return {"payload_dtype": str(payload["X"].dtype), "points": len(result["points"])}


def bf16_build(torch) -> dict:
    """The five-classifier product build and one ``/predict`` request
    under ``bf16``, the launch counts set to 0 just before and read just
    after: every kernel of the build launched, the cached device matrices
    are bfloat16 (half the float32 bytes), every stored label is its
    ``.model``'s own prediction."""
    from learningorchestra_tpu_torch.core import devcache
    from learningorchestra_tpu_torch.frame.pyspark_compat import run_preprocessor
    from learningorchestra_tpu_torch.ml.builder import load_dataframe

    with tempfile.TemporaryDirectory() as folder:
        store = product_store()
        plane = ServePlane()
        server = ServerThread(create_app(store, models_dir=os.path.join(folder, "models"), serve=plane)).start()
        try:
            client = _Client(server.port)
            frames = run_preprocessor(
                PRODUCT_PREPROCESSOR, load_dataframe(store, "bench_train"), load_dataframe(store, "bench_test")
            )
            X_test = frames["features_testing"].feature_matrix("features")
            torch.cuda.synchronize()
            kernels.reset_launches()
            started = time.perf_counter()
            status, answer = client.call("POST", "/models", _build_body("bench_train", "bench_test", PRODUCT_PREPROCESSOR, False))
            if (status, answer) != (201, {"result": "created_file"}):
                raise AssertionError(f"bf16: the build answered {status} {answer}")
            status, answered = client.call(
                "POST", "/models/bench_test_prediction_gb/predict", {"rows": X_test[:PREDICT_ROWS].tolist()}
            )
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - started
            launches = kernels.launches()
            missing = [name for name in BUILD_KERNELS if launches[name] == 0]
            if missing or status != 200:
                raise AssertionError(f"bf16: the build never launched {missing} (predict {status})")
            matrices = [
                entry for key, entry in devcache.global_devcache()._entries.items() if key[2][0] == "devmat"
            ]
            if not matrices or any(
                entry.value.dtype != torch.bfloat16 or entry.nbytes * 2 != entry.value.numel() * 4
                for entry in matrices
            ):
                raise AssertionError("bf16: the cached device matrices are not bfloat16")
            metrics = {}
            for name in MODEL_NAMES:
                collection = f"bench_test_prediction_{name}"
                metadata = store.find_one(collection, {"_id": 0})
                stored = store.read_column_arrays(collection, ["prediction"])["prediction"].to_float64()
                if not np.array_equal(load_model(metadata["model_checkpoint"]).predict(X_test), stored):
                    raise AssertionError(f"bf16 {name}: the stored labels are not its checkpoint's")
                metrics[name] = {key: float(metadata[key]) for key in ("accuracy", "F1")}
            if answered["result"]["predictions"] != load_model(
                store.find_one("bench_test_prediction_gb", {"_id": 0})["model_checkpoint"]
            ).predict(X_test[:PREDICT_ROWS]).tolist():
                raise AssertionError("bf16: /predict answered other labels than the checkpoint's")
        finally:
            server.stop()
            plane.close()
    return {
        "wall_s": wall_s,
        "launches": {name: launches[name] for name in BUILD_KERNELS},
        "device_matrices": [
            {"shape": list(entry.value.shape), "dtype": str(entry.value.dtype), "bytes": entry.nbytes,
             "f32_bytes": entry.value.numel() * 4}
            for entry in matrices
        ],
        "metrics": metrics,
    }


def bf16_child() -> int:
    """The ``bf16`` phase's body, run in a child process started with
    ``LO_DTYPE_POLICY=bf16``: the kernels on bfloat16 X, the main path
    (the product build and a predict request), the image requests and a
    sweep. Its last line is the phase's record."""
    import torch

    from learningorchestra_tpu_torch.utils.dtypepolicy import dtype_policy

    if dtype_policy() != "bf16":
        raise SystemExit("chip_smoke bf16: the child runs under LO_DTYPE_POLICY=bf16")
    phase_device(torch)
    for name in kernels.SOURCES:   # built by the parent: the same sources' libraries
        kernels.library(name)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    checked = check_bf16_kernels(torch, flush)
    wide_build = bf16_lr_build(torch)
    build = bf16_build(torch)
    summary = []
    for name, (base_name, source, replaces) in BF16_FORMS.items():
        result = checked[name]
        summary.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": build["launches"][base_name],
            **{field: result[field] for field in (
                "max_abs_err", "rows", "ms", "warm_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "f32_ms", "f32_warm_ms", "f32_bound_ms",
            )},
            **{field: result[field] for field in ("by_shape", "by_rows", "by_classes", "wide") if field in result},
        })
    emit({
        "phase": "bf16",
        "kernels": summary,
        "build": build,
        "wide_lr_build": wide_build,
        "images": bf16_images(torch),
        "sweep": bf16_sweep(torch),
        "nvidia_smi": nvidia_smi_line(),
    })
    return 0


def phase_bf16(torch, card: str, f32_metrics: "dict | None") -> dict:
    """Runs :func:`bf16_child` in a child process with
    ``LO_DTYPE_POLICY=bf16`` (the policy is read once a process), echoes
    its lines, and fails when it fails. Prints the bfloat16 build's
    metrics beside the float32 build's (a reading, with no bound)."""
    env = {**os.environ, "LO_DTYPE_POLICY": "bf16"}
    started = time.perf_counter()
    child = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "bf16-child"],
        env=env, capture_output=True, text=True, timeout=BF16_CHILD_TIMEOUT_S,
    )
    wall_s = time.perf_counter() - started
    lines = [line for line in child.stdout.splitlines() if line.strip()]
    for line in lines:
        print(line, flush=True)
    if child.returncode != 0:
        raise AssertionError(f"bf16: the child exited {child.returncode}:\n{child.stderr[-4000:]}")
    record = json.loads(lines[-1])
    if record.get("phase") != "bf16":
        raise AssertionError(f"bf16: the child's last line is not its record: {lines[-1][:200]}")
    emit({
        "phase": "bf16-metrics",
        "bf16": record["build"]["metrics"],
        "f32": f32_metrics,
        "child_wall_s": wall_s,
        "nvidia_smi": card,
    })
    return record


# --------------------------------------------------------------------------
# multigpu: K8′ and K7's sums form, fit_sharded over ranks
# --------------------------------------------------------------------------

SCALER_SOURCE = "learningorchestra_tpu_torch/kernels/csrc/scaler.cu"
MULTIGPU_REPLACES = {
    "masked_col_sums": (
        "learningorchestra_tpu/ml/logistic.py:412 _masked_stats (the masked sums and count)"
    ),
    "masked_col_sums_centred": (
        "learningorchestra_tpu/ml/logistic.py:412 _masked_stats (the masked variance about the mean)"
    ),
    "masked_standardize": "learningorchestra_tpu/ml/logistic.py:426 _standardize",
    "logistic_loss_grad_sums": (
        "learningorchestra_tpu/ml/logistic.py:35 _loss_fn under value_and_grad in :308 _fit "
        "on a row-sharded mesh (XLA's psums across the data axis)"
    ),
    "logistic_trial_losses_sums": (
        "learningorchestra_tpu/ml/logistic.py:35 _loss_fn in the Armijo loop :176-200 "
        "on a row-sharded mesh (XLA's psums across the data axis)"
    ),
}
MULTIGPU_KERNELS = {
    "masked_col_sums": ("masked_sums_kernel",),
    "masked_col_sums_centred": ("masked_sums_kernel",),
    "masked_standardize": ("standardize",),
    "logistic_loss_grad_sums": ("loss_grad_kernel", "sums_kernel"),
    "logistic_trial_losses_sums": ("trial_losses_kernel", "sums_kernel"),
}
# the K8′ checks' shapes: the main path's block (bench.py's 1,000,000 rows
# padded to one rank's 1,048,576) and 4,096 rows of several widths, 96 of
# them padding
SCALER_SHAPES = ((1_048_576, FEATURES, FIT_ROWS), (4096, 1, 4000), (4096, 5, 4000),
                 (4096, 16, 4000), (4096, 17, 4000), (4096, 256, 4000))
SCALER_CONSTANT = 2.5    # one constant column: its scale pins to 1
SCALER_SUM_RTOL = 1e-12  # float64 sums in the kernel's order and torch's
SCALER_STAT_RTOL = 1e-6  # mean and scale (rounded once to float32) against the twins'
MULTIGPU_MIN_AGREEMENT = 0.999   # predictions of a run against run (b)
MULTIGPU_LOSS_RTOL = 1e-5        # loss histories of a run against run (b)
MULTIGPU_GLOO_RANKS = 4          # run (c): ranks sharing card 0 over gloo
MULTIGPU_GROUP_TIMEOUT_S = 120
MULTIGPU_CHILD_TIMEOUT_S = 300
MULTIGPU_CHILD_COMMAND = [sys.executable, os.path.abspath(__file__), "multigpu-child"]
_VAR_MEAN_NOTE = (
    "none for a pass alone: torch.var_mean gives both moments at once, and stands beside "
    "the two passes together (masked_stats, the multigpu summary's masked_stats entry)"
)
MULTIGPU_LIBRARY = {
    "masked_col_sums": _VAR_MEAN_NOTE,
    "masked_col_sums_centred": _VAR_MEAN_NOTE,
    "masked_standardize": "no single PyTorch call gives ((x - mean) / scale) * w",
    "logistic_loss_grad_sums": "no PyTorch call gives the masked nll sums with their gradient",
    "logistic_trial_losses_sums": "no PyTorch call gives the masked nll sums at four points",
}


def _scaler_inputs(torch, rows: int, features: int, valid: int, seed: int):
    """A rank's block: bench.py's rows (its synthetic data on the main
    path's shape), one column constant, the rows past ``valid`` padding
    (zeros, weight 0)."""
    if features == FEATURES and valid == FIT_ROWS:
        X = np.zeros((rows, features), np.float32)
        X[:valid] = bench_synthetic(FIT_ROWS)[0]
    else:
        X = bench_rows(np.random.default_rng(seed), rows, features)
    X[:, features // 2] = SCALER_CONSTANT
    X[valid:] = 0.0
    w = (np.arange(rows) < valid).astype(np.float32)
    return torch.from_numpy(X).cuda(), torch.from_numpy(w).cuda()


def _scaler_bound(name: str, rows: int, features: int, x_bytes: int = 4) -> tuple[float, str]:
    """Least milliseconds: X (``x_bytes`` a value) and w read once, the
    output written once (the sums: F + 1 float64; the standardization: X
    again), against the operations at their type's peak (float64 for the
    sums: a product and an add a value, or a difference, two products and
    an add; float32 for the standardization: three a value)."""
    values = rows * features
    if name == "masked_standardize":
        bytes_moved = 2 * values * x_bytes + rows * 4 + 2 * features * 4
        op_ms = 3 * values / PEAK_FP32_OPS_PER_S * 1e3
    else:
        centred = name == "masked_col_sums_centred"
        bytes_moved = values * x_bytes + rows * 4 + (features + 1) * 8 + (features * 8 if centred else 0)
        op_ms = ((4 if centred else 2) * values + rows) / PEAK_FP64_OPS_PER_S * 1e3
    byte_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def _relative_error(got, want) -> float:
    scale = float(want.abs().max()) or 1.0
    return float((got - want).abs().max()) / scale


def _kernels_a_call(torch, fn) -> list:
    """The names of the CUDA kernels that one call of ``fn`` runs, from
    the profiler's trace (the first of PROFILE_ATTEMPTS traces that shows
    any: a trace can lose records, and after other phases in the process
    every trace may show none)."""
    from torch.profiler import ProfilerActivity, profile

    names = []
    for _ in range(PROFILE_ATTEMPTS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [event.name for event in prof.events()
                 if "CUDA" in str(getattr(event, "device_type", ""))]
        if names:
            break
    return names


def check_scaler_kernels(torch, flush) -> tuple[dict, dict]:
    """K8′'s kernels against their plain twins on the same block: both
    passes of masked_col_sums within SCALER_SUM_RTOL of the largest sum, a
    second launch bit identical, one kernel a call; masked_stats' mean and
    scale within SCALER_STAT_RTOL of the twins' (the constant column's scale
    1); masked_standardize bit-equal to its twin. Timed at every shape:
    event ms cold (L2 overwritten) and warm, device ms cold and with L2
    evicted by reads, the twin's ms cold. Returns the kernels' results and,
    at the main path's shape, the event ms of one whole masked_stats (both
    passes and the host's division between them) beside torch.var_mean over
    the valid rows, the one PyTorch call that gives both moments (never
    used by the port)."""
    names = ("masked_col_sums", "masked_col_sums_centred", "masked_standardize")
    results = {name: {"max_abs_err": 0.0, "by_shape": {}} for name in names}
    read_flush = _ReadFlush(torch, flush.device)
    stats_timing = None
    for rows, features, valid in SCALER_SHAPES:
        X, w = _scaler_inputs(torch, rows, features, valid, seed=rows + features)
        key = f"{rows}x{features}"
        first = logistic.masked_col_sums(X, w)
        want_first = logistic._masked_col_sums(X, w)
        mean64 = first[:-1] / first[-1]
        second = logistic.masked_col_sums(X, w, mean64)
        want_second = logistic._masked_col_sums(X, w, mean64)
        for name, got, want, again in (
            ("masked_col_sums", first, want_first, logistic.masked_col_sums(X, w)),
            ("masked_col_sums_centred", second, want_second, logistic.masked_col_sums(X, w, mean64)),
        ):
            if not torch.equal(got, again):
                raise AssertionError(f"{name} at {key}: a second launch differs")
            if float(got[-1]) != valid:
                raise AssertionError(f"{name} at {key}: the weights sum to {float(got[-1])}, not {valid}")
            error = _relative_error(got, want)
            if not error <= SCALER_SUM_RTOL:
                raise AssertionError(f"{name} at {key}: {error} relative to the largest sum")
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"], float((got - want).abs().max()))
        mean, scale = logistic.masked_stats(X, w)
        twin_std = torch.sqrt(want_second[:-1] / want_first[-1]).to(torch.float32)
        twin_mean = (want_first[:-1] / want_first[-1]).to(torch.float32)
        twin_scale = torch.where(twin_std > 0, twin_std, torch.ones_like(twin_std))
        stat_error = max(_relative_error(mean, twin_mean), _relative_error(scale, twin_scale))
        if not stat_error <= SCALER_STAT_RTOL or float(scale[features // 2]) != 1.0:
            raise AssertionError(
                f"masked_stats at {key}: {stat_error} relative; the constant column's scale "
                f"{float(scale[features // 2])}"
            )
        standardized = logistic.standardize(X, mean, scale, w)
        if not torch.equal(standardized, logistic._standardize(X, mean, scale, w)):
            raise AssertionError(f"masked_standardize at {key}: not bit-equal to its twin")
        if bool(standardized[valid:].any()):
            raise AssertionError(f"masked_standardize at {key}: a padded row is not zero")
        calls = {
            "masked_col_sums": (lambda: logistic.masked_col_sums(X, w),
                                lambda: logistic._masked_col_sums(X, w)),
            "masked_col_sums_centred": (lambda: logistic.masked_col_sums(X, w, mean64),
                                        lambda: logistic._masked_col_sums(X, w, mean64)),
            "masked_standardize": (lambda: logistic.standardize(X, mean, scale, w),
                                   lambda: logistic._standardize(X, mean, scale, w)),
        }
        for name, (kernel, plain) in calls.items():
            launched = None     # not measured: every trace lost its records
            if name != "masked_standardize":
                launched = _kernels_a_call(torch, kernel)
                if not launched:
                    LOST_TRACES.append({"kernels": list(MULTIGPU_KERNELS[name]), "launches": 0,
                                        "expected": 1, "check": "one kernel a call"})
                elif len(launched) != 1 or not all(
                        wanted in launched[0] for wanted in MULTIGPU_KERNELS[name]):
                    raise AssertionError(f"{name} at {key}: a call ran {launched}, not one kernel")
            bound_ms, bound_by = _scaler_bound(name, rows, features)
            results[name]["by_shape"][key] = {
                "rows": rows, "valid_rows": valid, "features": features,
                "kernels_a_call": len(launched) if launched else None,
                "ms": _event_ms(torch, kernel, 20, flush),
                "warm_ms": _event_ms(torch, kernel, 50),
                "device_ms": _device_ms(torch, kernel, MULTIGPU_KERNELS[name], 20, flush),
                "device_ms_clean_l2": _device_ms(torch, kernel, MULTIGPU_KERNELS[name], 20, read_flush),
                "plain_ms": _event_ms(torch, plain, 5, flush),
                "library_ms": None,
                "bound_ms": bound_ms, "bound_by": bound_by,
            }
        if stats_timing is None:   # the main path's shape, first
            whole = lambda: logistic.masked_stats(X, w)   # noqa: E731
            library = lambda: torch.var_mean(X[:valid], dim=0, correction=0)   # noqa: E731
            stats_timing = {
                "rows": rows, "valid_rows": valid, "features": features,
                "masked_stats_ms": _event_ms(torch, whole, 20, flush),
                "masked_stats_clean_l2_ms": _event_ms(torch, whole, 20, read_flush),
                "masked_stats_warm_ms": _event_ms(torch, whole, 50),
                "var_mean_ms": _event_ms(torch, library, 20, flush),
                "var_mean_clean_l2_ms": _event_ms(torch, library, 20, read_flush),
                "var_mean_warm_ms": _event_ms(torch, library, 50),
                "bound_ms": sum(_scaler_bound(name, rows, features)[0]
                                for name in ("masked_col_sums", "masked_col_sums_centred")),
            }
    del read_flush
    main_key = f"{SCALER_SHAPES[0][0]}x{SCALER_SHAPES[0][1]}"
    for result in results.values():
        result.update(result["by_shape"][main_key])
    return results, stats_timing


def check_k7_sums(torch, flush) -> dict:
    """K7's sums form on one rank's block at the main path's shape (bench.py's
    1,000,000 rows standardized, padded to 1,048,576, the mask as weights),
    2 and 10 classes: the sums within K7's tolerances of the twin's
    (divided by sum w), the sum of the weights exact, and, divided by it,
    bit-equal to the weighted launch's own division (``job_loss_and_grad``
    and ``job_trial_losses`` at l2 0, the same chunk sums); a second launch
    bit identical. Times as K7's."""
    X_np, y_np = bench_synthetic(FIT_ROWS)
    mean, scale = logistic.scaler_stats(X_np)
    rows = SCALER_SHAPES[0][0]
    X_block = np.zeros((rows, FEATURES), np.float32)
    X_block[:FIT_ROWS] = logistic._standardized(X_np, mean, scale)
    X = torch.from_numpy(X_block).cuda()
    w = torch.from_numpy((np.arange(rows) < FIT_ROWS).astype(np.float32)).cuda()
    names = ("logistic_loss_grad_sums", "logistic_trial_losses_sums")
    results = {name: {"max_abs_err": 0.0, "by_classes": {}} for name in names}
    for classes, labels in ((CLASSES, y_np), (DEEP_CLASSES, ten_classes(X_np))):
        y_block = np.zeros(rows, np.int32)
        y_block[:FIT_ROWS] = labels
        y = torch.from_numpy(y_block).cuda()
        rng = np.random.default_rng(classes + 100)

        def cuda(*shape):
            return torch.from_numpy((rng.normal(size=shape) * 0.3).astype(np.float32)).cuda()

        W, b, D, d = cuda(FEATURES, classes), cuda(classes), cuda(FEATURES, classes), cuda(classes)
        steps = torch.tensor([1.0, 0.5, 0.25, 0.125], device=X.device)
        W4 = (W[None] + steps[:, None, None] * D[None]).contiguous()
        b4 = (b[None] + steps[:, None] * d[None]).contiguous()
        zero = torch.zeros(1, device=X.device)
        sums = logistic._launch_loss_grad(W[None], b[None], X, y, w, 1, sums=True)[0]
        trial = logistic._launch_trial_losses(W4[None], b4[None], X, y, w, 1, sums=True)[0]
        if not torch.equal(sums, logistic._launch_loss_grad(W[None], b[None], X, y, w, 1, sums=True)[0]) \
                or not torch.equal(trial, logistic._launch_trial_losses(W4[None], b4[None], X, y, w, 1, sums=True)[0]):
            raise AssertionError(f"K7's sums form ({classes} classes): a second launch differs")
        if float(sums[-1]) != FIT_ROWS or float(trial[-1]) != FIT_ROWS:
            raise AssertionError(f"K7's sums form ({classes} classes): sum w is not {FIT_ROWS}")
        means = (sums[:-1] / sums[-1]).to(torch.float32)
        trial_means = (trial[:-1] / trial[-1]).to(torch.float32)
        value, dW, db = logistic.job_loss_and_grad(W[None], b[None], X, y, w, zero)
        weighted = torch.cat([dW[0].reshape(-1), db[0], value])
        if not torch.equal(means, weighted) or not torch.equal(
                trial_means, logistic.job_trial_losses(W4[None], b4[None], X, y, w, zero)[0]):
            raise AssertionError(f"K7's sums form ({classes} classes): not the weighted launch's bits")
        twin = logistic._weighted_sums(W, b, X, y, w)
        twin_means = (twin[:-1] / twin[-1]).to(torch.float32)
        twin_trial = logistic._weighted_trial_sums(W4, b4, X, y, w)
        twin_trial_means = (twin_trial[:-1] / twin_trial[-1]).to(torch.float32)
        grad_err = float((means[:-1] - twin_means[:-1]).abs().max())
        loss_rel = abs(float(means[-1]) - float(twin_means[-1])) / abs(float(twin_means[-1]))
        trial_rel = float(((trial_means - twin_trial_means).abs() / twin_trial_means.abs()).max())
        if not grad_err <= K7_GRAD_ATOL or not loss_rel <= K7_LOSS_RTOL or not trial_rel <= K7_LOSS_RTOL:
            raise AssertionError(
                f"K7's sums form ({classes} classes): gradient {grad_err}, loss {loss_rel}, "
                f"trial {trial_rel} relative"
            )
        results["logistic_loss_grad_sums"]["max_abs_err"] = max(
            results["logistic_loss_grad_sums"]["max_abs_err"], float((sums - twin).abs().max()))
        results["logistic_trial_losses_sums"]["max_abs_err"] = max(
            results["logistic_trial_losses_sums"]["max_abs_err"], float((trial - twin_trial).abs().max()))
        calls = {
            "logistic_loss_grad_sums": (
                lambda: logistic._launch_loss_grad(W[None], b[None], X, y, w, 1, sums=True),
                lambda: logistic._weighted_sums(W, b, X, y, w),
            ),
            "logistic_trial_losses_sums": (
                lambda: logistic._launch_trial_losses(W4[None], b4[None], X, y, w, 1, sums=True),
                lambda: logistic._weighted_trial_sums(W4, b4, X, y, w),
            ),
        }
        for name, (kernel, plain) in calls.items():
            bound_ms, bound_by = _k7_bound(
                rows, FEATURES, classes, name == "logistic_trial_losses_sums", weighted=True)
            results[name]["by_classes"][classes] = {
                "ms": _event_ms(torch, kernel, 20, flush),
                "warm_ms": _event_ms(torch, kernel, 50),
                "device_ms": _device_ms(torch, kernel, MULTIGPU_KERNELS[name], 20, flush),
                "plain_ms": _event_ms(torch, plain, 3, flush),
                "library_ms": None,
                "bound_ms": bound_ms, "bound_by": bound_by,
            }
    for result in results.values():
        result.update(result["by_classes"][CLASSES])
    return results


# The model axis (K7's class-shard form) and K8′ on bfloat16 rows
SHARD_REPLACES = {
    "logistic_shard_stats": (
        "learningorchestra_tpu/ml/logistic.py:35 _loss_fn with W, b sharded by class over the "
        "model axis (:516-560 _fit_prepared): log_softmax's normaliser over a rank's classes, "
        "at one point or the Armijo trial points of :176-200"
    ),
    "logistic_shard_grad": (
        "learningorchestra_tpu/ml/logistic.py:35 _loss_fn under value_and_grad with W, b sharded "
        "by class over the model axis (:516-560 _fit_prepared): a class shard's gradient and nll"
    ),
}
SHARD_KERNELS = {   # the CUDA kernels a call runs, as the profiler names them
    "logistic_shard_stats": ("shard_stats_tiles_kernel",),
    "logistic_shard_grad": ("shard_grad_tiles_kernel", "sums_kernel"),
}
SHARD_LIBRARY = {
    "logistic_shard_stats": (
        "none: no PyTorch call gives a row's softmax statistics over a subset of the classes"),
    "logistic_shard_grad": (
        "none: no PyTorch call gives a class shard's masked nll and gradient sums given each "
        "row's log-sum-exp"),
}
BF16_REPLACES = {
    "masked_col_sums_bf16": (
        "learningorchestra_tpu/ml/logistic.py:412 _masked_stats on bfloat16 rows (the masked sums "
        "and count in X's dtype, :418)"
    ),
    "masked_col_sums_centred_bf16": (
        "learningorchestra_tpu/ml/logistic.py:412 _masked_stats on bfloat16 rows (the masked "
        "variance about the bfloat16 mean)"
    ),
    "masked_standardize_bf16": "learningorchestra_tpu/ml/logistic.py:426 _standardize on bfloat16 rows",
}
BF16_WRAPPER = {   # each bfloat16 form's wrapper, and so its launch count
    "masked_col_sums_bf16": "masked_col_sums",
    "masked_col_sums_centred_bf16": "masked_col_sums_centred",
    "masked_standardize_bf16": "masked_standardize",
}
BF16_LIBRARY_NOTE = {
    "masked_col_sums_bf16": (
        "torch.var_mean on the valid bfloat16 rows: both moments at once (the stats both passes serve)"),
    "masked_col_sums_centred_bf16": (
        "torch.var_mean on the valid bfloat16 rows: both moments at once (the stats both passes serve)"),
    "masked_standardize_bf16": "none: no single PyTorch call gives ((x - mean) / scale) * w",
}
GRID_DATA, GRID_MODEL = 2, 2       # run d's mesh: four gloo ranks as data 2 x model 2
GRID_FITS = ("rf", "nb")           # run d's fits besides lr: the tree axis and one data-axis fit
BF16_STAT_ULPS = 1                 # bfloat16 mean and scale against the twin's


def _grid_block_rows() -> int:
    """Run d's block: bench.py's 1,000,000 rows padded over a data axis of 2."""
    from learningorchestra_tpu_torch.parallel.sharding import padded_row_count

    return padded_row_count(FIT_ROWS, GRID_DATA) // GRID_DATA


def _shard_bound(name: str, rows: int, features: int, classes: int, points: int = 1,
                 x_bytes: int = 4) -> tuple[float, str]:
    """K7's class-shard form: X (``x_bytes`` a value) and y read once, and
    for the gradient the row weights and each row's float64 log-sum-exp;
    the stats' 12 bytes a row and point, or the shard's float64 sums,
    written once; against per row and point 2FC + 4C float32 operations
    (the logits, the softmax's shift, exp and add), and for the gradient
    2FC float32 and 2FC + 3C + 2 float64 (the residuals and their sums)."""
    F, C = features, classes
    params = points * (F * C + C) * 4
    if name == "logistic_shard_stats":
        bytes_moved = rows * F * x_bytes + rows * 4 + params + points * rows * 12
        fp32, fp64 = rows * points * (2 * F * C + 4 * C), 0
    else:
        bytes_moved = rows * F * x_bytes + rows * 4 + rows * 4 + rows * 8 + params + (F * C + C + 2) * 8
        fp32, fp64 = rows * 2 * F * C, rows * (2 * F * C + 3 * C + 2)
    byte_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
    op_ms = (fp32 / PEAK_FP32_OPS_PER_S + fp64 / PEAK_FP64_OPS_PER_S) * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def check_k7_shards(torch, flush) -> tuple[dict, dict]:
    """K7's class-shard form on the card at run d's block (bench.py's rows
    0 .. 524,287, standardized), C = 2 and 10 over M = 2 shards (one class
    a rank, five), float32 and bfloat16 rows: each kernel against its twin
    (the stats' largest logit and label logit within K7_LOSS_RTOL of their
    scale, the sums of exps within K7_LOSS_RTOL; the shard sums, given the
    same log-sum-exp, within K7_GRAD_ATOL and K7_LOSS_RTOL once divided by
    sum w); the shards combined (their log-sums in shard order, their
    gradient columns in class order, their nll cells added) against K7's
    whole-class sums form on the same rows, gradient within K7_GRAD_ATOL
    and loss and trial losses within K7_LOSS_RTOL; a second launch bit
    identical. Also K7's sums form on the bfloat16 rows against its twin.
    Timed at every shape (events; device time on float32 rows)."""
    X_np, y_np = bench_synthetic(FIT_ROWS)
    mean, scale = logistic.scaler_stats(X_np)
    rows = _grid_block_rows()
    X32 = torch.from_numpy(logistic._standardized(X_np[:rows], mean, scale)).cuda()
    w = torch.ones(rows, dtype=torch.float32, device=X32.device)
    results = {name: {"max_abs_err": 0.0, "by_shape": {}} for name in SHARD_REPLACES}
    k7_bf16 = {}
    for classes, labels in ((CLASSES, y_np), (DEEP_CLASSES, ten_classes(X_np))):
        y = torch.from_numpy(labels[:rows].astype(np.int32)).cuda()
        rng = np.random.default_rng(classes + 200)

        def cuda(*shape):
            return torch.from_numpy((rng.normal(size=shape) * 0.3).astype(np.float32)).cuda()

        W, b, D, d = cuda(FEATURES, classes), cuda(classes), cuda(FEATURES, classes), cuda(classes)
        steps = torch.tensor([1.0, 0.5, 0.25, 0.125], device=X32.device)
        W4 = (W[None] + steps[:, None, None] * D[None]).contiguous()
        b4 = (b[None] + steps[:, None] * d[None]).contiguous()
        width = classes // GRID_MODEL
        shards = [(first, W[:, first:first + width].contiguous(), b[first:first + width].contiguous(),
                   W4[:, :, first:first + width].contiguous(), b4[:, first:first + width].contiguous())
                  for first in range(0, classes, width)]
        for dtype in (torch.float32, torch.bfloat16):
            X = X32.to(dtype)
            key = f"{rows}x{FEATURES}:C{classes}/M{GRID_MODEL}:{'bf16' if dtype == torch.bfloat16 else 'f32'}"
            what = f"K7's class-shard form at {key}"
            stats, stats4, twin_stats4 = [], [], []
            for first, Ws, bs, W4s, b4s in shards:
                for points, (Wp, bp) in ((1, (Ws[None], bs[None])), (4, (W4s, b4s))):
                    got = logistic.shard_stats(Wp, bp, X, y, first)
                    if not torch.equal(got, logistic.shard_stats(Wp, bp, X, y, first)):
                        raise AssertionError(f"{what}: a second stats launch differs")
                    want = logistic._shard_stats(Wp, bp, X, y, first)
                    logits_scale = float(want[..., 0].abs().max())
                    logit_err = float((got[..., (0, 2)] - want[..., (0, 2)]).abs().max())
                    sum_rel = float(((got[..., 1] - want[..., 1]).abs() / want[..., 1]).max())
                    if not logit_err <= K7_LOSS_RTOL * logits_scale or not sum_rel <= K7_LOSS_RTOL:
                        raise AssertionError(f"{what}: stats {logit_err} of {logits_scale}, sums {sum_rel}")
                    results["logistic_shard_stats"]["max_abs_err"] = max(
                        results["logistic_shard_stats"]["max_abs_err"], float((got - want).abs().max()))
                    (stats if points == 1 else stats4).append(got)
                    if points == 4:
                        twin_stats4.append(want)
            lse = logistic._combine_log_sums([logistic._shard_log_sums(s[0]) for s in stats])
            grads = []
            for (first, Ws, bs, _, _) in shards:
                got = logistic.shard_grad(Ws, bs, X, y, w, lse, first)
                if not torch.equal(got, logistic.shard_grad(Ws, bs, X, y, w, lse, first)):
                    raise AssertionError(f"{what}: a second grad launch differs")
                want = logistic._shard_grad(Ws, bs, X, y, w, lse, first)
                if float(got[-1]) != rows:
                    raise AssertionError(f"{what}: sum w is {float(got[-1])}, not {rows}")
                grad_err = float(((got[:-2] - want[:-2]) / rows).abs().max())
                nll_rel = abs(float(got[-2]) - float(want[-2])) / abs(float(want[-2]))
                if not grad_err <= K7_GRAD_ATOL or not nll_rel <= K7_LOSS_RTOL:
                    raise AssertionError(f"{what}: grad against its twin {grad_err}, nll {nll_rel}")
                results["logistic_shard_grad"]["max_abs_err"] = max(
                    results["logistic_shard_grad"]["max_abs_err"], float((got - want).abs().max()))
                grads.append(got)
            # the shards combined against K7's whole-class sums form on the same rows
            whole = logistic._launch_loss_grad(W[None], b[None], X, y, w, 1, sums=True)[0]
            cells = FEATURES * width
            dW = torch.cat([g[:cells].view(FEATURES, width) for g in grads], dim=1).reshape(-1)
            db = torch.cat([g[cells:cells + width] for g in grads])
            combined = torch.cat([dW, db, sum(g[-2:-1] for g in grads)]) / rows
            grad_err = float((combined[:-1] - whole[:-2] / whole[-1]).abs().max())
            loss_rel = abs(float(combined[-1]) - float(whole[-2] / whole[-1])) / float(whole[-2] / whole[-1])
            trial_whole = logistic._launch_trial_losses(W4[None], b4[None], X, y, w, 1, sums=True)[0]
            lse4 = logistic._combine_log_sums([logistic._shard_log_sums(s) for s in stats4])
            labels4 = sum((s[..., 2].to(torch.float64) * w.to(torch.float64)).sum(dim=1) for s in stats4)
            trial = ((lse4 * w.to(torch.float64)).sum(dim=1) - labels4) / rows
            trial_rel = float(((trial - trial_whole[:-1] / trial_whole[-1]).abs()
                               / (trial_whole[:-1] / trial_whole[-1]).abs()).max())
            if not grad_err <= K7_GRAD_ATOL or not loss_rel <= K7_LOSS_RTOL or not trial_rel <= K7_LOSS_RTOL:
                raise AssertionError(
                    f"{what}: combined against K7's whole classes: gradient {grad_err}, loss "
                    f"{loss_rel}, trial {trial_rel} relative")
            entry = {"combined_grad_err": grad_err, "combined_loss_rel": loss_rel,
                     "combined_trial_rel": trial_rel}
            if dtype == torch.bfloat16:   # K7's sums form on the bfloat16 rows, against its twin
                twin = logistic._weighted_sums(W, b, X, y, w)
                k7_bf16[classes] = {
                    "grad_err": float(((whole[:-2] - twin[:-2]) / rows).abs().max()),
                    "loss_rel": abs(float(whole[-2]) - float(twin[-2])) / abs(float(twin[-2])),
                }
                if not k7_bf16[classes]["grad_err"] <= K7_GRAD_ATOL or not (
                        k7_bf16[classes]["loss_rel"] <= K7_LOSS_RTOL):
                    raise AssertionError(f"K7's sums form on bfloat16 rows: {k7_bf16[classes]}")
            first, Ws, bs, W4s, b4s = shards[0]
            x_bytes = X.element_size()
            calls = {
                "logistic_shard_stats": (
                    lambda: logistic.shard_stats(W4s, b4s, X, y, first),
                    lambda: logistic._shard_stats(W4s, b4s, X, y, first),
                    _shard_bound("logistic_shard_stats", rows, FEATURES, width, 4, x_bytes)),
                "logistic_shard_grad": (
                    lambda: logistic.shard_grad(Ws, bs, X, y, w, lse, first),
                    lambda: logistic._shard_grad(Ws, bs, X, y, w, lse, first),
                    _shard_bound("logistic_shard_grad", rows, FEATURES, width, 1, x_bytes)),
            }
            for name, (kernel, plain, (bound_ms, bound_by)) in calls.items():
                results[name]["by_shape"][key] = {
                    "rows": rows, "features": FEATURES, "classes_a_shard": width,
                    "points": 4 if name == "logistic_shard_stats" else 1, **entry,
                    "ms": _event_ms(torch, kernel, 20, flush),
                    "warm_ms": _event_ms(torch, kernel, 50),
                    "device_ms": (_device_ms(torch, kernel, SHARD_KERNELS[name], 20, flush)
                                  if dtype == torch.float32 else None),
                    "plain_ms": _event_ms(torch, plain, 3, flush),
                    "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
                }
    main = f"{rows}x{FEATURES}:C{DEEP_CLASSES}/M{GRID_MODEL}:f32"   # five classes a rank
    for result in results.values():
        result.update(result["by_shape"][main])
    return results, k7_bf16


# K7's class-shard kernels at the edges of their tiles, staging and forms:
# rows about a 16-row group and a tile (0: no rows); features about the odd
# row stride and past the staging (444: the float32 stats' rows read from
# global memory; 2,000: both kernels'); classes about a 16-byte word of
# parameters and kRegisterClasses (past it each logit again; the serial
# grad form past the owners' cells); 1 and 4 points; labels in [0, 2 Cs +
# 1) about a shard from class Cs // 2, so that some lie outside it; row
# weights of 0 and 1; float32 and bfloat16 rows, each also from an address
# 4 bytes past a 16-byte boundary
SHARD_EDGE_ROWS = (0, 1, 15, 16, 17, 255, 257, 4_097)
SHARD_EDGE_FEATURES = (1, 5, 16, 17, 444, 2_000)
SHARD_EDGE_CLASSES = (1, 3, 5, 16, 17, 33)


def _held_shard_stats(what: str, got, want, X, W, b) -> tuple[float, float]:
    """The stats against their twin's at check_k7_shards' tolerances: the
    largest logit and the label logit within K7_LOSS_RTOL of the logits'
    scale, the sums of exps within K7_LOSS_RTOL. The scale is the largest
    sum of magnitudes a logit adds (|x| |W| + |b|), which bounds a float32
    chain's rounding over any width (check_k7_shards, at 524,288 rows,
    takes the largest logit). Returns the two relative errors."""
    if not got.numel():
        return 0.0, 0.0
    X64 = X.double().abs()
    scale = max(float((X64 @ W[p].double().abs() + b[p].double().abs()).max())
                for p in range(W.shape[0]))
    logit_rel = float((got[..., (0, 2)] - want[..., (0, 2)]).abs().max()) / scale
    sum_rel = float(((got[..., 1] - want[..., 1]).abs() / want[..., 1]).max())
    if not logit_rel <= K7_LOSS_RTOL or not sum_rel <= K7_LOSS_RTOL:
        raise AssertionError(f"{what}: stats {logit_rel} of the logits' scale {scale}, sums {sum_rel}")
    return logit_rel, sum_rel


def _held_shard_grad(what: str, got, want, rows: int) -> tuple[float, float]:
    """The shard sums against their twin's, as check_k7_shards holds them:
    divided by the rows, within K7_GRAD_ATOL; the nll within K7_LOSS_RTOL
    (exactly 0 where no label lies in the shard); the weights' sum exact."""
    if float(got[-1]) != float(want[-1]):
        raise AssertionError(f"{what}: sum w {float(got[-1])} against the twin's {float(want[-1])}")
    grad_err = float(((got[:-2] - want[:-2]) / max(rows, 1)).abs().max())
    nll, twin_nll = float(got[-2]), float(want[-2])
    nll_rel = abs(nll - twin_nll) / abs(twin_nll) if twin_nll else float(nll != 0.0)
    if not grad_err <= K7_GRAD_ATOL or not nll_rel <= K7_LOSS_RTOL:
        raise AssertionError(f"{what}: grad against its twin {grad_err}, nll {nll_rel}")
    return grad_err, nll_rel


def _edge_weight_scale(features: int) -> float:
    """The edge shapes' weights' scale: x W of ~N(0, 1) up to 4
    features, and past them a float32 fmaf chain whose rounding stays
    ~1e-7 (its sum of magnitudes ~2), so that a one-row shape holds K7's
    float32 logits to the twin's float64 product at K7_GRAD_ATOL over any
    width."""
    return min(1.0 / np.sqrt(features), 2.0 / features)


def check_shard_edges(torch) -> dict:
    """K7's class-shard kernels against their twins at every edge shape
    (SHARD_EDGE_ROWS x SHARD_EDGE_FEATURES x SHARD_EDGE_CLASSES, 1 and 4
    points, float32 and bfloat16 rows; seeded rows, weights of the scale
    ``_edge_weight_scale`` gives, and 0/1 row weights): the stats
    (``_held_shard_stats``) and, given a log-sum-exp over four shards (the
    twin's log-sums at the four points, combined as a model group's), the
    grad (``_held_shard_grad``) at K7's tolerances; a second launch and a
    launch on rows 4 bytes off 16 bytes bit-equal to the first. Records
    each kernel's geometries, so that a run shows every path it took."""
    started = time.perf_counter()
    record = {"shapes": 0, "stats_logit_rel": 0.0, "stats_sum_rel": 0.0, "grad_err": 0.0,
              "nll_rel": 0.0, "stats_geometries": set(), "grad_geometries": set()}
    seconds = {}
    for rows in SHARD_EDGE_ROWS:
        for features in SHARD_EDGE_FEATURES:
            shape_started = time.perf_counter()
            rng = np.random.default_rng(rows * 10_007 + features)
            X32 = torch.from_numpy(rng.normal(size=(rows, features)).astype(np.float32)).cuda()
            rows_by_type = {dtype: (X, _misaligned(torch, X)) for dtype, X in (
                (torch.float32, X32), (torch.bfloat16, X32.to(torch.bfloat16)))}
            for classes in SHARD_EDGE_CLASSES:
                W4 = torch.from_numpy((rng.normal(size=(4, features, classes))
                                       * _edge_weight_scale(features)).astype(np.float32)).cuda()
                b4 = torch.from_numpy(rng.normal(size=(4, classes)).astype(np.float32)).cuda()
                y = torch.from_numpy(rng.integers(0, 2 * classes + 1, size=rows).astype(np.int32)).cuda()
                w = torch.from_numpy((rng.random(rows) < 0.9).astype(np.float32)).cuda()
                first = classes // 2
                for dtype, (X, shifted) in rows_by_type.items():
                    what = f"K7's class-shard form at {rows}x{features}, Cs {classes}, {dtype}"
                    want = logistic._shard_stats(W4, b4, X, y, first)   # point p's twin: want[p]
                    for points in (1, 4):
                        Wp, bp = W4[:points].contiguous(), b4[:points].contiguous()
                        got = logistic.shard_stats(Wp, bp, X, y, first)
                        if not torch.equal(got, logistic.shard_stats(Wp, bp, X, y, first)) or \
                                not torch.equal(got, logistic.shard_stats(Wp, bp, shifted, y, first)):
                            raise AssertionError(f"{what}, {points} points: stats not bit-equal "
                                                 "on a second launch or rows 4 bytes off")
                        logit_rel, sum_rel = _held_shard_stats(f"{what}, {points} points", got,
                                                               want[:points], X, Wp, bp)
                        record["stats_logit_rel"] = max(record["stats_logit_rel"], logit_rel)
                        record["stats_sum_rel"] = max(record["stats_sum_rel"], sum_rel)
                        record["stats_geometries"].add(logistic._shard_stats_geometry(
                            features, classes, points, X.element_size()))
                    # each row's log-sum-exp over a model group of four: this
                    # shard's classes and three others' (the twin's at points 1-3)
                    W, b = W4[0].contiguous(), b4[0].contiguous()
                    lse = logistic._combine_log_sums([logistic._shard_log_sums(part) for part in want])
                    got = logistic.shard_grad(W, b, X, y, w, lse, first)
                    if not torch.equal(got, logistic.shard_grad(W, b, X, y, w, lse, first)) or \
                            not torch.equal(got, logistic.shard_grad(W, b, shifted, y, w, lse, first)):
                        raise AssertionError(f"{what}: grad not bit-equal on a second launch or rows "
                                             "4 bytes off")
                    grad_err, nll_rel = _held_shard_grad(
                        what, got, logistic._shard_grad(W, b, X, y, w, lse, first), rows)
                    record["grad_err"] = max(record["grad_err"], grad_err)
                    record["nll_rel"] = max(record["nll_rel"], nll_rel)
                    record["grad_geometries"].add(logistic._shard_grad_geometry(
                        features, classes, X.element_size()))
                    record["shapes"] += 1
            seconds[f"{rows}x{features}"] = time.perf_counter() - shape_started
    for key in ("stats_geometries", "grad_geometries"):
        record[key] = [list(geometry) for geometry in sorted(record[key])]
    record["seconds"] = time.perf_counter() - started
    record["seconds_by_shape"] = seconds
    return record


def _bf16_ulps(torch, got, want) -> int:
    """The largest distance in bfloat16 steps between two bfloat16 tensors."""
    def steps(values):
        return (values.to(torch.float32).view(torch.int32) >> 16).to(torch.int64)

    return int((steps(got) - steps(want)).abs().max())


def check_scaler_bf16(torch, flush) -> tuple[dict, dict]:
    """K8′ on bfloat16 rows against its twins at SCALER_SHAPES (the main
    path's block of 1,048,576 rows, 1,000,000 of them valid, and 4,096 rows
    of several widths): both passes' float64 sums within SCALER_SUM_RTOL
    of the largest sum, the count exact and its bfloat16 rounding the
    twin's (999,424 for 1,000,000 rows), a second launch bit identical;
    masked_stats' bfloat16 mean and scale within BF16_STAT_ULPS of the
    twins'; masked_standardize bit-equal to its twin, padded rows zero.
    Timed at every shape: events cold and warm, device time at the main
    shape, the twins; torch.var_mean on the valid bfloat16 rows at the
    main shape beside masked_stats."""
    results = {name: {"max_abs_err": 0.0, "by_shape": {}} for name in BF16_REPLACES}
    stats_timing = None
    for rows, features, valid in SCALER_SHAPES:
        X32, w = _scaler_inputs(torch, rows, features, valid, seed=rows + features)
        X = X32.to(torch.bfloat16)
        key = f"{rows}x{features}"
        first = logistic.masked_col_sums(X, w)
        want_first = logistic._masked_col_sums(X, w)
        count = logistic._bf16(first[-1])
        mean, scale = logistic.masked_stats(X, w)
        mean64 = mean.to(torch.float64)
        second = logistic.masked_col_sums(X, w, mean64)
        want_second = logistic._masked_col_sums(X, w, mean64)
        for name, got, want, again in (
            ("masked_col_sums_bf16", first, want_first, logistic.masked_col_sums(X, w)),
            ("masked_col_sums_centred_bf16", second, want_second, logistic.masked_col_sums(X, w, mean64)),
        ):
            if not torch.equal(got, again):
                raise AssertionError(f"{name} at {key}: a second launch differs")
            if float(got[-1]) != valid or not torch.equal(count, logistic._bf16(want[-1])):
                raise AssertionError(f"{name} at {key}: the weights sum to {float(got[-1])}, not {valid}")
            error = _relative_error(got, want)
            if not error <= SCALER_SUM_RTOL:
                raise AssertionError(f"{name} at {key}: {error} relative to the largest sum")
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"], float((got - want).abs().max()))
        twin_count = logistic._bf16(want_first[-1]).to(torch.float32)
        twin_mean = logistic._bf16(logistic._bf16(want_first[:-1]).to(torch.float32) / twin_count)
        twin_var = logistic._bf16(logistic._bf16(want_second[:-1]).to(torch.float32) / twin_count)
        twin_std = logistic._bf16(torch.sqrt(twin_var.to(torch.float32)))
        twin_scale = torch.where(twin_std > 0, twin_std, torch.ones_like(twin_std))
        ulps = max(_bf16_ulps(torch, mean, twin_mean), _bf16_ulps(torch, scale, twin_scale))
        if not ulps <= BF16_STAT_ULPS:
            raise AssertionError(f"masked_stats on bfloat16 rows at {key}: {ulps} ulps from the twins'")
        standardized = logistic.standardize(X, mean, scale, w)
        if not torch.equal(standardized, logistic._standardize(X, mean, scale, w)):
            raise AssertionError(f"masked_standardize_bf16 at {key}: not bit-equal to its twin")
        if bool(standardized[valid:].any()):
            raise AssertionError(f"masked_standardize_bf16 at {key}: a padded row is not zero")
        calls = {
            "masked_col_sums_bf16": (lambda: logistic.masked_col_sums(X, w),
                                     lambda: logistic._masked_col_sums(X, w), "masked_col_sums"),
            "masked_col_sums_centred_bf16": (lambda: logistic.masked_col_sums(X, w, mean64),
                                             lambda: logistic._masked_col_sums(X, w, mean64),
                                             "masked_col_sums_centred"),
            "masked_standardize_bf16": (lambda: logistic.standardize(X, mean, scale, w),
                                        lambda: logistic._standardize(X, mean, scale, w),
                                        "masked_standardize"),
        }
        main = rows == SCALER_SHAPES[0][0]
        library_ms = _event_ms(torch, lambda: torch.var_mean(X[:valid], dim=0, correction=0), 20, flush) \
            if main else None
        for name, (kernel, plain, bound_name) in calls.items():
            bound_ms, bound_by = _scaler_bound(bound_name, rows, features, x_bytes=2)
            results[name]["by_shape"][key] = {
                "rows": rows, "valid_rows": valid, "features": features, "stat_ulps": ulps,
                "count": float(count),
                "ms": _event_ms(torch, kernel, 20, flush),
                "warm_ms": _event_ms(torch, kernel, 50),
                "device_ms": _device_ms(torch, kernel, MULTIGPU_KERNELS[bound_name], 20, flush) if main else None,
                "plain_ms": _event_ms(torch, plain, 5, flush),
                "library_ms": library_ms if name != "masked_standardize_bf16" else None,
                "bound_ms": bound_ms, "bound_by": bound_by,
            }
        if main:
            whole = lambda: logistic.masked_stats(X, w)   # noqa: E731
            stats_timing = {
                "rows": rows, "valid_rows": valid, "features": features,
                "masked_stats_ms": _event_ms(torch, whole, 20, flush),
                "masked_stats_warm_ms": _event_ms(torch, whole, 50),
                "var_mean_ms": library_ms,
                "bound_ms": sum(_scaler_bound(name, rows, features, x_bytes=2)[0]
                                for name in ("masked_col_sums", "masked_col_sums_centred")),
            }
    main_key = f"{SCALER_SHAPES[0][0]}x{SCALER_SHAPES[0][1]}"
    for result in results.values():
        result.update(result["by_shape"][main_key])
    return results, stats_timing


# The other fits, PCA and t-SNE over ranks: the four new kernel forms
FORMS_REPLACES = {
    "level_histograms_sums": (
        "learningorchestra_tpu/ml/trees.py:66 _level_histograms on a row-sharded mesh "
        "(gb's (g, h); XLA's psum across the data axis)"
    ),
    "leaf_sums_sums": (
        "learningorchestra_tpu/ml/trees.py:142 _leaf_sums on a row-sharded mesh "
        "(gb's (g, h); XLA's psum across the data axis)"
    ),
    "tsne_affinities_slab": (
        "learningorchestra_tpu/ops/tsne.py:122 _affinities, its local_slab under shard_map (:138-160)"
    ),
    "tsne_z_slab": (
        "learningorchestra_tpu/ops/tsne.py:170 _optimize, a slab's part of the Q normalizer "
        "before its psum (:192-197)"
    ),
    "tsne_grad_slab": (
        "learningorchestra_tpu/ops/tsne.py:170 _optimize, a slab's gradient rows before "
        "their all_gather (:197-205)"
    ),
}
FORMS_SOURCE = {
    "level_histograms_sums": FIT_SOURCE, "leaf_sums_sums": FIT_SOURCE,
    "tsne_affinities_slab": TSNE_SOURCE, "tsne_z_slab": TSNE_SOURCE, "tsne_grad_slab": TSNE_SOURCE,
}
FORM_KERNELS = {   # the CUDA kernels a call runs, as the profiler names them
    "level_histograms_sums": ("level_histograms_kernel", "sum_partials_kernel", "partition_rows_kernel"),
    "leaf_sums_sums": ("leaf_sums_kernel", "sum_partials_kernel"),
    "tsne_affinities_slab": ("distances_kernel", "affinities_kernel"),
    "tsne_z_slab": ("z_slab_tiles_kernel", "slab_total_kernel"),
    "tsne_grad_slab": ("grad_slab_tiles_kernel", "gradient_finish_kernel"),
}
FORMS_LIBRARY = {
    "level_histograms_sums": "none: no PyTorch call gives float64 (node, feature, bin) sums of (g, h)",
    "leaf_sums_sums": "none: no PyTorch call gives float64 (leaf, channel) sums in a fixed order",
    "tsne_affinities_slab": "none: no PyTorch call calibrates affinities to a perplexity",
    "tsne_z_slab": "none: no PyTorch call gives t-SNE's normaliser",
    "tsne_grad_slab": "none: no PyTorch call gives the t-SNE gradient",
}
FORM_SUM_RTOL = 1e-12           # the sums forms against their twins, of the largest sum
MULTIGPU_BLOCK_ROWS = SCALER_SHAPES[0][0] // MULTIGPU_GLOO_RANKS   # run (c)'s block: 262,144
MULTIGPU_SLABS = MULTIGPU_GLOO_RANKS   # the landmark fit's rows cut four ways
MULTIGPU_PCA_RTOL = 1e-3        # PCA over ranks against one process, of the largest coordinate
MULTIGPU_GB_MARGIN_TOL = 1e-5   # gb's margins over ranks against one process
MULTIGPU_NB_TOL = 1e-6          # nb's probabilities over ranks against one process


def _row_slabs(n: int, ranks: int) -> list:
    """Each rank's rows of an ``n``-row array under the block rule
    (``parallel.host_row_range``): the padded rows' blocks, clamped to n."""
    from learningorchestra_tpu_torch.parallel.sharding import padded_row_count

    block = padded_row_count(n, ranks) // ranks
    return [(min(r * block, n), min((r + 1) * block, n)) for r in range(ranks)]


def _sums_bound(name: str, rows: int, cells: int, channels: int = 2) -> tuple[float, str]:
    """K2's and K5's sums forms: the rows' bins (int8, K2 only), nodes and
    channels read once, the float64 cells written once, against a float64
    add a (row, feature, channel) (K2) or a (row, channel) (K5)."""
    if name == "level_histograms_sums":
        bytes_moved = rows * FEATURES + rows * 4 + rows * channels * 4 + cells * 8
        ops = rows * FEATURES * channels
    else:
        bytes_moved = rows * 4 + rows * channels * 4 + cells * 8
        ops = rows * channels
    byte_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
    op_ms = ops / PEAK_FP64_OPS_PER_S * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def _slab_bound(name: str, slab: int, n: int, features: int = FEATURES) -> tuple[float, str]:
    """The row slabs: K11 reads X and writes the slab's (slab, n) P, its
    pairs' float32 instructions as K11's; K12 reads Y (and for the gradient
    the slab of P) and writes its float64 part of Z or the slab's gradient,
    its slab x (n - 1) ordered pairs' float32 instructions (a pair's
    inverse for Z; the inverse, q and its floor, the exaggerated P less q
    and W for the gradient) at the float32 instruction rate, and their
    float64 ones (Z's add; the gradient's add and two fused multiply-adds)
    at the float64 rate."""
    pairs = slab * max(n - 1, 0)
    fp64 = 0
    if name == "tsne_affinities_slab":
        bytes_moved = n * features * 4 + slab * n * 4
        instructions = slab * n * (features + 3 + TSNE_AFFINITY_INSTRUCTIONS)
    elif name == "tsne_z_slab":
        bytes_moved = n * 8 + 8
        instructions, fp64 = pairs * TSNE_INVERSE_INSTRUCTIONS, pairs
    else:
        bytes_moved = slab * n * 4 + n * 8 + slab * 8 + 4
        instructions, fp64 = pairs * (TSNE_INVERSE_INSTRUCTIONS + 2 + 3), 3 * pairs
    byte_ms = bytes_moved / PEAK_BYTES_PER_S * 1e3
    op_ms = (instructions / PEAK_FP32_INSTRUCTIONS_PER_S + fp64 / PEAK_FP64_INSTRUCTIONS_PER_S) * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def _form_times(torch, name: str, kernel, plain, bound, flush, read_flush) -> dict:
    """A new form's times: event ms cold (L2 overwritten) and warm, device
    ms cold and with L2 evicted by reads, the twin's ms cold, the bound."""
    bound_ms, bound_by = bound
    return {
        "ms": _event_ms(torch, kernel, 10, flush),
        "warm_ms": _event_ms(torch, kernel, 20),
        "device_ms": _device_ms(torch, kernel, FORM_KERNELS[name], 10, flush),
        "device_ms_clean_l2": _device_ms(torch, kernel, FORM_KERNELS[name], 10, read_flush),
        "plain_ms": _event_ms(torch, plain, 3, flush),
        "library_ms": None,
        "bound_ms": bound_ms, "bound_by": bound_by,
    }


def check_sum_forms(torch, flush) -> dict:
    """K2's and K5's sums forms at a depth-5 gb fit's levels and leaves on
    one rank's block: bench.py's 1,000,000 rows padded to 1,048,576 (the
    padding weighted 0), the block of rank 0 of four (262,144 rows) and of
    one (1,048,576), the (g, h) of the first boosting round. Each level's
    and the leaves' float64 sums within FORM_SUM_RTOL of the largest of
    the twin's, a second launch bit identical, and rounded once bit-equal
    to today's float32 launch on the same rows. Times at the deepest level
    and at the leaves of each block."""
    X_np, y_np = bench_synthetic(FIT_ROWS)
    rows = SCALER_SHAPES[0][0]
    X_block = np.zeros((rows, FEATURES), np.float32)
    X_block[:FIT_ROWS] = X_np
    y_block = np.zeros(rows, np.int64)
    y_block[:FIT_ROWS] = y_np
    thresholds = torch.from_numpy(binning.make_thresholds(X_np, MAX_BINS).astype(np.float32)).cuda()
    bins = binning.apply_bins(torch.from_numpy(X_block).cuda(), thresholds)
    weights = torch.from_numpy((np.arange(rows) < FIT_ROWS).astype(np.float32)).cuda()
    y = torch.from_numpy(y_block).cuda()
    f0, margins = trees._gbt_init(y, weights)
    p = torch.sigmoid(margins)
    channels = torch.stack([(p - y.to(torch.float32)) * weights,
                            (p * (1 - p)).clamp(min=1e-6) * weights], dim=1)
    read_flush = _ReadFlush(torch, flush.device)
    names = ("level_histograms_sums", "leaf_sums_sums")
    results = {name: {"max_abs_err": 0.0, "max_rel_err": 0.0, "by_shape": {}} for name in names}

    def held(name, key, got, twin, rounded, again):
        if not torch.equal(got, again):
            raise AssertionError(f"{name} at {key}: a second launch differs")
        if not torch.equal(got.to(torch.float32), rounded):
            raise AssertionError(f"{name} at {key}: rounded once, not the float32 launch's bits")
        error = _relative_error(got, twin)
        if not error <= FORM_SUM_RTOL:
            raise AssertionError(f"{name} at {key}: {error} of the largest sum from the twin")
        results[name]["max_rel_err"] = max(results[name]["max_rel_err"], error)
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], float((got - twin).abs().max()))

    for block_rows in (MULTIGPU_BLOCK_ROWS, rows):
        b, ch = bins[:block_rows], channels[:block_rows].contiguous()
        node = torch.zeros(block_rows, dtype=torch.int32, device=bins.device)
        for level in range(DEPTH):
            n_nodes, key = 2**level, f"{block_rows}:level{level}"

            def form(node=node, n_nodes=n_nodes):
                return trees.level_histograms(b, node, ch, n_nodes, MAX_BINS, sums=True)

            def twin(node=node, n_nodes=n_nodes):
                return trees._level_histograms(b, node, ch, n_nodes, MAX_BINS, sums=True)

            got = form()
            held("level_histograms_sums", key, got, twin(),
                 trees.level_histograms(b, node, ch, n_nodes, MAX_BINS), form())
            if level == DEPTH - 1:
                results["level_histograms_sums"]["by_shape"][key] = {
                    "rows": block_rows, "nodes": n_nodes,
                    **_form_times(torch, "level_histograms_sums", form, twin,
                                  _sums_bound("level_histograms_sums", block_rows, got.numel() // 2),
                                  flush, read_flush),
                }
            feature, bin_index = trees.select_splits(got.to(torch.float32), "newton")
            node = trees.route(b, node, feature, bin_index)
        key = f"{block_rows}:leaves"

        def leaves(node=node):
            return trees.leaf_sums(node, ch, 2**DEPTH, sums=True)

        def leaves_twin(node=node):
            return trees._leaf_sums(node, ch, 2**DEPTH, sums=True)

        got = leaves()
        held("leaf_sums_sums", key, got, leaves_twin(), trees.leaf_sums(node, ch, 2**DEPTH), leaves())
        results["leaf_sums_sums"]["by_shape"][key] = {
            "rows": block_rows, "leaves": 2**DEPTH,
            **_form_times(torch, "leaf_sums_sums", leaves, leaves_twin,
                          _sums_bound("leaf_sums_sums", block_rows, got.numel() // 2), flush, read_flush),
        }
    del read_flush
    for name, result in results.items():   # at run (c)'s block, the deepest level or the leaves
        main = f"{MULTIGPU_BLOCK_ROWS}:{'level' + str(DEPTH - 1) if name == 'level_histograms_sums' else 'leaves'}"
        result.update(result["by_shape"][main])
    return results


def check_slab_forms(torch, flush) -> dict:
    """K11's and K12's row slabs at the landmark fit's shape: the 5,000
    landmarks of bench.py's 1,000,000 embedding rows (seed 0), cut four
    ways by the block rule. K11: each slab's rows bit-equal to the same
    rows of the whole launch (a row's arithmetic is the whole launch's),
    and within K11_TOL of each row's largest p from the twin. K12 at the
    fit's start Y0 (exaggeration 12) and at its final embedding (a
    one-process exact fit of 1,000 iterations): the slabs' float64 parts of
    Z added in rank order within K12_Z_RTOL of the twins', the gradient
    rows no farther from a float64 evaluation than the twin's (within the
    embed-kernels tolerance of the twin), a second launch bit identical;
    then K12's slab at the edges of its tiles (``check_slab_edges``).
    Times at slab 0 (the final embedding for K12)."""
    X_np, _ = embed_blobs(EMBED_ROWS)
    chosen = tsne._choose_landmarks(EMBED_ROWS, tsne.LANDMARKS, 0)
    L = torch.from_numpy(X_np[chosen]).cuda()
    n = L.shape[0]
    perplexity = tsne._clamped_perplexity(tsne.PERPLEXITY, n)
    slabs = _row_slabs(n, MULTIGPU_SLABS)
    names = ("tsne_affinities_slab", "tsne_z_slab", "tsne_grad_slab")
    results = {name: {"max_abs_err": 0.0, "max_rel_err": 0.0, "by_rows": {}} for name in names}
    whole = tsne.conditional_affinities(L, perplexity)
    bit_equal = True
    for first, stop in slabs:
        slab = tsne.conditional_affinities_slab(L, perplexity, first, stop - first)
        if not torch.equal(slab, tsne.conditional_affinities_slab(L, perplexity, first, stop - first)):
            raise AssertionError(f"tsne_affinities_slab [{first}, {stop}): a second launch differs")
        twin = tsne._conditional_affinities_slab(L, perplexity, first, stop - first)
        row_max = twin.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
        error = float(((slab - twin).abs() / row_max).max())
        if not error <= K11_TOL:
            raise AssertionError(f"tsne_affinities_slab [{first}, {stop}): {error} of a row's largest p")
        results["tsne_affinities_slab"]["max_rel_err"] = max(results["tsne_affinities_slab"]["max_rel_err"], error)
        results["tsne_affinities_slab"]["max_abs_err"] = max(
            results["tsne_affinities_slab"]["max_abs_err"], float((slab - twin).abs().max()))
        if not torch.equal(slab, whole[first:stop]):
            bit_equal = False
            whole_error = float(((slab - whole[first:stop]).abs() / row_max).max())
            if not whole_error <= K11_TOL:
                raise AssertionError(
                    f"tsne_affinities_slab [{first}, {stop}): {whole_error} from the whole launch's rows")
    results["tsne_affinities_slab"]["bit_equal_to_the_whole_launch"] = bit_equal
    P = tsne._symmetrize(whole)
    del whole
    Y0 = tsne._initial_embedding(n, 0, L.device)
    Y_final = tsne._tsne_exact(L, tsne.PERPLEXITY, tsne.ITERATIONS, tsne.LEARNING_RATE, Y0)
    read_flush = _ReadFlush(torch, flush.device)
    for label, Y, exaggeration in (("start", Y0, tsne.EARLY_EXAGGERATION), ("final", Y_final, 1.0)):
        key = f"{n}:{label}"
        parts = [tsne.tsne_z_slab(Y, first, stop - first) for first, stop in slabs]
        again = [tsne.tsne_z_slab(Y, first, stop - first) for first, stop in slabs]
        if not all(torch.equal(a, b) for a, b in zip(parts, again)):
            raise AssertionError(f"tsne_z_slab at {key}: a second launch differs")
        Z64 = parts[0]
        twin64 = tsne._tsne_z_slab(Y, *_as_slab(slabs[0]))
        for part, (first, stop) in zip(parts[1:], slabs[1:]):
            Z64 = Z64 + part
            twin64 = twin64 + tsne._tsne_z_slab(Y, first, stop - first)
        z_rel = abs(float(Z64) - float(twin64)) / float(twin64)
        if not z_rel <= K12_Z_RTOL:
            raise AssertionError(f"tsne_z_slab at {key}: {z_rel} relative to the twins' Z")
        results["tsne_z_slab"]["max_rel_err"] = max(results["tsne_z_slab"]["max_rel_err"], z_rel)
        results["tsne_z_slab"]["max_abs_err"] = max(
            results["tsne_z_slab"]["max_abs_err"], abs(float(Z64) - float(twin64)))
        Z = Z64.to(torch.float32)
        grads, twins, grads64 = [], [], []
        for first, stop in slabs:
            P_slab = P[first:stop].contiguous()
            grad = tsne.tsne_grad_slab(Y, P_slab, Z, first, exaggeration)
            if not torch.equal(grad, tsne.tsne_grad_slab(Y, P_slab, Z, first, exaggeration)):
                raise AssertionError(f"tsne_grad_slab at {key}: a second launch differs")
            grads.append(grad)
            twins.append(tsne._tsne_grad_slab(Y, P_slab, Z, first, exaggeration))
            grads64.append(tsne._tsne_grad_slab(Y.double(), P_slab.double(), Z.double(), first, exaggeration))
        held = _held_slab_gradient(key, torch.cat(grads), torch.cat(twins), torch.cat(grads64))
        results["tsne_grad_slab"]["max_rel_err"] = max(results["tsne_grad_slab"]["max_rel_err"],
                                                       held["max_rel_err"])
        results["tsne_grad_slab"]["max_abs_err"] = max(results["tsne_grad_slab"]["max_abs_err"],
                                                       held["max_abs_err"])
        results["tsne_grad_slab"]["by_rows"][key] = {"float64_err": held["float64_err"],
                                                    "twin_float64_err": held["twin_float64_err"]}
        if label == "final":
            first, stop = slabs[0]
            P_slab = P[first:stop].contiguous()
            slab_rows = stop - first
            results["tsne_z_slab"]["by_rows"][key] = {"rows": slab_rows, "columns": n, **_form_times(
                torch, "tsne_z_slab", lambda: tsne.tsne_z_slab(Y, first, slab_rows),
                lambda: tsne._tsne_z_slab(Y, first, slab_rows),
                _slab_bound("tsne_z_slab", slab_rows, n), flush, read_flush)}
            results["tsne_grad_slab"]["by_rows"][key].update({"rows": slab_rows, "columns": n, **_form_times(
                torch, "tsne_grad_slab", lambda: tsne.tsne_grad_slab(Y, P_slab, Z, first, 1.0),
                lambda: tsne._tsne_grad_slab(Y, P_slab, Z, first, 1.0),
                _slab_bound("tsne_grad_slab", slab_rows, n), flush, read_flush)})
    first, stop = slabs[0]
    results["tsne_affinities_slab"]["by_rows"][f"{n}:slab0"] = {"rows": stop - first, "columns": n, **_form_times(
        torch, "tsne_affinities_slab",
        lambda: tsne.conditional_affinities_slab(L, perplexity, first, stop - first),
        lambda: tsne._conditional_affinities_slab(L, perplexity, first, stop - first),
        _slab_bound("tsne_affinities_slab", stop - first, n), flush, read_flush)}
    del read_flush
    for name, result in results.items():
        result.update(result["by_rows"][f"{n}:slab0" if name == "tsne_affinities_slab" else f"{n}:final"])
    edges = check_slab_edges(torch)
    results["tsne_z_slab"]["edges"] = {key: {"slabs": edge["slabs"], "rel_err": edge["z_rel_err"]}
                                       for key, edge in edges.items()}
    results["tsne_grad_slab"]["edges"] = {key: {field: value for field, value in edge.items()
                                                if field != "z_rel_err"} for key, edge in edges.items()}
    return results


# K12's slab kernels at the edges of their tiles: n rows cut 1, 3 and 4
# ways by the block rule (so that a slab starts mid-tile, and some slabs
# are empty), odd n taking the 4-byte path for P; at n % 4 == 0 the slabs
# of P also 4 bytes past a 16-byte boundary, which takes the 4-byte path
# and must give the 16-byte path's bits
SLAB_EDGE_ROWS = (1, 2, 33, 127, 129, 132, 1_001, 5_000)
SLAB_EDGE_WAYS = (1, 3, 4)


def _misaligned(torch, tensor):
    """A copy of ``tensor`` whose data starts 4 bytes past a 16-byte
    boundary."""
    step = 4 // tensor.element_size()
    buffer = torch.empty(tensor.numel() + 4, dtype=tensor.dtype, device=tensor.device)
    copy = buffer[step:step + tensor.numel()].view(tensor.shape)
    copy.copy_(tensor)
    return copy


def _held_slab_gradient(key: str, grad, twin, grad64) -> dict:
    """The slab gradient rows against the twin's and float64's, as the
    embed-kernels phase holds K12: within max(K12_PLAIN_TOL, 2 x the twin's
    float64 error + K12_FLOAT64_SLACK) of the twin's largest entry, and no
    farther from float64 than the twin (+ K12_FLOAT64_SLACK)."""
    scale64 = float(grad64.abs().max()) if grad64.numel() else 0.0
    scale64 = scale64 or 1.0
    float64_err = float((grad - grad64).abs().max()) / scale64 if grad.numel() else 0.0
    twin_float64_err = float((twin - grad64).abs().max()) / scale64 if grad.numel() else 0.0
    difference = float((grad - twin).abs().max()) if grad.numel() else 0.0
    rel = difference / ((float(twin.abs().max()) if twin.numel() else 0.0) or 1.0)
    tolerance = max(K12_PLAIN_TOL, 2.0 * twin_float64_err + K12_FLOAT64_SLACK)
    if not rel <= tolerance or not float64_err <= twin_float64_err + K12_FLOAT64_SLACK:
        raise AssertionError(
            f"tsne_grad_slab at {key}: {rel} of the twin's largest (tolerance {tolerance}); "
            f"{float64_err} from float64 against the twin's {twin_float64_err}")
    return {"max_abs_err": difference, "max_rel_err": rel, "float64_err": float64_err,
            "twin_float64_err": twin_float64_err}


def check_slab_edges(torch) -> dict:
    """K12's slab kernels against their twins at SLAB_EDGE_ROWS rows cut
    SLAB_EDGE_WAYS ways (a seeded Y of coordinates ~5 and a P that is not
    symmetric, exaggeration 12): the slabs' float64 parts of Z added in
    rank order within K12_Z_RTOL of the twins' (0 where there is no pair),
    the gradient rows held as ``_held_slab_gradient`` holds them, a second
    launch bit identical, and at n % 4 == 0 a misaligned P's rows (the
    4-byte path) bit-equal to the aligned ones (the 16-byte path)."""
    results = {}
    for n in SLAB_EDGE_ROWS:
        rng = np.random.default_rng(n)
        Y = torch.from_numpy((rng.normal(size=(n, 2)) * 5.0).astype(np.float32)).cuda()
        P_np = rng.random((n, n), dtype=np.float32)
        P = torch.from_numpy(P_np / P_np.sum(dtype=np.float64).astype(np.float32)).cuda()
        for ways in SLAB_EDGE_WAYS:
            key = f"{n}/{ways}"
            slabs = _row_slabs(n, ways)
            parts = [tsne.tsne_z_slab(Y, first, stop - first) for first, stop in slabs]
            if not all(torch.equal(part, tsne.tsne_z_slab(Y, first, stop - first))
                       for part, (first, stop) in zip(parts, slabs)):
                raise AssertionError(f"tsne_z_slab at {key}: a second launch differs")
            Z64, twin64 = parts[0], tsne._tsne_z_slab(Y, *_as_slab(slabs[0]))
            for part, (first, stop) in zip(parts[1:], slabs[1:]):
                Z64, twin64 = Z64 + part, twin64 + tsne._tsne_z_slab(Y, first, stop - first)
            z_difference = abs(float(Z64) - float(twin64))
            if not z_difference <= K12_Z_RTOL * float(twin64):
                raise AssertionError(f"tsne_z_slab at {key}: {Z64} against the twins' {twin64}")
            Z = Z64.to(torch.float32)
            grads, twins, grads64, misaligned = [], [], [], n % 4 == 0
            for first, stop in slabs:
                P_slab = P[first:stop].contiguous()
                grad = tsne.tsne_grad_slab(Y, P_slab, Z, first, tsne.EARLY_EXAGGERATION)
                if not torch.equal(grad, tsne.tsne_grad_slab(Y, P_slab, Z, first, tsne.EARLY_EXAGGERATION)):
                    raise AssertionError(f"tsne_grad_slab at {key} [{first}, {stop}): a second launch differs")
                if misaligned and not torch.equal(grad, tsne.tsne_grad_slab(
                        Y, _misaligned(torch, P_slab), Z, first, tsne.EARLY_EXAGGERATION)):
                    raise AssertionError(
                        f"tsne_grad_slab at {key} [{first}, {stop}): the 4-byte path's rows differ "
                        "from the 16-byte path's")
                grads.append(grad)
                twins.append(tsne._tsne_grad_slab(Y, P_slab, Z, first, tsne.EARLY_EXAGGERATION))
                grads64.append(tsne._tsne_grad_slab(Y.double(), P_slab.double(), Z.double(), first,
                                                    tsne.EARLY_EXAGGERATION))
            held = _held_slab_gradient(key, torch.cat(grads), torch.cat(twins), torch.cat(grads64))
            results[key] = {"slabs": [stop - first for first, stop in slabs],
                            "z_rel_err": z_difference / (float(twin64) or 1.0),
                            "vector_path": n % 4 == 0, "misaligned_bit_equal": misaligned or None,
                            **{f"grad_{field}": value for field, value in held.items()}}
    return results


def _as_slab(bounds) -> tuple:
    first, stop = bounds
    return first, stop - first


def _gb_margins(torch, model, X_dev):
    """gb's margins ``f0 + sum(step * leaf)`` over the rounds in order, as
    the forward adds them (``trees._gbt_forward`` before its sigmoid)."""
    step = torch.tensor(model.step, dtype=torch.float32, device=X_dev.device)
    margins = torch.full((X_dev.shape[0],), model.f0, dtype=torch.float32, device=X_dev.device)
    for tree in range(model.features_heap.shape[0]):
        leaf = trees._descend(X_dev, model.features_heap[tree], model.thresholds_heap[tree], model.max_depth)
        margins = margins + step * model.leaf_values[tree][leaf]
    return margins


def _fit_arrays(torch, name: str, model, X_dev) -> dict:
    """The parameters of a fit that the parent holds against the one-process
    fit's, on the host."""
    if name == "nb":
        return {"theta": model.theta.cpu().numpy(), "prior": model.prior.cpu().numpy()}
    arrays = {field: getattr(model, field).cpu().numpy()
              for field in ("features_heap", "thresholds_heap", "leaf_probs", "leaf_values")
              if hasattr(model, field)}
    if name == "gb":
        arrays["margins"] = _gb_margins(torch, model, X_dev).cpu().numpy()
        arrays["f0"] = np.float32(model.f0)
    return arrays


OTHER_FITS = ("dt", "rf", "gb", "nb")
# each rank's launches in run (c)'s sweeps, by kind: the kernels line's
# job-axis entries list them beside the sweep phase's single-card ones
MULTIGPU_SWEEP_LAUNCHES: dict = {}
COLLECTIVE_FIELDS = ("collective_s", "collectives", "model_collective_s", "model_collectives")
# a child's lr fits: bench.py's two classes always; ten classes and the
# bfloat16 policy where the run asks for them
LR_FITS = {"fit_sharded": CLASSES, "fit_sharded_ten": DEEP_CLASSES, "fit_sharded_bf16": CLASSES}


def _other_fits_over_ranks(torch, mesh, X, y, rank: int, folder: str, names=OTHER_FITS,
                           embeds: bool = True) -> tuple:
    """The SPMD ``fit(X, y)`` of ``names`` (dt, rf, gb and nb) on bench.py's
    rows (every rank passes them all) with ``evaluate_predict`` over the
    ranks, and (``embeds``) PCA of the 1,000,000 embed blobs and a landmark
    t-SNE request on them, each with the counts set to 0 just before it.
    Rank 0 saves what the parent holds against the one-process fits.
    Returns the records and a digest of every result's bits."""
    import hashlib

    from learningorchestra_tpu_torch.parallel import multihost

    digest = hashlib.sha256()
    records = {}
    X_dev = torch.from_numpy(X).to(mesh.device)

    def run(fn):
        kernels.reset_launches()
        multihost.reset_collective_stats()
        began = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - began
        collectives = multihost.collective_stats()
        return result, {"wall_s": wall_s, "launches": {k: v for k, v in kernels.launches().items() if v},
                        **{field: collectives[field] for field in COLLECTIVE_FIELDS}}

    estimators = {
        "dt": lambda: trees.DecisionTreeClassifier(mesh=mesh),
        "rf": lambda: trees.RandomForestClassifier(mesh=mesh),
        "gb": lambda: trees.GBTClassifier(mesh=mesh),
        "nb": lambda: naive_bayes.NaiveBayes(mesh=mesh),
    }
    for name in names:
        model, record = run(lambda: estimators[name]().fit(X, y))
        (accuracy, weighted_f1, labels, probs), evaluated = run(lambda: model.evaluate_predict(X, y, X))
        arrays = _fit_arrays(torch, name, model, X_dev)
        arrays["probs"] = probs
        for key in sorted(arrays):
            digest.update(np.ascontiguousarray(arrays[key]).tobytes())
        record.update(accuracy=accuracy, weighted_f1=weighted_f1, evaluate=evaluated,
                      mesh_data=model.mesh.shape["data"])
        records[name] = record
        if rank == 0:
            np.savez(os.path.join(folder, f"{name}.npz"), **arrays)
    if not embeds:
        return records, digest.hexdigest()
    X_embed, _ = embed_blobs(EMBED_ROWS)
    embedded, records["pca"] = run(lambda: pca.pca_embedding(X_embed, mesh=mesh))
    digest.update(embedded.tobytes())
    placed, records["tsne"] = run(lambda: tsne.tsne_embedding(X_embed, method="landmark", mesh=mesh))
    digest.update(placed.tobytes())
    if rank == 0:
        np.save(os.path.join(folder, "pca.npy"), embedded)
        np.save(os.path.join(folder, "tsne.npy"), placed)
    return records, digest.hexdigest()


@contextlib.contextmanager
def _dtype_policy(policy):
    """``LO_DTYPE_POLICY`` set to ``policy`` (None: left as it is) for the
    block, the policy's read-once cache emptied on the way in and out."""
    from learningorchestra_tpu_torch.utils import dtypepolicy

    if policy is None:
        yield
        return
    before = os.environ.get("LO_DTYPE_POLICY")
    os.environ["LO_DTYPE_POLICY"] = policy
    dtypepolicy._POLICY.clear()
    try:
        yield
    finally:
        if before is None:
            os.environ.pop("LO_DTYPE_POLICY", None)
        else:
            os.environ["LO_DTYPE_POLICY"] = before
        dtypepolicy._POLICY.clear()


def _lr_slots_alone(sweep, payload: dict, result: dict, mesh) -> dict:
    """Each real lr slot of this rank's block run alone at the rank's
    local padded width (the slot repeated across it): its W, b,
    accuracy and weighted F1 bit-identical to the sweep over the ranks
    (the coalescer's bar)."""
    from learningorchestra_tpu_torch.parallel.mesh import data_size
    from learningorchestra_tpu_torch.utils.shapegrid import padded_indices

    chunk = [(0, point) for point in range(len(payload["grid"]))]
    padded = sweep._job_axis(len(chunk), mesh)
    slots = [chunk[i] for i in padded_indices(len(chunk), padded)]
    local = padded // data_size(mesh)
    began = time.perf_counter()
    checked = 0
    for offset, slot in enumerate(sweep._rank_block(slots, mesh)):
        if mesh.data_index * local + offset >= len(chunk):
            continue   # a dummy slot
        point = slot[1]
        w, b, accuracy, f1 = (array[0] for array in sweep._lr_slots([payload], [slot] * local, mesh.device))
        params, at = result["params"][point], result["points"][point]
        if not (np.array_equal(w, params["w"]) and np.array_equal(b, params["b"])
                and float(accuracy) == at["accuracy"] and float(f1) == at["weighted_f1"]):
            raise AssertionError(f"sweep over ranks: lr slot {point} differs from its run alone at width {local}")
        checked += 1
    return {"slots": checked, "width": local, "wall_s": time.perf_counter() - began}


def _sweeps_over_ranks(torch, mesh, rank: int, folder: str) -> tuple:
    """The sweep phase's λ and depth sweeps over the data ranks of
    ``mesh`` (``group_runner(mesh=...)``, every rank the same member),
    each with the counts set to 0 just before it; then each lr slot of
    this rank's block alone. Rank 0 saves the outcomes. Returns the
    records and a digest of the outcomes' bits."""
    import hashlib
    import pickle

    from learningorchestra_tpu_torch.ml import sweep
    from learningorchestra_tpu_torch.parallel import multihost

    began = time.perf_counter()
    members = sweep_members(mesh=mesh)
    records = {"prepare_s": time.perf_counter() - began}
    digest = hashlib.sha256()
    for kind in ("lr", "dt"):
        torch.cuda.synchronize()
        kernels.reset_launches()
        multihost.reset_collective_stats()
        began = time.perf_counter()
        result = _outcome(sweep.group_runner(mesh=mesh)([members[kind]]))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - began
        launches = {name: count for name, count in kernels.launches().items() if count}
        collectives = multihost.collective_stats()
        bits = hashlib.sha256(json.dumps([result["points"], result["best"]]).encode())
        for params in result["params"]:
            for key in sorted(params):
                if isinstance(params[key], np.ndarray):
                    bits.update(np.ascontiguousarray(params[key]).tobytes())
        digest.update(bits.digest())
        records[kind] = {"wall_s": wall_s, "launches": launches, "collectives": collectives["collectives"],
                         "collective_s": collectives["collective_s"], "best": result["best"],
                         "digest": bits.hexdigest()}
        if kind == "lr":
            records[kind]["alone"] = _lr_slots_alone(sweep, members[kind], result, mesh)
        if rank == 0:
            with open(os.path.join(folder, f"sweep_{kind}.pkl"), "wb") as handle:
                pickle.dump(result, handle)
    return records, digest.hexdigest()


def multigpu_child(argv) -> int:
    """One rank of a ``multigpu`` run: ``chip_smoke.py multigpu-child
    <rank> <world> <backend> <address> <device> <folder> <spmd> [<model>
    <fits> <sweeps>]``. Joins the group, builds a mesh of ``world / model`` data
    ranks by ``model`` model ranks, feeds its block of bench.py's 1,000,000
    rows (``host_row_range``, ``shard_rows_local``), runs ``fit_sharded``
    with the counts set to 0 just before it, and the fits named in
    ``<fits>`` (``ten``: on ``ten_classes``; ``bf16``: under
    ``LO_DTYPE_POLICY=bf16``, the block in bfloat16); then (``spmd`` 1)
    the SPMD ``fit`` of the full rows; then the other fits (over a model
    axis: rf and nb alone); then (``sweeps`` 1) the sweeps over the data
    ranks; checks over the group that every rank holds the same bits;
    writes its record to ``<folder>/rank<rank>.json`` (rank 0 also the
    predictions and losses as .npy)."""
    import hashlib

    import torch
    import torch.distributed as dist

    from learningorchestra_tpu_torch.parallel import host_row_range, make_mesh, shard_rows_local
    from learningorchestra_tpu_torch.parallel import multihost

    rank, world, backend, address, device, folder, spmd = argv[:7]
    rank, world, device, spmd = int(rank), int(world), torch.device(device), spmd == "1"
    model_axis = int(argv[7]) if len(argv) > 7 else 1
    extra = argv[8].split(",") if len(argv) > 8 and argv[8] else []
    sweeps = len(argv) > 9 and argv[9] == "1"
    fits = ["fit_sharded"] + [f"fit_sharded_{name}" for name in extra]
    os.environ.update(LO_COORDINATOR=address, LO_NUM_PROCESSES=str(world), LO_PROCESS_ID=str(rank))
    for name in kernels.SOURCES:   # built by the parent
        kernels.library(name)
    started = time.perf_counter()
    multihost.initialize_from_env(backend=backend, device=device, timeout_s=MULTIGPU_GROUP_TIMEOUT_S)
    # a gloo that takes no CUDA tensor: every collective through the host
    staging_reason = multihost.stage_if_refused(device)
    mesh = make_mesh(data=world // model_axis, model=model_axis, device=device)
    join_s = time.perf_counter() - started
    X, y = bench_synthetic(FIT_ROWS)
    start, stop = host_row_range(FIT_ROWS, mesh)
    X_block, mask = shard_rows_local(X[start:stop], mesh, FIT_ROWS, dtype=np.float32)
    y_block, _ = shard_rows_local(y[start:stop], mesh, FIT_ROWS, dtype=np.int32)
    torch.cuda.synchronize()
    record = {"rank": rank, "world": world, "backend": backend, "device": str(device),
              "mesh": [mesh.shape["data"], mesh.shape["model"]],
              "coordinates": [mesh.data_index, mesh.model_index],
              "host_rows": [start, stop], "block_rows": int(X_block.shape[0]),
              "join_s": join_s, "host_staging": staging_reason is not None,
              "staging_reason": staging_reason}

    def fitted(fit):
        estimator = logistic.LogisticRegression(mesh=mesh)
        kernels.reset_launches()
        multihost.reset_collective_stats()
        began = time.perf_counter()
        model = fit(estimator)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - began
        launches = {name: count for name, count in kernels.launches().items() if count}
        collectives = multihost.collective_stats()
        labels, probs = model.predict_both(X)
        losses = estimator.loss_history_.cpu().numpy()
        params = b"".join(getattr(model, name).cpu().numpy().tobytes()
                          for name in ("w", "b", "mean", "scale"))
        return model, labels, losses, {
            "wall_s": wall_s, "launches": launches,
            **{field: collectives[field] for field in COLLECTIVE_FIELDS},
            "iterations": int(losses.shape[0]), "final_loss": float(losses[-1]),
            "accuracy": float((labels == fit_labels).mean()),
            "digest": hashlib.sha256(params + losses.tobytes() + labels.astype(np.int8).tobytes()
                                     + probs.tobytes()).hexdigest(),
        }

    digests = []
    for fit in fits:
        fit_labels = ten_classes(X) if fit == "fit_sharded_ten" else y
        labels_block = y_block if fit != "fit_sharded_ten" else shard_rows_local(
            fit_labels[start:stop], mesh, FIT_ROWS, dtype=np.int32)[0]
        rows_block = X_block.to(torch.bfloat16) if fit == "fit_sharded_bf16" else X_block
        with _dtype_policy("bf16" if fit == "fit_sharded_bf16" else None):
            _, labels, losses, record[fit] = fitted(
                lambda estimator: estimator.fit_sharded(rows_block, labels_block, mask,
                                                        num_classes=LR_FITS[fit]))
        digests.append(record[fit]["digest"])
        if rank == 0:
            np.save(os.path.join(folder, f"{fit}_labels.npy"), labels.astype(np.int8))
            np.save(os.path.join(folder, f"{fit}_losses.npy"), losses)
    fit_labels = y
    if spmd:
        _, spmd_labels, spmd_losses, record["fit"] = fitted(lambda estimator: estimator.fit(X, y))
        digests.append(record["fit"]["digest"])
        if rank == 0:
            np.save(os.path.join(folder, "fit_labels.npy"), spmd_labels.astype(np.int8))
            np.save(os.path.join(folder, "fit_losses.npy"), spmd_losses)
    record["others"], others_digest = _other_fits_over_ranks(
        torch, mesh, X, y, rank, folder, *((GRID_FITS, False) if model_axis > 1 else ()))
    digests.append(others_digest)
    if sweeps:
        record["sweeps"], sweeps_digest = _sweeps_over_ranks(torch, mesh, rank, folder)
        digests.append(sweeps_digest)
    # every rank's digests over the group (NCCL also for one rank): the same bits
    mine = torch.tensor(np.frombuffer(bytes.fromhex("".join(digests)), np.uint8).copy())
    mine = mine.to(device) if backend == "nccl" else mine   # gloo: the host's copy
    every = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(every, mine)
    record["ranks_bit_equal"] = all(torch.equal(other, mine) for other in every)
    with open(os.path.join(folder, f"rank{rank}.json"), "w") as handle:
        json.dump(record, handle)
    dist.destroy_process_group()
    return 0 if record["ranks_bit_equal"] else 1


def _multigpu_run(torch, run: str, backend: str, world: int, cards: int, spmd: bool, folder: str,
                  model: int = 1, fits: str = "", sweeps: bool = False) -> dict:
    """One run of ``world`` child ranks over ``cards`` cards (rank r on card
    r mod cards), all started together, as a mesh of ``world / model`` data
    ranks by ``model`` model ranks, with the extra lr ``fits`` (and
    ``sweeps``: the sweeps over the data ranks); fails when a child
    fails."""
    folder = os.path.join(folder, run)
    os.makedirs(folder)

    def start() -> float:
        # the rendezvous port is named to every rank before rank 0 binds it
        address = f"127.0.0.1:{_free_port()}"
        children = [
            _LoggedChild(
                MULTIGPU_CHILD_COMMAND + [
                    str(rank), str(world), backend, address, f"cuda:{rank % cards}", folder,
                    "1" if spmd else "0", str(model), fits, "1" if sweeps else "0",
                ],
                dict(os.environ), os.path.join(folder, f"rank{rank}.log"),
            )
            for rank in range(world)
        ]
        started = time.perf_counter()
        try:
            for rank, child in enumerate(children):
                remaining = max(1.0, MULTIGPU_CHILD_TIMEOUT_S - (time.perf_counter() - started))
                try:
                    code = child.process.wait(timeout=remaining)
                except subprocess.TimeoutExpired:
                    code = None
                if code != 0:
                    if rank == 0 and code is not None and _port_taken(child.lines()):
                        raise _PortTaken(f"multigpu run {run}: the rendezvous port of {address} was taken")
                    raise AssertionError(
                        f"multigpu run {run}: rank {rank} exited {code}:\n" + "\n".join(child.lines()[-40:]))
        finally:
            for child in children:
                child.stop()
        return time.perf_counter() - started

    wall_s = _on_new_ports(start, f"multigpu run {run}")
    records = []
    for rank in range(world):
        with open(os.path.join(folder, f"rank{rank}.json")) as handle:
            records.append(json.load(handle))
    if not all(record["ranks_bit_equal"] for record in records) or len(
            {record["fit_sharded"]["digest"] for record in records}) != 1:
        raise AssertionError(f"multigpu run {run}: the ranks' W, b, scaler, losses or labels differ")
    arrays = {name[:-4]: np.load(os.path.join(folder, name)) for name in os.listdir(folder)
              if name.endswith(".npy")}   # the other fits' .npz below
    summary = {
        "phase": "multigpu-run", "run": run, "backend": backend, "ranks": world, "cards": cards,
        "ranks_per_card": world // cards, "mesh": records[0]["mesh"],
        "coordinates": [record["coordinates"] for record in records],
        "transport": ("NCCL, one rank a card" if backend == "nccl" and world > 1 else
                      "NCCL, one rank" if backend == "nccl" else
                      f"gloo, {world // cards} ranks sharing a card, collectives through the host"),
        "host_staging": any(record["host_staging"] for record in records),
        "staging_reason": records[0]["staging_reason"],
        "children_wall_s": wall_s,
        "join_s": [record["join_s"] for record in records],
        "block_rows": [record["block_rows"] for record in records],
    }
    for fit in (*LR_FITS, "fit"):
        if fit in records[0]:
            if len({record[fit]["digest"] for record in records}) != 1:
                raise AssertionError(f"multigpu run {run} ({fit}): the ranks' bits differ")
            summary[fit] = {
                field: [record[fit][field] for record in records]
                for field in ("wall_s", "launches") + COLLECTIVE_FIELDS
            }
            summary[fit].update({field: records[0][fit][field]
                                 for field in ("iterations", "final_loss", "accuracy")})
    summary["others"] = {
        name: {
            **{field: [record["others"][name][field] for record in records]
               for field in ("wall_s", "launches") + COLLECTIVE_FIELDS},
            **{field: records[0]["others"][name][field] for field in ("accuracy", "weighted_f1", "evaluate")
               if field in records[0]["others"][name]},
        }
        for name in records[0]["others"]
    }
    for name in records[0]["others"]:
        if name in OTHER_FITS:
            with np.load(os.path.join(folder, f"{name}.npz")) as saved:
                arrays[name] = dict(saved)
    if "sweeps" in records[0]:
        import pickle

        summary["sweeps"] = {"prepare_s": [record["sweeps"]["prepare_s"] for record in records]}
        for kind in ("lr", "dt"):
            if len({record["sweeps"][kind]["digest"] for record in records}) != 1:
                raise AssertionError(f"multigpu run {run}: the ranks' {kind} sweep outcomes differ")
            summary["sweeps"][kind] = {
                field: [record["sweeps"][kind][field] for record in records]
                for field in ("wall_s", "launches", "collectives", "collective_s")
                + (("alone",) if kind == "lr" else ())
            }
            summary["sweeps"][kind]["best"] = records[0]["sweeps"][kind]["best"]
            with open(os.path.join(folder, f"sweep_{kind}.pkl"), "rb") as handle:
                arrays[f"sweep_{kind}"] = pickle.load(handle)
    return {"summary": summary, "arrays": arrays}


def _agreement(what: str, labels, losses, want_labels, want_losses) -> dict:
    """Predictions and loss histories against another fit's."""
    agreement = float((labels == want_labels).mean())
    if not agreement >= MULTIGPU_MIN_AGREEMENT:
        raise AssertionError(f"{what}: predictions agree on {agreement}")
    if losses.shape != want_losses.shape:
        raise AssertionError(f"{what}: {losses.shape[0]} iterations against {want_losses.shape[0]}")
    loss_rel = float(np.max(np.abs(losses - want_losses) / np.abs(want_losses)))
    if not loss_rel <= MULTIGPU_LOSS_RTOL:
        raise AssertionError(f"{what}: losses {loss_rel} relative")
    return {"agreement": agreement, "loss_max_rel": loss_rel}


def _host_descend(X: np.ndarray, features: np.ndarray, thresholds: np.ndarray, levels: int) -> np.ndarray:
    """Each row's node after ``levels`` levels of one tree's heap (as
    ``trees._descend``: ``x <= t`` left, NaN right, feature -1 left)."""
    node = np.zeros(X.shape[0], np.int64)
    rows = np.arange(X.shape[0])
    for level in range(levels):
        position = 2**level - 1 + node
        feature = features[position]
        x = X[rows, np.maximum(feature, 0)]
        node = node * 2 + (~(x <= thresholds[position]) & (feature >= 0))
    return node


def _gb_split_difference(want: dict, got: dict, X: np.ndarray, y: np.ndarray) -> "dict | None":
    """The first node (round, heap index) where two gb fits' splits differ,
    and each split's Newton gain on the one-process fit's rows at that node
    (float64, from its margins before that round): None when the heaps are
    identical."""
    differ = np.argwhere((want["features_heap"] != got["features_heap"])
                         | (want["thresholds_heap"] != got["thresholds_heap"]))
    if not len(differ):
        return None
    tree, node = (int(v) for v in differ[0])
    margins = np.full(X.shape[0], want["f0"], np.float32)
    for earlier in range(tree):
        leaf = _host_descend(X, want["features_heap"][earlier], want["thresholds_heap"][earlier], DEPTH)
        margins = margins + np.float32(STEP) * want["leaf_values"][earlier][leaf]
    p = 1.0 / (1.0 + np.exp(-margins.astype(np.float64)))
    g, h = p - y, np.maximum(p * (1 - p), 1e-6)
    level = int(np.log2(node + 1))
    at = _host_descend(X, want["features_heap"][tree], want["thresholds_heap"][tree], level) == node - (2**level - 1)

    def split(fit):
        feature, threshold = int(fit["features_heap"][tree, node]), float(fit["thresholds_heap"][tree, node])
        gain = None
        if feature >= 0:
            left = X[at, feature] <= threshold
            G, H = g[at], h[at]
            gain = float(G[left].sum() ** 2 / (H[left].sum() + 1) + G[~left].sum() ** 2 / (H[~left].sum() + 1)
                         - G.sum() ** 2 / (H.sum() + 1))
        return {"feature": feature, "threshold": threshold, "gain": gain}

    return {"round": tree, "node": node, "rows": int(at.sum()),
            "one_process": split(want), "over_ranks": split(got)}


def _one_process_others(torch) -> dict:
    """The one-process fits of dt, rf, gb and nb on bench.py's rows (their
    ``evaluate_predict``), PCA and the landmark t-SNE of the embed blobs, on
    the card: what the runs over ranks are held against."""
    X, y = bench_synthetic(FIT_ROWS)
    X_dev = torch.from_numpy(X).cuda()
    estimators = {"dt": trees.DecisionTreeClassifier, "rf": trees.RandomForestClassifier,
                  "gb": trees.GBTClassifier, "nb": naive_bayes.NaiveBayes}
    out = {}
    for name in OTHER_FITS:
        began = time.perf_counter()
        model = estimators[name]().fit(X, y)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - began
        accuracy, weighted_f1, _, probs = model.evaluate_predict(X, y, X)
        arrays = _fit_arrays(torch, name, model, X_dev)
        arrays["probs"] = probs
        out[name] = {"arrays": arrays, "accuracy": accuracy, "weighted_f1": weighted_f1, "wall_s": wall_s}
    X_embed, labels = embed_blobs(EMBED_ROWS)
    for name, embed in (("pca", lambda: pca.pca_embedding(X_embed)),
                        ("tsne", lambda: tsne.tsne_embedding(X_embed, method="landmark"))):
        began = time.perf_counter()
        out[name] = {"embedding": embed(), "wall_s": time.perf_counter() - began}
    out.update(X=X, y=y, X_embed=X_embed, labels=labels)
    return out


def _others_against_one_process(torch, run: str, arrays: dict, solo: dict) -> dict:
    """A run's other fits against the one-process ones: dt and rf heaps
    identical; gb's margins within MULTIGPU_GB_MARGIN_TOL and accuracy
    within FIT_MARGIN_TOL, whether its heaps are identical reported (the
    first split that differs, and both gains); nb's probabilities within
    MULTIGPU_NB_TOL; PCA within MULTIGPU_PCA_RTOL of the largest coordinate
    (each component's sign matched); t-SNE's KL(P || Q) on the landmarks
    within KL_MARGIN and its kNN agreement no worse than QUALITY_MARGIN
    below the one-process fit's."""
    out = {}
    for name in ("dt", "rf"):
        for field in ("features_heap", "thresholds_heap", "leaf_probs"):
            if not np.array_equal(arrays[name][field], solo[name]["arrays"][field]):
                raise AssertionError(f"multigpu run {run}: {name}'s {field} differs from the one-process fit's")
        out[name] = {"heaps_identical": True}
    got, want = arrays["gb"], solo["gb"]["arrays"]
    margin_err = float(np.abs(got["margins"] - want["margins"]).max())
    accuracy_diff = abs(float((np.argmax(got["probs"], axis=1) == solo["y"]).mean())
                        - float((np.argmax(want["probs"], axis=1) == solo["y"]).mean()))
    if not margin_err <= MULTIGPU_GB_MARGIN_TOL or not accuracy_diff <= FIT_MARGIN_TOL:
        raise AssertionError(f"multigpu run {run}: gb margins {margin_err}, accuracy {accuracy_diff} apart")
    difference = _gb_split_difference(want, got, solo["X"], solo["y"])
    out["gb"] = {"margin_max_abs_err": margin_err, "accuracy_diff": accuracy_diff,
                 "gb_heaps_identical": difference is None, "first_difference": difference,
                 "leaf_values_max_abs_err": float(np.abs(got["leaf_values"] - want["leaf_values"]).max())}
    nb_err = float(np.abs(arrays["nb"]["probs"] - solo["nb"]["arrays"]["probs"]).max())
    if not nb_err <= MULTIGPU_NB_TOL:
        raise AssertionError(f"multigpu run {run}: nb probabilities {nb_err} apart")
    out["nb"] = {"probs_max_abs_err": nb_err}
    got_pca, want_pca = arrays["pca"], solo["pca"]["embedding"]
    signs = np.sign((got_pca * want_pca).sum(axis=0))
    pca_err = float(np.abs(got_pca * signs - want_pca).max() / np.abs(want_pca).max())
    if not pca_err <= MULTIGPU_PCA_RTOL:
        raise AssertionError(f"multigpu run {run}: PCA {pca_err} of the largest coordinate apart")
    out["pca"] = {"max_rel_err": pca_err, "one_process_wall_s": solo["pca"]["wall_s"]}
    chosen = tsne._choose_landmarks(EMBED_ROWS, tsne.LANDMARKS, 0)
    L = torch.from_numpy(solo["X_embed"][chosen]).cuda()
    kl = _kl_held(torch, L, tsne.PERPLEXITY, arrays["tsne"][chosen], solo["tsne"]["embedding"][chosen],
                  f"multigpu run {run}: t-SNE's landmark fit")
    knn = {"over_ranks": knn_agreement(arrays["tsne"], solo["labels"], QUALITY_SAMPLE),
           "one_process": knn_agreement(solo["tsne"]["embedding"], solo["labels"], QUALITY_SAMPLE)}
    if not knn["over_ranks"] >= knn["one_process"] - QUALITY_MARGIN:
        raise AssertionError(f"multigpu run {run}: t-SNE's kNN agreement {knn}")
    out["tsne"] = {"kl": kl, "knn_agreement": knn, "one_process_wall_s": solo["tsne"]["wall_s"]}
    return out


SWEEP_PARAMS_TOL = 1e-4   # lr's W and b over ranks against one process, of their largest entry


def _sweeps_against_one_process(torch, run: str, arrays: dict) -> dict:
    """The sweeps over the ranks against the same sweeps in this process
    on the card at full width: dt bit-equal (heaps, leaf probabilities,
    metrics); lr the same ``best`` and accuracies, weighted F1 within
    1e-6, W and b within SWEEP_PARAMS_TOL of their largest entry (the
    bar of ``tests/test_torch_sweep.py``; a job axis of another width
    sums in another order)."""
    from learningorchestra_tpu_torch.ml import sweep

    device = _card(torch)
    began = time.perf_counter()
    members = sweep_members(device=device)
    out = {"prepare_s": time.perf_counter() - began}
    for kind in ("lr", "dt"):
        began = time.perf_counter()
        want = _outcome(sweep.run_group([members[kind]], device))
        torch.cuda.synchronize()
        got = arrays[f"sweep_{kind}"]
        out[kind] = {"one_process_wall_s": time.perf_counter() - began}
        if got["best"] != want["best"] or [p["accuracy"] for p in got["points"]] != [
                p["accuracy"] for p in want["points"]]:
            raise AssertionError(f"multigpu run {run}: the {kind} sweep's best or accuracies differ from "
                                 "one process's")
        if kind == "dt":
            for params, want_params in zip(got["params"], want["params"]):
                for field in ("features_heap", "thresholds_heap", "leaf_probs"):
                    if not np.array_equal(params[field], want_params[field]):
                        raise AssertionError(f"multigpu run {run}: the dt sweep's {field} differs")
            if got["points"] != want["points"]:
                raise AssertionError(f"multigpu run {run}: the dt sweep's metrics differ")
            out[kind]["bit_equal"] = True
            continue
        f1_err = max(abs(p["weighted_f1"] - q["weighted_f1"]) for p, q in zip(got["points"], want["points"]))
        errors = {
            field: max(float(np.abs(params[field] - want_params[field]).max())
                       / max(float(np.abs(want_params[field]).max()), 1e-30)
                       for params, want_params in zip(got["params"], want["params"]))
            for field in ("w", "b")
        }
        if not f1_err <= 1e-6 or not max(errors.values()) <= SWEEP_PARAMS_TOL:
            raise AssertionError(f"multigpu run {run}: the lr sweep's F1 {f1_err} and params {errors} apart")
        out[kind].update(f1_max_abs_err=f1_err, params_max_rel_err=errors,
                         bit_equal=all(np.array_equal(params[field], want_params[field])
                                       for params, want_params in zip(got["params"], want["params"])
                                       for field in ("w", "b")))
    return out


def _grid_against_one_process(run: str, arrays: dict, solo: dict) -> dict:
    """Run d's rf and nb against the one-process fits: rf's heaps (grown
    ten trees a model rank, gathered in model-rank order) identical, nb's
    probabilities within MULTIGPU_NB_TOL."""
    for field in ("features_heap", "thresholds_heap", "leaf_probs"):
        if not np.array_equal(arrays["rf"][field], solo["rf"]["arrays"][field]):
            raise AssertionError(f"multigpu run {run}: rf's {field} differs from the one-process fit's")
    nb_err = float(np.abs(arrays["nb"]["probs"] - solo["nb"]["arrays"]["probs"]).max())
    if not nb_err <= MULTIGPU_NB_TOL:
        raise AssertionError(f"multigpu run {run}: nb probabilities {nb_err} apart")
    return {"rf": {"heaps_identical": True}, "nb": {"probs_max_abs_err": nb_err}}


# --------------------------------------------------------------------------
# Run (e): the SPMD stack, two runner ranks over gloo on card 0
# --------------------------------------------------------------------------

SPMD_RANKS = 2
SPMD_DEVICE = "cuda:0"
# the runner's multi-host mode on ranks that share card 0: gloo, asked for
# by the caller (two NCCL ranks cannot share a card)
SPMD_RUNNER_COMMAND = [
    sys.executable, "-c",
    f"from learningorchestra_tpu_torch.services.runner import main; main(device={SPMD_DEVICE!r}, backend='gloo')",
]
SPMD_BOOT_TIMEOUT_S = 300
SPMD_TIMEOUT_S = "20"            # LO_SPMD_TIMEOUT_S of the run: the drill's watchdog
SPMD_CID = "chip-smoke-spmd"
SPMD_DRILL_WAIT_S = 60           # the drill's request ends within this, or it hung
PRODUCT_FIELDS = [f"f{i}" for i in range(FEATURES)] + ["label"]
# fits whose sums over ranks add in another order than one process's: held
# as the multigpu runs hold them (labels MULTIGPU_MIN_AGREEMENT, accuracy
# FIT_MARGIN_TOL); the others' labels and accuracy equal
SPMD_REORDERED = ("lr", "gb")


class _SpmdRank(_LoggedChild):
    """One rank of the runner's multi-host mode (``SPMD_RUNNER_COMMAND``)."""

    def __init__(self, folder: str, rank: int, env: dict):
        self.rank = rank
        super().__init__(SPMD_RUNNER_COMMAND, {**env, "LO_PROCESS_ID": str(rank)},
                         os.path.join(folder, f"spmd_rank{rank}.log"))

    def jobs_done(self) -> list:
        """The jobs this worker ran: ``(op, {wall_s, launches, collectives})``
        from its ``spmd worker <rank>: job <op> done`` lines."""
        import ast
        import re

        done = []
        for line in self.lines():
            match = re.match(rf"spmd worker {self.rank}: job (\S+) done (.*)$", line)
            if match:
                done.append((ast.literal_eval(match.group(1)), json.loads(match.group(2))))
        return done


def _text_call(client, method: str, path: str, payload=None, timeout_s: float = 120) -> tuple:
    """``(status, body text)`` of one request (a route's 500 is text)."""
    request = urllib.request.Request(
        client.base + path, data=None if payload is None else json.dumps(payload).encode(), method=method,
        headers={"Content-Type": "application/json", **client.headers})
    try:
        with client.opener.open(request, timeout=timeout_s) as response:
            return response.status, response.read().decode()
    except urllib.error.HTTPError as error:
        return error.code, error.read().decode()


def _product_csvs(folder: str) -> dict:
    """The product collections' rows (``product_store``'s) as CSV files."""
    X, y = bench_synthetic(FIT_ROWS)
    rows = np.concatenate([X[:PRODUCT_ROWS].astype(np.float64), y[:PRODUCT_ROWS, None]], axis=1)
    paths = {}
    for name in ("bench_train", "bench_test"):
        paths[name] = os.path.join(folder, f"{name}.csv")
        np.savetxt(paths[name], rows, fmt=["%.9g"] * FEATURES + ["%d"], delimiter=",",
                   header=",".join(PRODUCT_FIELDS), comments="")
    return paths


def _spmd_required_launches(op: str) -> tuple:
    """The kernels rank 1 must launch in a job: a build's fits over the
    two ranks (the sums forms, K7's SPMD ``fit``) and their evaluates, a
    landmark t-SNE's slabs."""
    if op == "build_model":
        names = [kernel for fit in ("dt", "rf", "gb") for kernel in _required_launches(fit, SPMD_RANKS)]
        names += list(_lr_path("fit", [SPMD_RANKS, 1])) + sorted(set(EVALUATE_LAUNCHES.values()))
        return tuple(dict.fromkeys(names))
    if op == "tsne":
        return _required_launches("tsne", SPMD_RANKS)
    return ()


def _one_process_product_build(torch, paths: dict, folder: str) -> tuple:
    """The CSVs ingested and cast in this process, built on the card by
    ``build_model``: each classifier's labels and accuracy, and the wall."""
    from learningorchestra_tpu_torch.core.ingest import ingest_csv, write_ingest_metadata
    from learningorchestra_tpu_torch.ml.builder import build_model
    from learningorchestra_tpu_torch.ops.dtype import convert_field_types

    store = InMemoryStore()
    for name, path in paths.items():
        write_ingest_metadata(store, name, "file://" + path)
        ingest_csv(store, name, "file://" + path)
        convert_field_types(store, name, {field: "number" for field in PRODUCT_FIELDS})
    torch.cuda.synchronize()
    began = time.perf_counter()
    build_model(store, "bench_train", "bench_test", PRODUCT_PREPROCESSOR, list(MODEL_NAMES),
                device=_card(torch), models_dir=os.path.join(folder, "one_process_models"))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - began
    return {name: {"labels": _labels(store, f"bench_test_prediction_{name}"),
                   "accuracy": float(store.find_one(f"bench_test_prediction_{name}", {"_id": 0})["accuracy"])}
            for name in MODEL_NAMES}, wall_s


def _spmd_stack_run(torch, card: str, folder: str) -> dict:
    """Run (e): the runner's multi-host mode on card 0. A store server
    (port 0) and two ranks of ``services.runner.main(device="cuda:0",
    backend="gloo")`` (the rendezvous port picked first, started again on
    a new one if it was taken): rank 0 serves the seven services on
    OS-assigned ports, rank 1 runs the SPMD worker loop. Through rank 0's
    REST: the product CSVs ingested and cast, a sync build of the five
    classifiers, a batch prediction from the lr checkpoint, a PCA and a
    t-SNE image, each with its own correlation id. Held: every answer is
    the reference's; each prediction collection holds its rows and one
    metadata document; the labels and accuracy of the build equal the
    same build in this process on the card (lr and gb: as the multigpu
    runs hold fits whose sums add in another order); one PNG an image;
    rank 1's log names each job's op and correlation id and its
    launches hold each fit's kernels. The drill: rank 1 killed during a
    t-SNE request, which must end in an error within the watchdog
    (``LO_SPMD_TIMEOUT_S``), and the next build must answer the
    dispatcher's poisoned error at once."""
    from learningorchestra_tpu_torch.core.store_service import connect

    folder = os.path.join(folder, "e")
    os.makedirs(folder)
    walls: dict = {}
    started = time.perf_counter()
    store_server = _StoreServer(folder, "spmd_store")
    ranks: list = []
    remote = None
    try:
        store_server.wait_serving()
        walls["store server boot"] = time.perf_counter() - started
        env = {
            **os.environ, "LO_EPHEMERAL": "1", "LO_STORE_URL": store_server.url,
            "LO_MODELS_DIR": os.path.join(folder, "models"), "LO_IMAGES_DIR": os.path.join(folder, "images"),
            "LO_DATA_DIR": os.path.join(folder, "lo_data"), "LO_NUM_PROCESSES": str(SPMD_RANKS),
            "LO_SPMD_TIMEOUT_S": SPMD_TIMEOUT_S,
        }
        for name in ("LO_SERVICE", "LO_PORT", "LO_FAULT_BUILDER_PHASE", "LO_DTYPE_POLICY", "LO_BUILD_WORKERS"):
            env.pop(name, None)

        booted = time.perf_counter()
        ranks = _on_new_ports(lambda: _spmd_boot(folder, env), "run e: the rendezvous")
        walls["ranks boot"] = time.perf_counter() - booted
        coordinator, worker = ranks

        def client(service: str, what: str):
            return _Client(coordinator.ports[service], {"X-Correlation-Id": f"{SPMD_CID}-{what}"})

        paths = _product_csvs(folder)
        for name, path in paths.items():
            _ingest_over_rest(client("database_api", "ingest"), walls, name, path)
            _timed(walls, f"PATCH /fieldtypes {name}", client("data_type_handler", "cast"), "PATCH",
                   f"/fieldtypes/{name}", {field: "number" for field in PRODUCT_FIELDS}, expect=(200,))
        remote = connect(store_server.url)
        answer = _timed(walls, "POST /models (sync)", client("model_builder", "build"), "POST", "/models",
                        _build_body("bench_train", "bench_test", PRODUCT_PREPROCESSOR, False), expect=(201,))
        if answer != {"result": "created_file"}:
            raise AssertionError(f"run e: the build answered {answer}")
        answer = _timed(walls, "POST /models/<lr>/predictions", client("model_builder", "predict"), "POST",
                        "/models/bench_test_prediction_lr/predictions", {
                            "training_filename": "bench_train", "test_filename": "bench_test",
                            "preprocessor_code": PRODUCT_PREPROCESSOR, "prediction_filename": "spmd_batch_lr",
                        }, expect=(201,))
        if answer != {"result": "created_file"}:
            raise AssertionError(f"run e: the batch prediction answered {answer}")
        for method in ("pca", "tsne"):
            answer = _timed(walls, f"POST /images ({method})", client(method, method), "POST", "/images/bench_train",
                            {f"{method}_filename": f"spmd_{method}", "label_name": "label"}, expect=(201,))
            if answer != {"result": "created_file"}:
                raise AssertionError(f"run e: the {method} image answered {answer}")

        # the store holds each collection once, and the images once
        counts = {name: remote.count(f"bench_test_prediction_{name}") for name in MODEL_NAMES}
        counts["spmd_batch_lr"] = remote.count("spmd_batch_lr")
        if any(count != PRODUCT_ROWS + 1 for count in counts.values()):
            raise AssertionError(f"run e: the prediction collections hold {counts} documents")
        images = {method: sorted(os.listdir(os.path.join(folder, "images", method))) for method in ("pca", "tsne")}
        if images != {method: [f"spmd_{method}.png"] for method in ("pca", "tsne")}:
            raise AssertionError(f"run e: the images folder holds {images}")
        over_ranks = {name: {"labels": _labels(remote, f"bench_test_prediction_{name}"),
                             "accuracy": float(remote.find_one(f"bench_test_prediction_{name}", {"_id": 0})["accuracy"])}
                      for name in MODEL_NAMES}
        if not np.array_equal(_labels(remote, "spmd_batch_lr"), over_ranks["lr"]["labels"]):
            raise AssertionError("run e: the batch prediction's labels are not the build's")

        # rank 1: each job by op and correlation id, and its launches
        log = "\n".join(worker.lines())
        jobs = {"build_model": "build", "predict_model": "predict", "embedding_image": None}
        for op, what in jobs.items():
            cids = [what] if what else ["pca", "tsne"]
            for cid in cids:
                if f"[spmd worker 1] job {op!r} (cid {SPMD_CID}-{cid})" not in log:
                    raise AssertionError(f"run e: rank 1's log names no {op} of cid {SPMD_CID}-{cid}")
        done = worker.jobs_done()
        if [op for op, _ in done] != ["build_model", "predict_model", "embedding_image", "embedding_image"]:
            raise AssertionError(f"run e: rank 1 ran {[op for op, _ in done]}")
        worker_jobs = dict(zip(("build", "predict", "pca", "tsne"), (counts for _, counts in done)))
        for what, required in (("build", _spmd_required_launches("build_model")),
                               ("tsne", _spmd_required_launches("tsne"))):
            missing = [name for name in required if not worker_jobs[what]["launches"].get(name)]
            if missing:
                raise AssertionError(f"run e: rank 1's {what} job never launched {missing}")

        # the drill: rank 1 killed during a t-SNE request
        answer_box: dict = {}

        def drill_request():
            began = time.perf_counter()
            answer_box["status"], answer_box["body"] = _text_call(
                client("tsne", "drill"), "POST", "/images/bench_train",
                {"tsne_filename": "spmd_tsne_drill", "label_name": "label"}, timeout_s=SPMD_DRILL_WAIT_S)
            answer_box["wall_s"] = time.perf_counter() - began

        requester = threading.Thread(target=drill_request)
        requester.start()
        worker.wait_for(f"(cid {SPMD_CID}-drill)", 60, "run e: rank 1's drill job")
        time.sleep(0.5)   # inside the job's collectives
        killed_at = time.perf_counter()
        worker.process.kill()
        worker.process.wait(timeout=30)
        requester.join(timeout=SPMD_DRILL_WAIT_S + 10)
        if requester.is_alive() or "status" not in answer_box:
            raise AssertionError("run e: the drill's t-SNE request hung")
        walls["drill: kill to error"] = time.perf_counter() - killed_at
        if answer_box["status"] != 500 or walls["drill: kill to error"] > float(SPMD_TIMEOUT_S) + 5:
            raise AssertionError(f"run e: the drill's request answered {answer_box} "
                                 f"{walls['drill: kill to error']} s after the kill")
        began = time.perf_counter()
        status, body = _text_call(client("model_builder", "poisoned"), "POST", "/models",
                                  _build_body("bench_train", "bench_test", PRODUCT_PREPROCESSOR, False))
        walls["build after the drill"] = time.perf_counter() - began
        if status != 500 or "SpmdRuntimePoisonedError" not in body or walls["build after the drill"] > 5:
            raise AssertionError(f"run e: the build after the drill answered {status} {body!r}")
        metrics = {line for line in _metrics_text(_Client(coordinator.ports["model_builder"])).splitlines()
                   if line.startswith("lo_spmd_")}
        if not any(line.startswith("lo_spmd_poisoned ") and float(line.split()[1]) == 1.0 for line in metrics):
            raise AssertionError(f"run e: lo_spmd_poisoned is not 1 ({sorted(metrics)})")
    finally:
        if remote is not None:
            remote.close()
        for child in ranks:
            child.stop()
        store_server.stop()
    one_process, one_process_wall_s = _one_process_product_build(torch, paths, folder)
    held = {}
    for name in MODEL_NAMES:
        got, want = over_ranks[name], one_process[name]
        agreement = float((got["labels"] == want["labels"]).mean())
        accuracy_diff = abs(got["accuracy"] - want["accuracy"])
        exact = agreement == 1.0 and accuracy_diff == 0.0
        if name in SPMD_REORDERED:
            if not (agreement >= MULTIGPU_MIN_AGREEMENT and accuracy_diff <= FIT_MARGIN_TOL):
                raise AssertionError(f"run e: {name}'s labels agree on {agreement}, accuracy {accuracy_diff} apart")
        elif not exact:
            raise AssertionError(f"run e: {name}'s labels agree on {agreement}, accuracy {accuracy_diff} apart "
                                 "from one process's")
        held[name] = {"agreement": agreement, "accuracy_diff": accuracy_diff, "equal": exact}
    return {
        "phase": "multigpu-run", "run": "e", "backend": "gloo", "ranks": SPMD_RANKS, "cards": 1,
        "transport": "gloo, two runner ranks sharing card 0, the SPMD dispatcher over them",
        "walls_s": walls, "run_s": time.perf_counter() - started,
        "one_process_build_wall_s": one_process_wall_s, "against_one_process": held,
        "prediction_documents": counts, "images": images, "worker_jobs": worker_jobs,
        "drill": {"status": answer_box["status"], "error": answer_box["body"][:300],
                  "request_wall_s": answer_box["wall_s"], "poisoned_build": body[:300]},
        "lo_spmd": sorted(metrics),
    }


def _spmd_boot(folder: str, env: dict) -> list:
    """Both ranks of run (e) serving: rank 0's seven services (their
    ports read from its boot lines into ``ports``) and rank 1's worker
    loop; on a failure both are stopped. Every rank is told the
    rendezvous port before rank 0 binds it."""
    import re

    address = f"127.0.0.1:{_free_port()}"
    ranks = [_SpmdRank(folder, rank, {**env, "LO_COORDINATOR": address}) for rank in range(SPMD_RANKS)]
    try:
        lines = ranks[0].wait_for("serving all services", SPMD_BOOT_TIMEOUT_S, "run e: rank 0")
        ranks[1].wait_for("spmd worker: waiting for jobs", SPMD_BOOT_TIMEOUT_S, "run e: rank 1")
    except BaseException:
        for child in ranks:
            child.stop()
        raise
    ranks[0].ports = {}
    for line in lines:
        match = re.search(r"service (\w+) on [\d.]+:(\d+)", line)
        if match:
            ranks[0].ports[match.group(1)] = int(match.group(2))
    return ranks


def _lr_path(fit: str, mesh: list) -> tuple:
    """The kernels an lr fit must launch on every rank: K8′ and K7's sums
    form over the data axis, K8′ and K7's class-shard form where the model
    axis shards its classes; the SPMD ``fit`` K7's sums form alone."""
    if fit == "fit":
        return ("logistic_loss_grad_sums", "logistic_trial_losses_sums")
    scaler = ("masked_col_sums", "masked_col_sums_centred", "masked_standardize")
    model = mesh[1]
    if model > 1 and LR_FITS[fit] % model == 0:
        return scaler + tuple(SHARD_REPLACES)
    return tuple(MULTIGPU_REPLACES)


def _required_launches(name: str, world: int) -> tuple:
    """The kernels a rank of a ``world``-rank run must launch in fit or
    request ``name`` (its ``evaluate_predict`` apart): the sums forms and
    the slabs over several ranks, today's launches on one."""
    over = world > 1
    if name in ("dt", "rf"):
        return ("apply_bins", "level_histograms", "select_splits", "route", "leaf_sums")
    if name == "gb":
        return ("apply_bins", "select_splits", "route") + (
            ("level_histograms_sums", "leaf_sums_sums") if over else ("level_histograms", "leaf_sums"))
    if name == "tsne":
        return (("tsne_affinities_slab", "tsne_z_slab", "tsne_grad_slab") if over
                else ("tsne_affinities", "tsne_z", "tsne_grad")) + ("tsne_interpolate",)
    return ()


EVALUATE_LAUNCHES = {"dt": "tree_ensemble_forward", "rf": "tree_ensemble_forward", "gb": "gbt_forward"}


def phase_multigpu(torch, card: str) -> list:
    """K8′ (masked_col_sums in both passes, masked_standardize) and K7's sums
    form on the card against their twins, and the four new forms (K2's and
    K5's sums forms, K11's and K12's row slabs); then ``fit_sharded`` at
    1,000,000 × 16 through per-host feeding over (a) NCCL, one rank a card,
    with two cards or more, (b) one NCCL rank on card 0 and (c) four gloo
    ranks sharing card 0, and in each the SPMD fits of dt, rf, gb and nb
    with ``evaluate_predict`` over the ranks, PCA and a landmark t-SNE
    request at 1,000,000 rows; and (d) four gloo ranks on card 0 as data 2
    × model 2 (the model axis: lr's classes over a model group at 2 and 10
    classes and under ``LO_DTYPE_POLICY=bf16``, rf's trees, nb), after K7's
    class-shard form and K8′ on bfloat16 rows against their twins; run (b)
    also fits the ten classes and bf16. The ranks of a run hold the same
    bits; each run's lr predictions agree with run (b)'s and its losses
    match; run (c)'s SPMD ``fit`` agrees with the one-process ``fit``; runs
    (b) and (c) hold the other fits, PCA and t-SNE against the one-process
    ones, run (d) rf and nb. Run (c) then sweeps over its four data ranks
    (the sweep phase's λ and depth sweeps, ``group_runner(mesh=...)``):
    the ranks' outcomes identical, dt bit-equal to one process's, each lr
    slot bit-identical to its run alone at the rank's width, lr's best
    and accuracies one process's, every rank launching the job-axis
    kernels. Run (e) is the runner's multi-host mode: the SPMD stack on
    two gloo ranks of card 0 (``_spmd_stack_run``). Returns the kernels'
    summary entries (launches: rank 0 of run (b) for the lr path, of run
    (c) for the new forms, of run (d) for the model axis's kernels; each
    run's beside)."""
    started = time.perf_counter()
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    scaler_results, stats_timing = check_scaler_kernels(torch, flush)
    results = {**scaler_results, **check_k7_sums(torch, flush)}
    forms_started = time.perf_counter()
    forms = {**check_sum_forms(torch, flush), **check_slab_forms(torch, flush)}
    forms_s = time.perf_counter() - forms_started
    model_axis_started = time.perf_counter()
    shard_results, k7_sums_bf16 = check_k7_shards(torch, flush)
    shard_edges = check_shard_edges(torch)
    bf16_results, bf16_stats_timing = check_scaler_bf16(torch, flush)
    model_axis_checks_s = time.perf_counter() - model_axis_started
    del flush
    solo = _one_process_others(torch)
    X, y = bench_synthetic(FIT_ROWS)
    estimator = logistic.LogisticRegression()
    began = time.perf_counter()
    solo_labels = estimator.fit(X, y).predict(X)
    solo_wall_s = time.perf_counter() - began
    solo_losses = estimator.loss_history_.cpu().numpy()
    count = torch.cuda.device_count()
    # (run, backend, ranks, cards, SPMD fit, model axis, extra lr fits, sweeps)
    plan = [("b", "nccl", 1, 1, False, 1, "ten,bf16", False),
            ("c", "gloo", MULTIGPU_GLOO_RANKS, 1, True, 1, "", True),
            ("d", "gloo", GRID_DATA * GRID_MODEL, 1, False, GRID_MODEL, "ten,bf16", False)]
    if count >= 2:
        plan.insert(0, ("a", "nccl", count, count, False, 1, "", False))
    runs, run_s = {}, {}
    with tempfile.TemporaryDirectory(prefix="lo_multigpu_") as folder:
        for run, backend, world, cards, spmd, model, fits, sweeps in plan:
            began = time.perf_counter()
            runs[run] = _multigpu_run(torch, run, backend, world, cards, spmd, folder, model, fits, sweeps)
            run_s[run] = time.perf_counter() - began
        began = time.perf_counter()
        spmd_stack = _spmd_stack_run(torch, card, folder)
        run_s["e"] = time.perf_counter() - began
    base = runs["b"]["arrays"]
    for run, result in runs.items():
        arrays, summary = result["arrays"], result["summary"]
        summary["against_b"] = {
            fit: _agreement(f"multigpu run {run} ({fit}) against run b", arrays[f"{fit}_labels"],
                            arrays[f"{fit}_losses"], base[f"{fit}_labels"], base[f"{fit}_losses"])
            for fit in LR_FITS if f"{fit}_labels" in arrays
        }
        if "fit_labels" in arrays:
            summary["fit_against_one_process"] = {
                **_agreement(f"multigpu run {run}: the SPMD fit against the one-process fit",
                             arrays["fit_labels"], arrays["fit_losses"], solo_labels, solo_losses),
                "one_process_wall_s": solo_wall_s,
            }
        for fit in (*LR_FITS, "fit"):
            for rank, launches in enumerate(summary.get(fit, {}).get("launches", [])):
                missing = [name for name in _lr_path(fit, summary["mesh"]) if not launches.get(name)]
                if missing:
                    raise AssertionError(f"multigpu run {run} ({fit}), rank {rank}: {missing} never launched")
        for name, other in summary["others"].items():
            for rank, launches in enumerate(other["launches"]):
                missing = [kernel for kernel in _required_launches(name, summary["ranks"])
                           if not launches.get(kernel)]
                if missing:
                    raise AssertionError(f"multigpu run {run} ({name}), rank {rank}: {missing} never launched")
            if name in EVALUATE_LAUNCHES and not other["evaluate"]["launches"].get(EVALUATE_LAUNCHES[name]):
                raise AssertionError(f"multigpu run {run} ({name}): its evaluate launched no forward")
        if run in ("b", "c"):
            summary["others_against_one_process"] = _others_against_one_process(torch, run, arrays, solo)
        if run == "d":
            summary["others_against_one_process"] = _grid_against_one_process(run, arrays, solo)
        if "sweeps" in summary:
            for kind in ("lr", "dt"):
                for rank, launches in enumerate(summary["sweeps"][kind]["launches"]):
                    missing = [name for name in SWEEP_KERNELS[kind] if not launches.get(name)]
                    if missing:
                        raise AssertionError(f"multigpu run {run} ({kind} sweep), rank {rank}: {missing} never launched")
                MULTIGPU_SWEEP_LAUNCHES[kind] = summary["sweeps"][kind]["launches"]
            summary["sweeps_against_one_process"] = _sweeps_against_one_process(torch, run, arrays)
        summary["nvidia_smi"] = card
        summary["run_s"] = run_s[run]
        emit(summary)
    spmd_stack["nvidia_smi"] = card
    emit(spmd_stack)
    emit({"phase": "multigpu", "wall_s": time.perf_counter() - started, "forms_s": forms_s,
          "model_axis_checks_s": model_axis_checks_s, "run_s": run_s,
          "masked_stats": stats_timing, "masked_stats_bf16": bf16_stats_timing,
          "k7_sums_bf16": k7_sums_bf16, "shard_edges": shard_edges,
          "one_process": {name: {field: solo[name][field] for field in ("wall_s", "accuracy", "weighted_f1")
                                 if field in solo[name]} for name in (*OTHER_FITS, "pca", "tsne")},
          "kernels": {name: {key: value for key, value in result.items()}
                      for name, result in {**results, **forms, **shard_results, **bf16_results}.items()}})
    entries = []
    for name, result in results.items():
        entries.append({
            "name": name, "route": "cuda",
            "source": SCALER_SOURCE if name.startswith("masked") else LOGISTIC_SOURCE,
            "replaces": MULTIGPU_REPLACES[name],
            "launches": runs["b"]["summary"]["fit_sharded"]["launches"][0].get(name, 0),
            "launches_by_run": {run: runs[run]["summary"]["fit_sharded"]["launches"] for run in runs},
            "rows": result["rows"] if "rows" in result else SCALER_SHAPES[0][0],
            **{field: result[field] for field in (
                "max_abs_err", "ms", "warm_ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")},
            **({"device_ms_clean_l2": result["device_ms_clean_l2"]} if "device_ms_clean_l2" in result else {}),
            **({"library_note": MULTIGPU_LIBRARY[name]} if name in MULTIGPU_LIBRARY else {}),
            **{field: result[field] for field in ("by_shape", "by_classes") if field in result},
        })
    over_ranks = "c"   # the four gloo ranks: the main path of the new forms
    for name, result in forms.items():
        fit = "tsne" if name.startswith("tsne") else "gb"
        entries.append({
            "name": name, "route": "cuda", "source": FORMS_SOURCE[name], "replaces": FORMS_REPLACES[name],
            "launches": runs[over_ranks]["summary"]["others"][fit]["launches"][0].get(name, 0),
            "launches_by_run": {run: [launches.get(name, 0) for launches in runs[run]["summary"]["others"][fit]["launches"]]
                                for run in runs if fit in runs[run]["summary"]["others"]},
            **{field: result[field] for field in (
                "max_abs_err", "max_rel_err", "rows", "ms", "warm_ms", "device_ms", "device_ms_clean_l2",
                "plain_ms", "bound_ms", "bound_by", "library_ms")},
            "library_note": FORMS_LIBRARY[name],
            **{field: result[field] for field in ("by_shape", "by_rows", "bit_equal_to_the_whole_launch")
               if field in result},
        })
    grid = "d"   # the model axis's main path: data 2 x model 2
    fields = ("max_abs_err", "ms", "warm_ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for name, result in shard_results.items():
        entries.append({
            "name": name, "route": "cuda", "source": LOGISTIC_SOURCE, "replaces": SHARD_REPLACES[name],
            "launches": runs[grid]["summary"]["fit_sharded"]["launches"][0].get(name, 0),
            "launches_by_fit": {fit: runs[grid]["summary"][fit]["launches"][0].get(name, 0)
                                for fit in LR_FITS},
            "rows": result["rows"], "classes_a_shard": result["classes_a_shard"],
            **{field: result[field] for field in fields},
            "library_note": SHARD_LIBRARY[name], "by_shape": result["by_shape"],
        })
    for name, result in bf16_results.items():
        wrapper = BF16_WRAPPER[name]
        entries.append({
            "name": name, "route": "cuda", "source": SCALER_SOURCE, "replaces": BF16_REPLACES[name],
            "launches": runs[grid]["summary"]["fit_sharded_bf16"]["launches"][0].get(wrapper, 0),
            "launches_by_run": {run: runs[run]["summary"]["fit_sharded_bf16"]["launches"][0].get(wrapper, 0)
                                for run in runs if "fit_sharded_bf16" in runs[run]["summary"]},
            "rows": result["rows"], **{field: result[field] for field in fields},
            "library_note": BF16_LIBRARY_NOTE[name], "by_shape": result["by_shape"],
        })
    for entry in entries[-len(shard_results) - len(bf16_results):]:
        if not entry["launches"]:
            raise AssertionError(f"multigpu run {grid}: {entry['name']} was never launched on its main path")
    return entries


# --------------------------------------------------------------------------
# One process per service: the seven runners over a store server, and the
# observability plane
# --------------------------------------------------------------------------

SERVICE_NAMES = ("database_api", "projection", "model_builder", "data_type_handler", "histogram", "tsne", "pca")
SERVICE_COMMAND = [sys.executable, "-m", "learningorchestra_tpu_torch.services.runner"]
SERVICES_CHILD_DEVICE = "cuda:0"   # what every child's boot line must name
SERVICES_DEVICE = None             # the in-process twin's device: the card
SERVICES_BOOT_TIMEOUT_S = 300
SERVICES_CID = "chip-smoke-services"
SERVICES_METRICS_INTERVAL_S = "1"
SERVICES_PROFILE_S = 2             # the window sampled during a build
ML_MODULES = ("builder", "base", "trees", "binning", "logistic", "naive_bayes", "evaluation", "progress")


def _build_libraries() -> list:
    """The kernel libraries the build's kernels live in: a process that
    builds loads each once (one ``lo_compile_events_total`` event each)."""
    return sorted({kernels.KERNEL_LIBRARIES[name] for name in BUILD_KERNELS if name in kernels.KERNEL_LIBRARIES})


class _ServiceChild(_LoggedChild):
    """One runner serving one service (``LO_SERVICE``) over the store
    server, on the port picked for it."""

    def __init__(self, folder: str, name: str, port: int, env: dict):
        self.name, self.port = name, port
        self.spawned = time.perf_counter()
        super().__init__(SERVICE_COMMAND, {**env, "LO_SERVICE": name, "LO_PORT": str(port)},
                         os.path.join(folder, f"{name}.log"))

    def serving(self) -> bool:
        """Whether the ``service <name> on`` line is out; raises when the
        child died first or its boot lines name another device."""
        lines = self.lines()
        if not any(f"service {self.name} on 127.0.0.1:{self.port}" in line for line in lines):
            if self.process.poll() is not None:
                if _port_taken(lines):
                    raise _PortTaken(f"service {self.name}: its port {self.port} was taken")
                raise AssertionError(f"service {self.name} never served:\n" + "\n".join(lines[-40:]))
            return False
        if not any(f"device={SERVICES_CHILD_DEVICE}" in line for line in lines):
            raise AssertionError(f"{self.name} did not boot on {SERVICES_CHILD_DEVICE}:\n" + "\n".join(lines))
        return True


def _boot_seconds(children: list) -> dict:
    """Each child's seconds from its spawn to its ``service <name> on``
    line, all of them watched together."""
    boot_s: dict = {}
    deadline = time.time() + SERVICES_BOOT_TIMEOUT_S
    while len(boot_s) < len(children):
        for child in children:
            if child.name not in boot_s and child.serving():
                boot_s[child.name] = time.perf_counter() - child.spawned
        if time.time() > deadline:
            raise AssertionError(f"services: only {sorted(boot_s)} served within {SERVICES_BOOT_TIMEOUT_S} s")
        time.sleep(0.02)
    return boot_s


def _metrics_text(client) -> str:
    with client.opener.open(client.base + "/metrics", timeout=60) as response:
        return response.read().decode()


def _labelled_total(text: str, name: str, label: str) -> float:
    """The sum of ``name``'s samples whose labels hold ``label``."""
    return sum(
        float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
        if line.startswith(name + "{") and label in line
    )


def _flows(text: str) -> dict:
    return {
        "h2d": _metric_total(text, "lo_h2d_bytes_total"),
        "d2h": _metric_total(text, "lo_d2h_bytes_total"),
        "wire_read": _labelled_total(text, "lo_wire_bytes_total", 'direction="read"'),
        # a labelled family shows no sample before its first event
        "compile_events": _labelled_total(text, "lo_compile_events_total", 'source="'),
        "compile_hits": _labelled_total(text, "lo_compile_events_total", 'result="hit"'),
    }


def _served_launches(before: str, after: str) -> dict:
    """Each build kernel's ``lo_kernel_launches_total`` samples added
    between two ``/metrics`` texts of one process: the launches its own
    requests made (a family that is not there yet counts 0)."""
    def samples(text):
        return {
            name: _labelled_total(text, "lo_kernel_launches_total", f'kernel="{name}"') for name in BUILD_KERNELS
        }

    earlier, later = samples(before), samples(after)
    return {name: int(later[name] - earlier[name]) for name in BUILD_KERNELS}


def _held_bitwise(what: str, outputs: dict, twin: dict) -> dict:
    """Two builds that ran the same kernels on the same inputs: every
    label, probability and metric equal bit for bit."""
    for name in MODEL_NAMES:
        for field in ("labels", "probability", "metrics"):
            got, want = outputs[name][field], twin[name][field]
            if got.shape != want.shape or got.tobytes() != want.tobytes():
                differing = int((got != want).sum()) if got.shape == want.shape else got.shape
                raise AssertionError(f"{what} {name}: {field} differs from the twin's ({differing})")
    return {name: "bit-equal" for name in MODEL_NAMES}


def _profiled(client, seconds: float, work):
    """``work()`` under a ``GET /debug/profile?seconds=<seconds>&format=json``
    started just before it on another thread; ``(work's result, the
    profile's status and body)``."""
    answer = {}

    def sample():
        answer["status"], answer["body"] = client.call("GET", f"/debug/profile?seconds={seconds}&format=json")

    sampler = threading.Thread(target=sample)
    sampler.start()
    time.sleep(0.05)   # the window opens before the work starts
    try:
        result = work()
    finally:
        sampler.join()
    return result, answer["status"], answer["body"]


def _services_titanic(clients: dict, walls: dict) -> None:
    """The documented walkthrough over HTTP, each step on its service's
    process: ingest, projection, field types, a histogram."""
    files = clients["database_api"]
    for name in ("titanic_train", "titanic_test"):
        _ingest_over_rest(files, walls, name, os.path.join(ROOT, "tests", "data", f"{name}.csv"))
        fields = [field for field in TITANIC_FIELDS if name == "titanic_train" or field != "Survived"]
        _timed(walls, f"POST /projections {name}", clients["projection"], "POST", f"/projections/{name}",
               {"projection_filename": f"{name}_projection", "fields": fields}, expect=(201,))
        types = {**TITANIC_TYPES, **({"Survived": "number"} if name == "titanic_train" else {})}
        _timed(walls, f"PATCH /fieldtypes {name}", clients["data_type_handler"], "PATCH",
               f"/fieldtypes/{name}_projection", types, expect=(200,))
    _timed(walls, "POST /histograms", clients["histogram"], "POST", "/histograms/titanic_train_projection",
           {"histogram_filename": "titanic_histogram", "fields": ["Sex", "Pclass"]}, expect=(201,))
    status, page = files.call("GET", "/files/titanic_histogram?skip=0&limit=2&query={}")
    counts = [doc for doc in page.get("result", []) if "Sex" in doc]
    if status != 200 or not counts or sum(entry["count"] for entry in counts[0]["Sex"]) != 891:
        raise AssertionError(f"services: the Sex histogram answered {status} {page}")


def _pca_png(client, output: str) -> bytes:
    _timed({}, "pca", client, "POST", "/images/bench_train",
           {"pca_filename": output, "label_name": "label"}, expect=(201,))
    with client.opener.open(client.base + f"/images/{output}", timeout=60) as response:
        return response.read()


def phase_services(torch, card: str) -> dict:
    """The reference's deployment on the card: a store server and seven
    runners, one a service (``LO_SERVICE``, ``LO_PORT``), each on the
    card (its boot line names ``cuda:0``), their collectors ticking every
    second and ``LO_PLANE_MEMBERS`` naming all seven. Over HTTP, under
    one ``X-Correlation-Id``: the Titanic walkthrough, the product
    collections (written by this script), an async five-classifier build
    on model_builder's process and a PCA image on pca's. Held: the
    build's labels, probabilities and metrics and the PCA image bit for
    bit against an in-process twin on the card over the same store;
    K1-K7 and K6 launched by model_builder's process over the build (its
    ``lo_kernel_launches_total`` delta, the phase's ``launches``) and by
    the twin (``twin_launches``); model_builder's ``/metrics`` (a
    compile event a kernel library, the host-to-device bytes the twin's ``h2d_bytes()`` counts,
    the device-to-host bytes the twin's flight recorder counts, wire
    reads); the build's Chrome trace (its h2d total, a ``phase:fit`` a
    classifier) and summary; one stitched trace with a process row for
    every service called; a sampled profile during a build whose stacks
    pass through the port's ``ml/``; ``/metrics/history`` with a series
    a service; every SLO rule ok and ``/health`` not degraded. Printed:
    each child's boot seconds, the build's wall beside the twin's, and
    the build's wall with and without a profile window over it."""
    from learningorchestra_tpu_torch.core import devcache
    from learningorchestra_tpu_torch.core.store_service import connect
    from learningorchestra_tpu_torch.ml import base
    from learningorchestra_tpu_torch.services import images
    from learningorchestra_tpu_torch.telemetry import profile

    started = time.perf_counter()
    walls: dict = {}
    headers = {"X-Correlation-Id": SERVICES_CID}
    with tempfile.TemporaryDirectory() as folder:
        store_server = _StoreServer(folder, "services_store")
        children: list = []
        try:
            store_server.wait_serving()
            walls["store server boot"] = time.perf_counter() - started
            env = {
                **os.environ, "LO_STORE_URL": store_server.url,
                "LO_METRICS_INTERVAL_S": SERVICES_METRICS_INTERVAL_S,
                "LO_MODELS_DIR": os.path.join(folder, "models"), "LO_IMAGES_DIR": os.path.join(folder, "images"),
                "LO_DATA_DIR": os.path.join(folder, "lo_data"),
            }
            for name in ("LO_SERVICE", "LO_PORT", "LO_FAULT_BUILDER_PHASE", "LO_DTYPE_POLICY", "LO_TSDB_COLLECT"):
                env.pop(name, None)

            def boot():
                # LO_PLANE_MEMBERS names every runner's port before it binds
                ports = {name: _free_port() for name in SERVICE_NAMES}
                members = ",".join(f"http://127.0.0.1:{port}" for port in ports.values())
                children[:] = [_ServiceChild(folder, name, ports[name], {**env, "LO_PLANE_MEMBERS": members})
                               for name in SERVICE_NAMES]
                try:
                    return ports, _boot_seconds(children)
                except _PortTaken:
                    for child in children:
                        child.stop()
                    raise

            ports, boot_s = _on_new_ports(boot, "services: the seven runners")
            clients = {name: _Client(port, headers) for name, port in ports.items()}
            remote = connect(store_server.url)

            _services_titanic(clients, walls)
            product_started = time.perf_counter()
            product_store(remote)
            walls["product collections"] = time.perf_counter() - product_started
            builder = clients["model_builder"]
            before_text = _metrics_text(builder)
            build_wall_s = _store_build(builder, remote, "bench_test", True)["wall_s"]
            warmups = BENCH_WARMUPS
            _settled_jobs(builder, warmups)   # the build's publish-time warmups end first
            after_text = _metrics_text(builder)
            before, after = _flows(before_text), _flows(after_text)
            launches = _served_launches(before_text, after_text)
            served = _stored_outputs(remote, "bench_test")
            png = _pca_png(clients["pca"], "pca_bench")

            # the twin: the same build and PCA in this process, on the card
            devcache.reset_global_devcache()
            twin_server = ServerThread(create_app(
                remote, models_dir=os.path.join(folder, "twin_models"), device=SERVICES_DEVICE)).start()
            twin_images = ServerThread(images.create_app(
                remote, os.path.join(folder, "twin_images"), "pca", device=SERVICES_DEVICE)).start()
            try:
                torch.cuda.synchronize()
                kernels.reset_launches()
                copied, flows = base.h2d_bytes(), profile.flow_totals()
                twin_wall_s = _store_build(_Client(twin_server.port), remote, "bench_test", True)["wall_s"]
                _settled_jobs(_Client(twin_server.port), warmups)
                torch.cuda.synchronize()
                twin_h2d = base.h2d_bytes() - copied
                twin_d2h = profile.flow_totals()["d2h_bytes"] - flows["d2h_bytes"]
                twin_launches = kernels.launches()
                twin_png = _pca_png(_Client(twin_images.port), "pca_bench")
            finally:
                twin_server.stop()
                twin_images.stop()
            for whose, counts in (("model_builder's", launches), ("the twin's", twin_launches)):
                missing = [name for name in BUILD_KERNELS if counts[name] == 0]
                if missing:
                    raise AssertionError(f"services: {whose} build never launched {missing}")
            held = _held_bitwise("services", served, _stored_outputs(remote, "bench_test"))
            if png != twin_png:
                raise AssertionError("services: pca's image differs from the in-process PCA's")
            delta = {key: after[key] - before[key] for key in after}
            libraries = _build_libraries()
            if after["compile_events"] < len(libraries):
                raise AssertionError(f"services: {after['compile_events']} compile events for {libraries}")
            if delta["h2d"] != twin_h2d or delta["d2h"] != twin_d2h or not delta["wire_read"]:
                raise AssertionError(
                    f"services: model_builder's flows {delta}, the twin's h2d {twin_h2d} and d2h {twin_d2h}")

            job = f"build:bench_test:{'+'.join(MODEL_NAMES)}"
            with builder.opener.open(builder.base + f"/jobs/{job}/profile", timeout=60) as response:
                chrome = json.loads(response.read())
            events = [event for event in chrome["traceEvents"] if event["ph"] == "X"]
            fits = [event for event in events if event["name"] == "phase:fit"]
            traced_h2d = chrome["otherData"]["bytes_total"]["h2d_bytes"]
            for warmup in warmups:   # the warmups' forwards copy their rows too
                with builder.opener.open(builder.base + f"/jobs/{warmup}/profile", timeout=60) as response:
                    traced_h2d += json.loads(response.read())["otherData"]["bytes_total"]["h2d_bytes"]
            if traced_h2d != delta["h2d"] or len(fits) != len(MODEL_NAMES):
                raise AssertionError(
                    f"services: the build's and its warmups' traces moved {traced_h2d} h2d bytes "
                    f"(counted {delta['h2d']}) with {len(fits)} fits")
            status, summary = builder.call("GET", f"/jobs/{job}/profile?format=summary")
            if status != 200 or set(summary["result"]["phases"]) != {event["name"] for event in events}:
                raise AssertionError(f"services: the build's summary answered {status} {summary}")

            status, stitched = clients["database_api"].call("GET", f"/traces/{SERVICES_CID}")
            called = {"database_api", "projection", "data_type_handler", "histogram", "model_builder", "pca"}
            rows = {proc.split("@", 1)[0] for proc in stitched.get("otherData", {}).get("processes", {}).values()}
            if status != 200 or not called <= rows:
                raise AssertionError(f"services: the stitched trace has rows {sorted(rows)} ({status})")

            _copy_product_test(remote, remote, "bench_test_profiled")
            _, status, sampled = _profiled(
                builder, SERVICES_PROFILE_S, lambda: _store_build(builder, remote, "bench_test_profiled", True))
            stacks = sampled.get("result", {}).get("stacks", {}) if status == 200 else {}
            through_ml = [
                stack for stack in stacks
                if any(frame.split(".", 1)[0] in ML_MODULES for frame in stack.split(";")[1:])
            ]
            if status != 200 or not sampled["result"]["samples"] or not through_ml:
                raise AssertionError(f"services: /debug/profile answered {status}, no stack through ml/")

            # the build's wall with a profile window over it (three times
            # the first wall: the window covers the build) and without,
            # in the order without, with, with, without
            overhead = {"without": [], "with": []}
            window_s = None
            for profiled in (False, True, True, False):
                if profiled:
                    window_s = window_s or round(max(1.0, 3 * overhead["without"][0]), 3)
                    build, status, _ = _profiled(
                        builder, window_s, lambda: _store_build(builder, remote, "bench_test", False))
                    if status != 200:
                        raise AssertionError(f"services: the overhead window answered {status}")
                else:
                    build = _store_build(builder, remote, "bench_test", False)
                overhead["with" if profiled else "without"].append(build["wall_s"])

            time.sleep(2 * float(SERVICES_METRICS_INTERVAL_S))   # a tick of every collector after the builds
            status, history = clients["database_api"].call("GET", "/metrics/history?family=lo_http_requests_total")
            series = history.get("result", {}).get("series", {}) if status == 200 else {}
            if not set(SERVICE_NAMES) <= {name for name, points in series.items() if points}:
                raise AssertionError(f"services: /metrics/history has series {sorted(series)} ({status})")
            status, slo_state = clients["database_api"].call("GET", "/debug/slo")
            status_health, health = clients["model_builder"].call("GET", "/health")
            if status != 200 or slo_state["result"]["burning"] or status_health != 200 or health["degraded"]:
                raise AssertionError(f"services: SLO {slo_state}, health {health}")
            remote.close()
        finally:
            for child in children:
                child.stop()
            store_server.stop()
    record = {
        "phase": "services",
        "rows": {"train": PRODUCT_ROWS, "test": PRODUCT_ROWS},
        "boot_s": boot_s,
        "walls_s": walls,
        "build_wall_s": {"seven_processes": build_wall_s, "in_process_twin": twin_wall_s},
        "profiler_overhead_build_wall_s": {**overhead, "window_s": window_s},
        "flows": {"model_builder": delta, "twin": {"h2d": twin_h2d, "d2h": twin_d2h}},
        "compile_events": {"all": after["compile_events"], "hits": after["compile_hits"]},
        "libraries": libraries,
        "held_to_twin": held,
        "stitched_rows": sorted(rows),
        "profile_samples": sampled["result"]["samples"],
        "launches": launches,
        "twin_launches": {name: twin_launches[name] for name in BUILD_KERNELS},
        "phase_s": time.perf_counter() - started,
        "nvidia_smi": card,
    }
    emit(record)
    return record


FLEET_COMMAND = [sys.executable, "-m", "learningorchestra_tpu_torch.services.runner"]
FLEET_CHILD_DEVICE = "cuda:0"    # what every replica's boot line must name
FLEET_BOOT_TIMEOUT_S = 300
FLEET_DOWN_S = 2.0                # LO_FLEET_DOWN_S: the drill's down window
FLEET_VIEW_TTL_S = 0.5            # serve/fleet.DEFAULT_VIEW_TTL_S: the router's view
FLEET_CLIENTS = 16
FLEET_REQUESTS = 20               # a client's requests in each closed loop
FLEET_ROWS = (1, 64)
FLEET_DRILL_MODEL = "dt"          # its primary is the replica the drill kills
FLEET_DRILL_REQUESTS = 60
FLEET_KILL_AFTER = 100            # answers before the kill -9
FORWARD_KERNELS = ("tree_ensemble_forward", "gbt_forward")


class _FleetChild(_LoggedChild):
    """One runner of the fleet (a replica's model_builder, or the router)
    on the card, its port picked for it."""

    def __init__(self, folder: str, label: str, service: str, env: dict):
        self.label, self.service, self.port = label, service, None
        self.spawned = time.perf_counter()
        super().__init__(FLEET_COMMAND, {**env, "LO_SERVICE": service, "LO_PORT": "0"},
                         os.path.join(folder, f"{label}.log"))

    def serving(self) -> bool:
        """Whether the child serves (a replica: its agent started too),
        its port read from its boot line; raises when it died first or
        booted on another device."""
        import re

        lines = self.lines()
        marks = [f"service {self.service} on 127.0.0.1:"]
        if self.service == "model_builder":
            marks.append(f"fleet replica {self.label[-1]}: agent started")
        if not all(any(mark in line for line in lines) for mark in marks):
            if self.process.poll() is not None:
                raise AssertionError(f"fleet: {self.label} never served:\n" + "\n".join(lines[-40:]))
            return False
        if not any(f"device={FLEET_CHILD_DEVICE}" in line for line in lines):
            raise AssertionError(f"fleet: {self.label} did not boot on {FLEET_CHILD_DEVICE}:\n" + "\n".join(lines))
        if not any(line.startswith("fleet config: ") for line in lines):
            raise AssertionError(f"fleet: {self.label} stated no fleet config:\n" + "\n".join(lines))
        for line in lines:
            match = re.search(rf"service {self.service} on 127\.0\.0\.1:(\d+)", line)
            if match:
                self.port = int(match.group(1))
        return True

    def kill9(self) -> None:
        import signal

        os.kill(self.process.pid, signal.SIGKILL)
        self.process.wait(timeout=30)


def _fleet_boot_seconds(children: list) -> dict:
    """Each child's seconds from its spawn to serving, watched together."""
    boot_s: dict = {}
    deadline = time.time() + FLEET_BOOT_TIMEOUT_S
    while len(boot_s) < len(children):
        for child in children:
            if child.label not in boot_s and child.serving():
                boot_s[child.label] = time.perf_counter() - child.spawned
        if time.time() > deadline:
            raise AssertionError(f"fleet: only {sorted(boot_s)} served within {FLEET_BOOT_TIMEOUT_S} s")
        time.sleep(0.02)
    return boot_s


def _fleet_picture(router, model: str) -> dict:
    status, answer = router.call("GET", f"/models/{model}")
    if status != 200:
        raise AssertionError(f"fleet: GET /models/{model} on the router answered {status} {answer}")
    return answer["result"]["fleet"]


def _fleet_held(router, names, timeout_s: float) -> float:
    """Seconds until both replicas' heartbeats list every model of
    ``names``."""
    started = time.perf_counter()
    while True:
        replicas = _fleet_picture(router, names[0])["replicas"]
        if len(replicas) == 2 and all(set(names) <= set(row["models"]) for row in replicas.values()):
            return time.perf_counter() - started
        if time.perf_counter() - started > timeout_s:
            raise AssertionError(f"fleet: the replicas never held {names}: {replicas}")
        time.sleep(0.1)


def _forward_launches(text: str) -> dict:
    return {
        name: int(_labelled_total(text, "lo_kernel_launches_total", f'kernel="{name}"')) for name in FORWARD_KERNELS
    }


def _jit_compiles(text: str) -> float:
    return _labelled_total(text, "lo_compile_events_total", 'source="jit"')


def _registry_misses(client) -> int:
    status, answer = client.call("GET", "/models")
    if status != 200:
        raise AssertionError(f"fleet: GET /models answered {status} {answer}")
    return int(answer["serving"]["registry"]["misses"])


def _settled_jobs(client, names, timeout_s: float = 120) -> dict:
    """Each job's record once it is terminal."""
    deadline = time.time() + timeout_s
    records: dict = {}
    while len(records) < len(names):
        for name in names:
            if name in records:
                continue
            status, answer = client.call("GET", f"/jobs/{name}")
            if status == 200 and answer["result"]["state"] in ("finished", "failed", "cancelled"):
                records[name] = answer["result"]
        if time.time() > deadline:
            raise AssertionError(f"fleet: jobs {sorted(set(names) - set(records))} never ended")
        time.sleep(0.05)
    return records


def _sse_wait(port: int, job: str) -> bytes:
    """``GET /jobs/<job>/wait`` as an event stream: the bytes after the
    head once the server closes the stream."""
    import socket

    sock = socket.create_connection(("127.0.0.1", port), timeout=120)
    sock.settimeout(120)
    try:
        sock.sendall(
            f"GET /jobs/{job}/wait?timeout=60 HTTP/1.1\r\nHost: fleet\r\nAccept: text/event-stream\r\n\r\n".encode()
        )
        chunks = []
        while True:
            data = sock.recv(65536)
            if not data:
                break
            chunks.append(data)
    finally:
        sock.close()
    head, _, stream = b"".join(chunks).partition(b"\r\n\r\n")
    if b" 200 " not in head.split(b"\r\n", 1)[0] or b"text/event-stream" not in head:
        raise AssertionError(f"fleet: the event stream's head was {head!r}")
    return stream


def _fleet_load(target: str, name: str, rows: np.ndarray, expected: np.ndarray, tolerance: float,
                clients: int, requests: int) -> dict:
    """A closed loop of ``clients`` x ``requests`` predicts of ``name`` at
    ``target``, every answer checked against the plain CPU forward."""
    from learningorchestra_tpu_torch.serve.loadgen import http_predict_sender, run_closed_loop

    answers: list = []
    send, factory = http_predict_sender(
        [target], name, rows.tolist(), timeout_s=60,
        on_response=lambda status, body: answers.append((status, body)),
    )
    stats = run_closed_loop(send, clients, requests, len(rows), session_factory=factory)
    for status, body in answers:
        _check_answer(name, status, body, rows, expected, tolerance)
        if body["result"]["model"] != name:
            raise AssertionError(f"fleet: a predict of {name} answered for {body['result']['model']}")
    stats["answers_checked"] = len(answers)
    return stats


def _router_retries(router, model: str) -> float:
    return _labelled_total(_metrics_text(router), "lo_router_retries_total", f'model="{model}"')


def phase_fleet(torch, card: str) -> dict:
    """Serving at scale on the card: a store server, two model_builder
    replicas (``LO_FLEET_REPLICA`` 0 and 1 of ``LO_FLEET_REPLICAS=2``,
    ``LO_FLEET_RF=2``, ``LO_FLEET_DOWN_S=2``, one shared models
    directory) and the router (``LO_SERVICE=router``), each its own
    process, all on the event loop. The serve phase's five checkpoints at
    full width sit in the models directory; both replicas' heartbeats
    must list them. The Titanic build, sync on replica 0, must be
    followed by a ``warmup:<file>`` job a checkpoint on replica 0 that
    ends finished, K6 launches by the tree warmups that started after the
    build answered, and first predicts of each built model (routed, then
    straight at replica 0) that add no ``source="jit"`` compile event and
    no registry miss on replica 0; an async build's ``/wait`` read as an
    event stream must end in a ``done`` frame. Then closed loops of
    ``FLEET_CLIENTS`` x ``FLEET_REQUESTS`` predicts at 1 and 64 rows for
    each model, through the router and straight at replica 0, every
    answer held to the plain CPU forward; both replicas' K6 launches must
    rise. The drill: kill -9 the primary owner of ``FLEET_DRILL_MODEL``
    while a loop of its predicts runs through the router; every answer
    must be a 200 for that model, ``lo_router_retries_total`` must rise,
    and once the down window and a view TTL have passed the router's
    picture must show the dead replica unhealthy and the survivor
    healthy, and a further loop must add no retry."""
    from learningorchestra_tpu_torch.core.store_service import connect
    from learningorchestra_tpu_torch.utils.webloop import SSE_PREAMBLE

    started = time.perf_counter()
    walls: dict = {}
    rng = np.random.default_rng(21)
    with tempfile.TemporaryDirectory() as folder:
        models_dir = os.path.join(folder, "models")
        os.makedirs(models_dir)
        tolerances, cpu_models = {}, {}
        for name, gathered in synthetic_checkpoints(seed=0).items():
            write_checkpoint(gathered, checkpoint_path(models_dir, name))
            tolerances[name] = TREE_TOL if gathered[0] in ("tree_ensemble", "gbt") else LINEAR_TOL
            cpu_models[name] = load_model(checkpoint_path(models_dir, name), device="cpu")
        names = sorted(tolerances)
        store_server = _StoreServer(folder, "fleet_store")
        children: list = []
        remote = None
        try:
            store_server.wait_serving()
            boot_s = {"store": time.perf_counter() - started}
            env = {
                **os.environ, "LO_STORE_URL": store_server.url, "LO_MODELS_DIR": models_dir,
                "LO_DATA_DIR": os.path.join(folder, "lo_data"), "LO_IMAGES_DIR": os.path.join(folder, "images"),
                "LO_FLEET_REPLICAS": "2", "LO_FLEET_RF": "2", "LO_FLEET_DOWN_S": str(FLEET_DOWN_S),
            }
            for knob in ("LO_SERVICE", "LO_PORT", "LO_FLEET_REPLICA", "LO_FLEET_MODEL_QPS", "LO_WEB_ASYNC",
                         "LO_FAULT_BUILDER_PHASE", "LO_DTYPE_POLICY"):
                env.pop(knob, None)
            # each binds port 0 and names its port in its boot line
            children = [
                _FleetChild(folder, "replica0", "model_builder", {**env, "LO_FLEET_REPLICA": "0"}),
                _FleetChild(folder, "replica1", "model_builder", {**env, "LO_FLEET_REPLICA": "1"}),
                _FleetChild(folder, "router", "router", env),
            ]
            boot_s.update(_fleet_boot_seconds(children))
            ports = {child.label: child.port for child in children}
            replica0, replica1, router = (_Client(ports[label]) for label in ("replica0", "replica1", "router"))
            walls["heartbeats list the five"] = _fleet_held(router, names, 120)

            # warmup: the Titanic build on replica 0 publishes five checkpoints
            remote = connect(store_server.url)
            titanic_store(folder, remote)
            built = [f"titanic_test_prediction_{name}" for name in MODEL_NAMES]
            before_build = _metrics_text(replica0)
            walls_started = time.perf_counter()
            status, answer = replica0.call(
                "POST", "/models", _build_body("titanic_train", "titanic_test", documented_preprocessor(), False))
            if (status, answer) != (201, {"result": "created_file"}):
                raise AssertionError(f"fleet: the Titanic build answered {status} {answer}")
            at_answer = _metrics_text(replica0)
            read_at = time.time()
            walls["titanic build (sync)"] = time.perf_counter() - walls_started
            warm_jobs = _settled_jobs(replica0, [f"warmup:{name}.model" for name in built])
            settled = _metrics_text(replica0)
            failed = {name: record["state"] for name, record in warm_jobs.items() if record["state"] != "finished"}
            if failed:
                raise AssertionError(f"fleet: warmups ended {failed}")
            tree_warmups_after = sum(
                1 for name, record in warm_jobs.items()
                if name.rsplit("_", 1)[-1].split(".")[0] in ("dt", "rf", "gb") and record["started_at"] > read_at
            )
            k6 = {"before_build": _forward_launches(before_build), "at_answer": _forward_launches(at_answer),
                  "after_warmups": _forward_launches(settled)}
            by_warmups = sum(k6["after_warmups"].values()) - sum(k6["at_answer"].values())
            if by_warmups < tree_warmups_after or sum(k6["after_warmups"].values()) <= sum(
                    k6["before_build"].values()):
                raise AssertionError(f"fleet: K6 launches {k6} with {tree_warmups_after} tree warmups after the answer")
            titanic_lr = load_model(checkpoint_path(models_dir, "titanic_test_prediction_lr"), device="cpu")
            titanic_width = int(titanic_lr.w.shape[0])
            first_predicts = {}
            for name in built:
                cpu_model = load_model(checkpoint_path(models_dir, name), device="cpu")
                row = np.abs(rng.normal(size=(1, titanic_width))).astype(np.float32)
                tolerance = LINEAR_TOL if name.endswith(("_lr", "_nb")) else TREE_TOL
                jit, misses = _jit_compiles(_metrics_text(replica0)), _registry_misses(replica0)
                for client in (router, replica0):
                    status, body = client.call("POST", f"/models/{name}/predict", {"rows": row.tolist()})
                    _check_answer(name, status, body, row, cpu_model.predict_proba(row), tolerance)
                added = {"jit_compiles": _jit_compiles(_metrics_text(replica0)) - jit,
                         "registry_misses": _registry_misses(replica0) - misses}
                if any(added.values()):
                    raise AssertionError(f"fleet: the first predicts of {name} added {added} on replica 0")
                first_predicts[name] = added

            # the async build's /wait as an event stream
            job = f"build:titanic_test:{'+'.join(MODEL_NAMES)}"
            status, answer = replica0.call(
                "POST", "/models", _build_body("titanic_train", "titanic_test", documented_preprocessor(), True))
            if (status, answer) != (201, {"result": "created_file", "job": job}):
                raise AssertionError(f"fleet: the async build answered {status} {answer}")
            while True:
                stream = _sse_wait(ports["replica0"], job)
                if not stream.startswith(SSE_PREAMBLE):
                    raise AssertionError(f"fleet: the event stream began {stream[:40]!r}")
                if b"event: timeout\n" not in stream:
                    break
            frame = json.loads(stream.split(b"data: ", 1)[1].split(b"\n", 1)[0])
            if b"event: done\n" not in stream or frame["result"]["state"] != "finished":
                raise AssertionError(f"fleet: the event stream ended {stream!r}")

            # load through the router and straight at replica 0
            rows = {count: bench_rows(rng, count) for count in FLEET_ROWS}
            expected = {(name, count): cpu_models[name].predict_proba(rows[count])
                        for name in names for count in FLEET_ROWS}
            launches_before = {label: _forward_launches(_metrics_text(client))
                               for label, client in (("replica0", replica0), ("replica1", replica1))}
            load: dict = {}
            for label, port in (("router", ports["router"]), ("replica0", ports["replica0"])):
                for count in FLEET_ROWS:
                    for name in names:
                        load[f"{label}:{name}:{count}"] = _fleet_load(
                            f"127.0.0.1:{port}", name, rows[count], expected[(name, count)], tolerances[name],
                            FLEET_CLIENTS, FLEET_REQUESTS)
            launches = {}
            for label, client in (("replica0", replica0), ("replica1", replica1)):
                after = _forward_launches(_metrics_text(client))
                launches[label] = {kernel: after[kernel] - launches_before[label][kernel] for kernel in FORWARD_KERNELS}
                if not sum(launches[label].values()):   # K6: either entry point
                    raise AssertionError(f"fleet: {label}'s K6 launches under load were {launches[label]}")
            summary = {}
            for label in ("router", "replica0"):
                for count in FLEET_ROWS:
                    loops = [load[f"{label}:{name}:{count}"] for name in names]
                    summary[f"{label}:{count}"] = {
                        "p50_ms": statistics.median(loop["p50_ms"] for loop in loops),
                        "p99_ms": max(loop["p99_ms"] for loop in loops),
                        "requests_per_s": statistics.median(loop["requests_per_s"] for loop in loops),
                    }

            # the drill: kill -9 the drill model's primary while its load runs
            owners = _fleet_picture(router, FLEET_DRILL_MODEL)["owners"]
            dead, alive = owners[0], owners[1]
            victim = children[dead]
            drill_rows = rows[1]
            retries = {"before": _router_retries(router, FLEET_DRILL_MODEL)}
            answers: list = []
            outcome: dict = {}

            def drive():
                from learningorchestra_tpu_torch.serve.loadgen import http_predict_sender, run_closed_loop

                send, factory = http_predict_sender(
                    [f"127.0.0.1:{ports['router']}"], FLEET_DRILL_MODEL, drill_rows.tolist(), timeout_s=60,
                    on_response=lambda status, body: answers.append((status, body)))
                latencies = outcome["latencies_s"] = []

                def timed(index, session):
                    started = time.perf_counter()
                    send(index, session)
                    latencies.append(time.perf_counter() - started)

                try:
                    outcome["stats"] = run_closed_loop(
                        timed, FLEET_CLIENTS, FLEET_DRILL_REQUESTS, 1, session_factory=factory)
                except BaseException as error:  # noqa: BLE001 — raised below
                    outcome["error"] = error

            load_thread = threading.Thread(target=drive)
            load_thread.start()
            deadline = time.time() + 120
            while len(answers) < FLEET_KILL_AFTER and load_thread.is_alive() and time.time() < deadline:
                time.sleep(0.005)
            killed_after = len(answers)
            killed_at = time.perf_counter()
            victim.kill9()
            walls["kill -9 to reaped"] = time.perf_counter() - killed_at
            load_thread.join(timeout=300)
            if load_thread.is_alive() or "error" in outcome:
                raise AssertionError(f"fleet: the drill's load failed: {outcome.get('error')}")
            expected_drill = cpu_models[FLEET_DRILL_MODEL].predict_proba(drill_rows)
            for status, body in answers:
                _check_answer(FLEET_DRILL_MODEL, status, body, drill_rows, expected_drill,
                              tolerances[FLEET_DRILL_MODEL])
                if body["result"]["model"] != FLEET_DRILL_MODEL:
                    raise AssertionError(f"fleet: the drill answered for {body['result']['model']}")
            if len(answers) != FLEET_CLIENTS * FLEET_DRILL_REQUESTS or killed_after >= len(answers):
                raise AssertionError(f"fleet: {len(answers)} answers, the kill after {killed_after}")
            retries["after_kill"] = _router_retries(router, FLEET_DRILL_MODEL)
            if retries["after_kill"] <= retries["before"]:
                raise AssertionError(f"fleet: no retry after the kill ({retries})")
            time.sleep(max(0.0, FLEET_DOWN_S + FLEET_VIEW_TTL_S + 0.5 - (time.perf_counter() - killed_at)))
            picture = _fleet_picture(router, FLEET_DRILL_MODEL)
            health = {index: row["healthy"] for index, row in picture["replicas"].items()}
            if health != {str(dead): False, str(alive): True}:
                raise AssertionError(f"fleet: after the down window the router's picture is {picture}")
            recovered = _fleet_load(f"127.0.0.1:{ports['router']}", FLEET_DRILL_MODEL, drill_rows, expected_drill,
                                    tolerances[FLEET_DRILL_MODEL], FLEET_CLIENTS, FLEET_REQUESTS // 5)
            retries["after_recovery"] = _router_retries(router, FLEET_DRILL_MODEL)
            if retries["after_recovery"] != retries["after_kill"]:
                raise AssertionError(f"fleet: retries went on after the down window ({retries})")
        finally:
            if remote is not None:
                remote.close()
            for child in children:
                child.stop()
            store_server.stop()
    record = {
        "phase": "fleet",
        "boot_s": boot_s,
        "walls_s": walls,
        "models": names,
        "warmup": {
            "jobs": {name: record["state"] for name, record in warm_jobs.items()},
            "k6_launches": k6,
            "tree_warmups_after_answer": tree_warmups_after,
            "first_predicts": first_predicts,
        },
        "sse_done_frame": True,
        "load": summary,
        "loops": load,
        "launches": launches,
        "drill": {
            "model": FLEET_DRILL_MODEL, "killed_replica": dead, "answers": len(answers),
            "killed_after_answers": killed_after, "retries": retries, "health": health,
            "stats": outcome["stats"], "recovered": recovered,
            "answers_over_1_s": sum(1 for latency in outcome["latencies_s"] if latency > 1.0),
        },
        "phase_s": time.perf_counter() - started,
        "nvidia_smi": card,
    }
    emit(record)
    return record


DEPLOY_STACK_COMMAND = [sys.executable, "-m", "learningorchestra_tpu_torch.deploy.stack"]
DEPLOY_CLUSTER_COMMAND = [sys.executable, "-m", "learningorchestra_tpu_torch.deploy.cluster", "up"]
DEPLOY_CHILD_DEVICE = "cuda:0"   # what every child's boot line must name
DEPLOY_DEVICE = None             # the in-process build's device: the card
DEPLOY_ENV: dict = {}            # more environment for every child (a CPU rehearsal's LO_DEVICE)
DEPLOY_JIT_CACHE = None          # the stack's and the head's LO_JIT_CACHE (None: kernels/_build)
DEPLOY_BOOT_TIMEOUT_S = 300
DEPLOY_RESTART_DELAY = "0.5"
DEPLOY_SPMD_TIMEOUT_S = "20"     # the cluster's LO_SPMD_TIMEOUT_S: a dead rank raises, never hangs
DEPLOY_PASS_TIMEOUT_S = 120      # the AOT passes end within this


class _GroupChild(_LoggedChild):
    """A supervisor (the stack, the cluster driver) as a child in a
    session of its own, run from ``cwd``: :meth:`stop` ends its whole
    process group, the children it started included."""

    def __init__(self, command: list, env: dict, log_path: str, cwd: str):
        env = {**env, "PYTHONPATH": ROOT + os.pathsep + env.get("PYTHONPATH", ""), "PYTHONUNBUFFERED": "1"}
        self.log_path = log_path
        self.log = open(log_path, "w")
        self.spawned = time.perf_counter()
        self.process = subprocess.Popen(command, env=env, stdout=self.log, stderr=subprocess.STDOUT, cwd=cwd,
                                        start_new_session=True)

    def stop(self) -> None:
        import signal

        for signum, wait_s in ((signal.SIGTERM, 60), (signal.SIGKILL, 15)):
            try:
                os.killpg(self.process.pid, signum)
            except ProcessLookupError:
                break
            try:
                self.process.wait(timeout=wait_s)
            except subprocess.TimeoutExpired:
                continue
            # the group's members may outlive the supervisor by a moment
            time.sleep(0.5)
        try:
            os.killpg(self.process.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        self.log.close()


def _deploy_env() -> dict:
    """The children's environment: this one without the knobs of the
    other phases, and ``DEPLOY_ENV``."""
    env = {key: value for key, value in os.environ.items() if not key.startswith("LO_")}
    return {**env, **DEPLOY_ENV}


def _first_seen(child: _GroupChild, markers: dict, timeout_s: float, what: str) -> dict:
    """Each marker's seconds from the child's spawn to the first log line
    that holds it, watched together; raises when the child dies or the
    time passes first (:class:`_PortTaken` when a port was taken)."""
    seen: dict = {}
    deadline = time.time() + timeout_s
    while len(seen) < len(markers):
        text = open(child.log_path).read()
        for key, marker in markers.items():
            if key not in seen and marker in text:
                seen[key] = time.perf_counter() - child.spawned
        if len(seen) == len(markers):
            break
        if child.process.poll() is not None or time.time() > deadline:
            lines = child.lines()
            if _port_taken(lines):
                raise _PortTaken(f"{what}: a port was taken")
            raise AssertionError(f"{what}: only {sorted(seen)} of {sorted(markers)}:\n" + "\n".join(lines[-60:]))
        time.sleep(0.05)
    return seen


def _pass_done(lines: list, prefix: str, nth: int = 0) -> "dict | None":
    """The stats of the ``nth`` ``[aot] pass done`` line after ``prefix``."""
    found = [json.loads(line.split("[aot] pass done: ", 1)[1]) for line in lines
             if line.startswith(prefix + "[aot] pass done: ")]
    return found[nth] if len(found) > nth else None


def _wait_pass(child: _GroupChild, prefix: str, nth: int = 0) -> dict:
    deadline = time.time() + DEPLOY_PASS_TIMEOUT_S
    while True:
        stats = _pass_done(child.lines(), prefix, nth)
        if stats is not None:
            return stats
        if child.process.poll() is not None or time.time() > deadline:
            raise AssertionError(f"deploy: {prefix!r}'s compile pass never ended:\n" + "\n".join(child.lines()[-40:]))
        time.sleep(0.1)


def _ports_file(path: str) -> dict:
    with open(path) as handle:
        return json.load(handle)


def _fingerprinted_metas(store) -> list:
    """``__lo_executables__``'s meta rows: (artifact, fingerprint)."""
    from learningorchestra_tpu_torch.compile import fleetcache

    return sorted((doc["artifact"], doc["fingerprint"]) for doc in store.find(fleetcache.COLLECTION, {"meta": 1}))


def _worker_job_launches(counts: dict) -> dict:
    """A worker rank's launches in one job, from its ``done`` line."""
    return counts["launches"]


def _held_to_one_process(what: str, got: dict, want: dict) -> dict:
    """A build over two ranks against one process's: dt, rf and nb labels
    and accuracy equal; lr and gb (sums added over the ranks in another
    order) as the multigpu runs hold them."""
    held = {}
    for name in MODEL_NAMES:
        agreement = float((got[name]["labels"] == want[name]["labels"]).mean())
        accuracy_diff = abs(float(got[name]["metrics"][0]) - float(want[name]["metrics"][0]))
        if name in SPMD_REORDERED:
            if not (agreement >= MULTIGPU_MIN_AGREEMENT and accuracy_diff <= FIT_MARGIN_TOL):
                raise AssertionError(f"{what}: {name}'s labels agree on {agreement}, accuracy {accuracy_diff} apart")
        elif agreement != 1.0 or accuracy_diff != 0.0:
            raise AssertionError(f"{what}: {name}'s labels agree on {agreement}, accuracy {accuracy_diff} apart "
                                 "from one process's")
        held[name] = {"agreement": agreement, "accuracy_diff": accuracy_diff}
    return held


def _deploy_stack(torch, folder: str, walls: dict) -> dict:
    """(a) ``python -m learningorchestra_tpu_torch.deploy.stack`` on the
    card with the compile plane on: the store and seven services up, each
    booted on ``DEPLOY_CHILD_DEVICE``, ``stack_ports.json``; every pass
    all hits (the build phase built the libraries), ``__lo_executables__``
    five meta rows of this card's fingerprint; a sync five-classifier
    build over REST held bit for bit to the same build in this process
    over the same store; model_builder SIGKILLed, restarted by the
    supervisor, and a second build answering 201 with the same outputs."""
    import signal

    from learningorchestra_tpu_torch.compile import fleetcache
    from learningorchestra_tpu_torch.core.store_service import connect
    from learningorchestra_tpu_torch.ml.builder import build_model

    data_dir = os.path.join(folder, "stack")
    env = {**_deploy_env(), "LO_EPHEMERAL": "1", "LO_STORE_PORT": "0", "LO_AOT": "1", "LO_AOT_PUBLISH": "1",
           "LO_RESTART_DELAY": DEPLOY_RESTART_DELAY, "LO_MODELS_DIR": os.path.join(folder, "stack_models")}
    if DEPLOY_JIT_CACHE is not None:
        env["LO_JIT_CACHE"] = DEPLOY_JIT_CACHE
    stack = _GroupChild(DEPLOY_STACK_COMMAND + [data_dir], env, os.path.join(folder, "stack.log"), folder)
    remote = None
    try:
        markers = {name: f"[{name}] service {name} on " for name in SERVICE_NAMES}
        markers["all services up"] = "[stack] all services up"
        boot_s = _first_seen(stack, markers, DEPLOY_BOOT_TIMEOUT_S, "deploy: the stack")
        lines = stack.lines()
        for name in SERVICE_NAMES:
            if not any(line.startswith(f"[{name}] runner starting:") and f"device={DEPLOY_CHILD_DEVICE}" in line
                       for line in lines):
                raise AssertionError(f"deploy: {name} did not boot on {DEPLOY_CHILD_DEVICE}")
        ports = _ports_file(os.path.join(data_dir, "stack_ports.json"))
        if sorted(ports["ports"]) != sorted(["store", *SERVICE_NAMES]) or sorted(ports["pids"]) != sorted(
                ["store", *SERVICE_NAMES]):
            raise AssertionError(f"deploy: stack_ports.json holds {ports}")
        passes = {name: _wait_pass(stack, f"[{name}] ") for name in SERVICE_NAMES}
        for name, stats in passes.items():
            misses = {key: count for key, count in stats["events"].items() if key.startswith("miss/")}
            if stats["compiled"] != 5 or stats["failed"] or misses or stats["events"].get("hit/aot", 0) < 5:
                raise AssertionError(f"deploy: {name}'s compile pass {stats}")
        builder = _Client(ports["ports"]["model_builder"])
        text = _metrics_text(builder)
        aot = {"compiled": _metric_total(text, "lo_aot_programs_compiled_total"),
               "hits": _labelled_total(text, "lo_compile_events_total", 'result="hit",source="aot"'),
               "misses": _labelled_total(text, "lo_compile_events_total", 'result="miss"')}
        if aot != {"compiled": 5.0, "hits": 5.0, "misses": 0.0}:
            raise AssertionError(f"deploy: model_builder's compile counters {aot}")
        remote = connect(f"http://127.0.0.1:{ports['ports']['store']}")
        from learningorchestra_tpu_torch.compile.aot import backend_fingerprint

        fingerprint = json.dumps(backend_fingerprint(), sort_keys=True)
        metas = _fingerprinted_metas(remote)
        libraries = sorted(kernels.library_file(name) for name in kernels.SOURCES)
        if metas != [(library, fingerprint) for library in libraries]:
            raise AssertionError(f"deploy: {fleetcache.COLLECTION} holds {[artifact for artifact, _ in metas]}")

        product_store(remote)
        before = _metrics_text(builder)
        build = _store_build(builder, remote, "bench_test", False)
        _settled_jobs(builder, BENCH_WARMUPS)
        launches = _served_launches(before, _metrics_text(builder))
        missing = [name for name in BUILD_KERNELS if not launches[name]]
        if missing:
            raise AssertionError(f"deploy: the stack's build never launched {missing}")
        served = _stored_outputs(remote, "bench_test")
        if DEPLOY_DEVICE is None:
            torch.cuda.synchronize()
        began = time.perf_counter()
        build_model(remote, "bench_train", "bench_test", PRODUCT_PREPROCESSOR, list(MODEL_NAMES),
                    device=DEPLOY_DEVICE, models_dir=os.path.join(folder, "in_process_models"))
        if DEPLOY_DEVICE is None:
            torch.cuda.synchronize()
        in_process_wall_s = time.perf_counter() - began
        held = _held_bitwise("deploy: the stack's build", served, _stored_outputs(remote, "bench_test"))

        # the heal: model_builder killed, restarted, and a second build
        victim = ports["pids"]["model_builder"]
        killed_at = time.perf_counter()
        os.kill(victim, signal.SIGKILL)
        deadline = time.time() + DEPLOY_BOOT_TIMEOUT_S
        while True:
            ports = _ports_file(os.path.join(data_dir, "stack_ports.json"))
            if ports["pids"].get("model_builder") not in (None, victim) and "model_builder" in ports["ports"]:
                break
            if stack.process.poll() is not None or time.time() > deadline:
                raise AssertionError("deploy: the stack never restarted model_builder:\n"
                                     + "\n".join(stack.lines()[-40:]))
            time.sleep(0.05)
        restarted_s = time.perf_counter() - killed_at
        builder = _Client(ports["ports"]["model_builder"])
        second = _store_build(builder, remote, "bench_test", False)
        heal_s = time.perf_counter() - killed_at
        _held_bitwise("deploy: the build after the restart", _stored_outputs(remote, "bench_test"), served)
        reboots = [line for line in stack.lines() if line.startswith("[model_builder] runner starting:")]
        if len(reboots) != 2 or f"device={DEPLOY_CHILD_DEVICE}" not in reboots[1]:
            raise AssertionError(f"deploy: model_builder's boots {reboots}")
        restart_pass = _wait_pass(stack, "[model_builder] ", 1)
        if restart_pass["compiled"] != 5 or any(key.startswith("miss/") for key in restart_pass["events"]):
            raise AssertionError(f"deploy: the restarted model_builder's pass {restart_pass}")
    finally:
        if remote is not None:
            remote.close()
        stack.stop()
    walls.update({"stack: build over REST": build["wall_s"], "stack: build in process": in_process_wall_s,
                  "stack: kill to restart": restarted_s, "stack: kill to the next 201": heal_s,
                  "stack: second build": second["wall_s"]})
    return {
        "boot_s": boot_s,
        "aot_pass_s": {name: stats["seconds"] for name, stats in passes.items()},
        "aot": aot, "libraries": libraries, "launches": launches, "held": held, "outputs": served,
    }


def _deploy_cluster(torch, folder: str, walls: dict, one_process: dict) -> dict:
    """(b) ``python -m learningorchestra_tpu_torch.deploy.cluster up`` over
    the local transport on one card: a head (store and coordinator) and a
    worker-only machine, both ``LO_DIST_BACKEND=gloo`` on card 0, the
    manifest's ``compile`` section on. The worker's ``LO_JIT_CACHE`` is an
    empty folder of its own: its pass fetches the five libraries from the
    head's ``__lo_executables__`` and runs nvcc zero times. A sync build
    over REST held to one process's (``one_process``: the stack's); the
    worker's runner SIGKILLed, every machine's group relaunched by the
    driver, and a second build answering 201 with the same labels."""
    import signal

    from learningorchestra_tpu_torch.core.store_service import connect

    cluster_dir = os.path.join(folder, "cluster")
    os.makedirs(cluster_dir)
    head_data, worker_data = os.path.join(cluster_dir, "head"), os.path.join(cluster_dir, "machine1")
    worker_cache = os.path.join(cluster_dir, "machine1_kernels")
    os.makedirs(worker_cache)
    head_env = {} if DEPLOY_JIT_CACHE is None else {"LO_JIT_CACHE": DEPLOY_JIT_CACHE}

    def boot():
        import shutil

        for stale in (head_data, worker_data):
            shutil.rmtree(stale, ignore_errors=True)
        manifest = {
            "transport": "local",
            "head": {"host": "127.0.0.1", "bind": "127.0.0.1", "data_dir": head_data, "workers": 0,
                     "env": head_env},
            "workers": [{"host": "127.0.0.1", "data_dir": worker_data, "env": {"LO_JIT_CACHE": worker_cache}}],
            "models_dir": os.path.join(cluster_dir, "models"),
            "store_port": _free_port(), "coord_port": _free_port(),
            "restart_delay": float(DEPLOY_RESTART_DELAY),
            "compile": {"aot": 1, "publish": 1},
            "env": {"LO_EPHEMERAL": "1", "LO_RESTART_DELAY": DEPLOY_RESTART_DELAY, "LO_DIST_BACKEND": "gloo",
                    "LO_SPMD_TIMEOUT_S": DEPLOY_SPMD_TIMEOUT_S},
        }
        path = os.path.join(cluster_dir, "manifest.json")
        with open(path, "w") as handle:
            json.dump(manifest, handle)
        driver = _GroupChild(DEPLOY_CLUSTER_COMMAND + [path], _deploy_env(), os.path.join(cluster_dir, "driver.log"),
                             cluster_dir)
        try:
            return driver, _first_seen(driver, {
                "store": "[cluster] store healthy", "coordinator": "[head] [coordinator] service model_builder on",
                "worker": "[machine1] [worker1] spmd worker: waiting for jobs", "cluster": "[cluster] up:",
            }, DEPLOY_BOOT_TIMEOUT_S, "deploy: the cluster")
        except BaseException:
            driver.stop()
            raise

    driver, boot_s = _on_new_ports(boot, "deploy: the cluster")
    remote = None
    try:
        lines = driver.lines()
        for prefix in ("[head] [coordinator] ", "[machine1] [worker1] "):
            if not any(line.startswith(prefix + "runner starting:") and f"device={DEPLOY_CHILD_DEVICE}" in line
                       for line in lines):
                raise AssertionError(f"deploy: {prefix.strip()} did not boot on {DEPLOY_CHILD_DEVICE}")
        head_pass = _wait_pass(driver, "[head] [coordinator] ")
        worker_pass = _wait_pass(driver, "[machine1] [worker1] ")
        if head_pass["published"] != 5:
            raise AssertionError(f"deploy: the head's pass {head_pass}")
        fetched = sorted(os.listdir(worker_cache))
        misses = {key: count for key, count in worker_pass["events"].items() if key.startswith("miss/")}
        if (worker_pass["fetched"] != 5 or worker_pass["compiled"] != 5 or misses
                or worker_pass["events"].get("hit/fleetcache") != worker_pass["fetched"]
                or fetched != sorted(kernels.library_file(name) for name in kernels.SOURCES)):
            raise AssertionError(f"deploy: the worker machine's pass {worker_pass}, its folder {fetched}")

        head_ports = os.path.join(head_data, "stack_ports.json")
        ports = _ports_file(head_ports)
        remote = connect(f"http://127.0.0.1:{ports['ports']['store']}")
        product_store(remote)
        builds, done_lines = [], []
        for attempt in range(2):
            if attempt:
                # the heal: the worker machine's runner killed; the driver
                # relaunches every machine's group
                victim = _ports_file(os.path.join(worker_data, "stack_ports.json"))["pids"]["worker1"]
                coordinator = ports["pids"]["coordinator"]
                killed_at = time.perf_counter()
                os.kill(victim, signal.SIGKILL)
                deadline = time.time() + DEPLOY_BOOT_TIMEOUT_S
                while True:
                    text = open(driver.log_path).read()
                    ports = _ports_file(head_ports) if os.path.exists(head_ports) else {"pids": {}, "ports": {}}
                    if (text.count("[cluster] up:") == 2 and ports["pids"].get("coordinator") not in (None, coordinator)
                            and "model_builder" in ports["ports"]):
                        break
                    if driver.process.poll() is not None or time.time() > deadline:
                        raise AssertionError("deploy: the cluster never healed:\n" + "\n".join(driver.lines()[-60:]))
                    time.sleep(0.05)
                relaunched_s = time.perf_counter() - killed_at
                remote.close()
                remote = connect(f"http://127.0.0.1:{ports['ports']['store']}")
            build = _store_build(_Client(ports["ports"]["model_builder"]), remote, "bench_test", False)
            if attempt:
                heal_s = time.perf_counter() - killed_at
            builds.append(build["wall_s"])
            held = _held_to_one_process("deploy: the cluster's build", _stored_outputs(remote, "bench_test"),
                                        one_process)
            done = [json.loads(line.split(" done ", 1)[1]) for line in driver.lines()
                    if line.startswith("[machine1] [worker1] spmd worker 1: job 'build_model' done ")]
            if len(done) != attempt + 1:
                raise AssertionError(f"deploy: the worker ran {len(done)} builds")
            launches = _worker_job_launches(done[-1])
            missing = [name for name in _spmd_required_launches("build_model") if not launches.get(name)]
            misses = {key: count for key, count in done[-1]["compile_events"].items() if key.startswith("miss/")}
            if missing or misses:
                raise AssertionError(f"deploy: the worker's build never launched {missing}, compile misses {misses}")
            done_lines.append(done[-1])
        if sorted(os.listdir(worker_cache)) != fetched:
            raise AssertionError(f"deploy: the worker's folder now holds {os.listdir(worker_cache)}")
    finally:
        if remote is not None:
            remote.close()
        driver.stop()
    walls.update({"cluster: first build over REST": builds[0], "cluster: kill to relaunched": relaunched_s,
                  "cluster: kill to the next 201": heal_s, "cluster: second build": builds[1]})
    return {
        "boot_s": boot_s,
        "aot_pass_s": {"head": head_pass["seconds"], "worker": worker_pass["seconds"]},
        "fetch": {"fetched": worker_pass["fetched"], "seconds": worker_pass["fetch_seconds"],
                  "events": worker_pass["events"]},
        "held": held,
        "worker_jobs": [{"wall_s": done["wall_s"], "launches": done["launches"],
                         "compile_events": done["compile_events"]} for done in done_lines],
    }


def phase_deploy(torch, card: str) -> dict:
    """The port's deployment on the card (its children each on
    ``DEPLOY_CHILD_DEVICE``): (a) the supervised stack
    (``deploy.stack``, the compile plane on), its build over REST held to
    an in-process build, model_builder killed and restarted; (b) the
    cluster driver (``deploy.cluster up``) with a head and a worker-only
    machine whose empty build folder fills from the head's store with no
    nvcc, its build over REST held to one process's, the worker's runner
    killed and every machine's group relaunched. K1-K7 and K6 launch in
    the stack's model_builder and on the worker's rank. Printed: each
    boot's seconds, the passes' seconds, the fetch's seconds beside the
    build phase's cold nvcc seconds, the builds' walls beside the
    in-process build's, and the heals' seconds."""
    started = time.perf_counter()
    walls: dict = {}
    with tempfile.TemporaryDirectory() as folder:
        stack = _deploy_stack(torch, folder, walls)
        cluster = _deploy_cluster(torch, folder, walls, stack.pop("outputs"))
    record = {
        "phase": "deploy",
        "rows": {"train": PRODUCT_ROWS, "test": PRODUCT_ROWS},
        "stack": stack,
        "cluster": cluster,
        "walls_s": walls,
        "cold_nvcc_s": {name: info["seconds"] for name, info in kernels.build_info.items() if info.get("built")},
        "launches": stack["launches"],
        "worker_launches": cluster["worker_jobs"][0]["launches"],
        "phase_s": time.perf_counter() - started,
        "nvidia_smi": card,
    }
    emit(record)
    return record


def check_bounds(summary) -> None:
    """A time below its kernel's bound means that the bound or the timing
    is wrong: raise."""
    for entry in summary:
        timed = {
            **entry.get("by_rows", {}), **entry.get("by_level", {}), **entry.get("by_classes", {}),
            **entry.get("by_shape", {}),
            **entry.get("forest", {}).get("by_level", {}), "at the main path's shape": entry,
        }
        for key, at in timed.items():
            for field in ("ms", "device_ms", "ms_cold", "device_ms_cold", "device_ms_clean_l2"):
                if at.get(field) is not None and at[field] < at["bound_ms"]:
                    raise AssertionError(
                        f"{entry['name']} at {key}: {field} {at[field]} is below "
                        f"its bound {at['bound_ms']}"
                    )


def _timed_phase(walls: dict, name: str, phase, *args):
    """``phase(*args)``, its wall booked under ``name``."""
    began = time.perf_counter()
    try:
        return phase(*args)
    finally:
        walls[name] = time.perf_counter() - began


PHASES = (
    "kernels", "serve", "fit-kernels", "fit", "embed-kernels", "embed", "sweep", "models", "stack",
    "batch", "store", "shards", "bf16", "multigpu", "fleet", "deploy", "services",
)

# why no single PyTorch call stands beside a job-axis kernel or a program
NO_LIBRARY = {
    "logistic_loss_grad:jobs": "no PyTorch call gives a masked mean nll with its gradient, per job",
    "logistic_trial_losses:jobs": "no PyTorch call gives the masked nll at four points, per job",
    "select_splits:jobs": "no PyTorch call picks a node's best gini split over (feature, bin)",
    "route:jobs": "no PyTorch call routes rows down a split heap",
    "tree_ensemble_forward:jobs": "no PyTorch call computes a tree-ensemble forward",
    "lr_fused_segment": "no PyTorch call runs an L-BFGS segment",
    "lr_fused_eval": "the program is torch ops itself (torch.matmul and K9's metrics)",
    "dt_fused": "no PyTorch call fits a decision tree",
}


def main(argv) -> int:
    import torch

    wanted = argv or list(PHASES)
    unknown = sorted(set(wanted) - set(PHASES))
    if unknown:
        raise SystemExit(f"chip_smoke: unknown phases {unknown}; phases are {list(PHASES)}")
    walls: dict = {}   # each phase's wall, printed before the kernels line
    began = time.perf_counter()
    device = _timed_phase(walls, "device", phase_device, torch)
    _timed_phase(walls, "build", phase_build)
    summary = []
    if "kernels" in wanted:
        kernel_results = _timed_phase(walls, "kernels", phase_kernels, torch)
        serve = _timed_phase(walls, "serve", phase_serve, torch, device["card"]) if "serve" in wanted else None
        for name, result in kernel_results.items():
            at_serve = result["by_rows"][4096]
            summary.append({
                "name": name,
                "route": "cuda",
                "source": KERNEL_SOURCE,
                "replaces": REPLACES[name],
                "launches": serve["launches"][name] if serve else None,
                "max_abs_err": result["max_abs_err"],
                "rows": 4096,
                "ms": at_serve["ms"],
                "device_ms": at_serve["device_ms"],
                "plain_ms": at_serve["plain_ms"],
                "bound_ms": at_serve["bound_ms"],
                "bound_by": at_serve["bound_by"],
                "library_ms": None,  # no single PyTorch call computes a tree-ensemble forward
                "by_rows": result["by_rows"],
            })
    elif "serve" in wanted:
        _timed_phase(walls, "serve", phase_serve, torch, device["card"])
    fit_kernels = _timed_phase(walls, "fit-kernels", phase_fit_kernels, torch) if "fit-kernels" in wanted else None
    fit = _timed_phase(walls, "fit", phase_fit, torch, device["card"]) if "fit" in wanted else None
    for entry in summary:   # K6: the fits' evaluates (evaluate_predict on the fit's rows) launch it too
        entry["evaluate_launches"] = sum(
            fit[name]["evaluate_launches"].get(entry["name"], 0) for name in ("dt", "rf", "gb")
        ) if fit else None
    if fit_kernels:
        for name, result in fit_kernels.items():
            k7 = name in LOGISTIC_REPLACES
            summary.append({
                "name": name,
                "route": "cuda",
                "source": LOGISTIC_SOURCE if k7 else FIT_SOURCE,
                "replaces": LOGISTIC_REPLACES[name] if k7 else FIT_REPLACES[name],
                "launches": fit["launches"][name] if fit else None,
                "max_abs_err": result["max_abs_err"],
                "rows": FIT_ROWS,
                **{field: result[field] for field in (
                    "ms", "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms"
                )},
                **({"warm_ms": result["warm_ms"], "by_classes": result["by_classes"]} if k7
                   else {"by_level": result["by_level"]}),
                **{field: result[field] for field in ("by_shape", "launch_floor_ms") if field in result},
                **({"forest": result["forest"]} if name in FOREST_KERNELS else {}),
            })
    if "embed-kernels" in wanted or "embed" in wanted:
        store, labels_by_name, setup_s = _timed_phase(walls, "embed store", embed_store)
    embed_kernels = _timed_phase(walls, "embed-kernels", phase_embed_kernels, torch, store) if "embed-kernels" in wanted else None
    embed = _timed_phase(walls, "embed", phase_embed, torch, device["card"], store, labels_by_name, setup_s) if "embed" in wanted else None
    if embed_kernels:
        # each at the main path's largest shape: K11 and K12 at the exact
        # fit's 20,000 rows (K12 late), K13 at 1,000,000 rows x 5,000
        # landmarks
        at_main = {
            "tsne_affinities": EXACT_ROWS,
            "tsne_z": f"{EXACT_ROWS}:late",
            "tsne_grad": f"{EXACT_ROWS}:late",
            "tsne_interpolate": f"{EMBED_ROWS}x{tsne.LANDMARKS}",
        }
        for name, result in embed_kernels.items():
            at = result["by_rows"][at_main[name]]
            summary.append({
                "name": name,
                "route": "cuda",
                "source": TSNE_SOURCE,
                "replaces": TSNE_REPLACES[name],
                "launches": embed["launches"][name] if embed else None,
                "max_abs_err": result["max_abs_err"],
                "max_rel_err": result["max_rel_err"],
                "rows": at_main[name],
                **{field: at[field] for field in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by")},
                # no single PyTorch call computes calibrated affinities, the
                # t-SNE gradient or the calibrated interpolation
                "library_ms": None,
                "by_rows": result["by_rows"],
            })
    sweep_record = _timed_phase(walls, "sweep", phase_sweep, torch, device["card"]) if "sweep" in wanted else None
    if sweep_record:
        for name, result in sweep_record["kernels"].items():
            _, source, replaces = JOB_KERNELS[name]
            summary.append({
                "name": name, "route": "cuda", "source": source, "replaces": replaces,
                **{field: result[field] for field in (
                    "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms", "jobs", "rows",
                )},
                **({"library_note": NO_LIBRARY[name]} if name in NO_LIBRARY else {}),
            })
        for name, result in sweep_record["programs"].items():
            summary.append({
                "name": name, "route": "cuda", "source": SWEEP_SOURCE,
                "replaces": PROGRAM_REPLACES[name],
                **{field: result[field] for field in (
                    "launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "jobs", "rows",
                )},
                "library_ms": None, "library_note": NO_LIBRARY[name],
            })
    if "models" in wanted:
        _timed_phase(walls, "models", phase_models, torch, device["card"])
    if "stack" in wanted:
        _timed_phase(walls, "stack", phase_stack, torch, device["card"])
    batch = _timed_phase(walls, "batch", phase_batch, torch, device["card"]) if "batch" in wanted else None
    store_record = _timed_phase(walls, "store", phase_store, torch, device["card"]) if "store" in wanted else None
    if "shards" in wanted:
        _timed_phase(walls, "shards", phase_shards, torch, device["card"], store_record)
    if "bf16" in wanted:
        bf16 = _timed_phase(walls, "bf16", phase_bf16, torch, device["card"], batch["f32_metrics"] if batch else None)
        summary.extend(bf16["kernels"])
    if "multigpu" in wanted:
        summary.extend(_timed_phase(walls, "multigpu", phase_multigpu, torch, device["card"]))
        for entry in summary:   # the job-axis kernels: each rank's launches in run (c)'s sweeps
            if entry["name"] in JOB_KERNELS and "sweep" in wanted:
                counter = JOB_KERNELS[entry["name"]][0]
                kind = "lr" if counter.startswith("logistic") else "dt"
                entry["launches_over_ranks"] = {"c": [launches.get(counter, 0)
                                                      for launches in MULTIGPU_SWEEP_LAUNCHES[kind]]}
    if "fleet" in wanted:
        fleet = _timed_phase(walls, "fleet", phase_fleet, torch, device["card"])
        for entry in summary:   # K6 on the replicas under the fleet's load
            if entry["name"] in FORWARD_KERNELS:
                entry["fleet_launches"] = {label: counts[entry["name"]] for label, counts in fleet["launches"].items()}
    if "deploy" in wanted:
        deploy = _timed_phase(walls, "deploy", phase_deploy, torch, device["card"])
        for entry in summary:   # the build kernels in the stack's model_builder and on the worker's rank
            if entry["name"] in deploy["launches"]:
                entry["deploy_launches"] = {"stack": deploy["launches"][entry["name"]],
                                            "cluster_worker": deploy["worker_launches"].get(entry["name"], 0)}
    if "services" in wanted:
        _timed_phase(walls, "services", phase_services, torch, device["card"])
    emit({"phase": "profiler", "lost_traces": LOST_TRACES})
    emit({"phase": "walls", "walls_s": walls, "total_s": time.perf_counter() - began, "nvidia_smi": device["card"]})
    check_bounds(summary)
    emit({"kernels": summary})
    print(device["card"], flush=True)
    emit({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    })
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["bf16-child"]:
        sys.exit(bf16_child())
    if sys.argv[1:2] == ["multigpu-child"]:
        sys.exit(multigpu_child(sys.argv[2:]))
    sys.exit(main(sys.argv[1:]))
