"""The job coalescer and the fused-fit bit-identity bar, on the port.

``TestCoalescerStage``, ``TestCoalescedJobsThroughScheduler`` and
``TestSweepRoute`` are the JAX package's own (``tests/test_coalesce.py``),
read and run here with their imports pointed at the port: the stage
(``learningorchestra_tpu_torch/sched/coalesce.py``) with a fake runner;
member jobs through the port's job manager and scheduler, each with its
own record, cancellation and failure; and ``POST /models/sweep`` on the
port's model_builder app (on the CPU), the lr and dt sweeps, the
validation answers, the 409 on a taken name, the winner served by
``/models/<sweep_name>/predict``, and the JAX package's client driving
the route over HTTP. ``TestBatchedFitBitIdentity`` is the reference's class of
the same name with the port's API (``device="cpu"`` where the reference
passes a mesh) and the same assertions: a member fused into a batch is
bit-identical to the same member run alone at the same padded width, for
lr and dt, also beside a cancelled and a NaN-poisoned neighbour; the lr
sweep tracks the solo estimator with ``tol=0`` within rtol 1e-4 / atol
1e-5 (the sweep standardizes in float32 on the device and masks padded
rows, the solo fit standardizes in float64 on the host and pads nothing).

On the card, chip_smoke.py's ``sweep`` phase holds the same bar with the
CUDA kernels (python3 chip_smoke.py sweep).
"""

import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from learningorchestra_tpu_torch.sched import coalesce as port_coalesce  # noqa: E402

REFERENCE_TESTS = pathlib.Path(__file__).with_name("test_coalesce.py")
NOT_PORTED = (
    "TestBatchedFitBitIdentity",           # ported below, with device= for mesh=
)

_source = (
    REFERENCE_TESTS.read_text()
    .replace("learningorchestra_tpu.", "learningorchestra_tpu_torch.")
    # the client stays the JAX package's: the port serves its routes
    .replace("learningorchestra_tpu_torch.client", "learningorchestra_tpu.client")
)
_old, _new = "store, models_dir=str(tmp_path), **kwargs", 'store, models_dir=str(tmp_path), device="cpu", **kwargs'
assert _source.count(_old) == 1, _old
_source = _source.replace(_old, _new)
exec(compile(_source, str(REFERENCE_TESTS), "exec"), globals())  # noqa: S102
for _name in NOT_PORTED:
    del globals()[_name]


@pytest.fixture()
def store():
    """The port's store under the reference's route tests."""
    from learningorchestra_tpu_torch.core.store import InMemoryStore

    return InMemoryStore()


def _module_names(code):
    """The dotted names a code object (and the code nested in it) uses:
    its imports among them."""
    yield from code.co_names
    for const in code.co_consts:
        if hasattr(const, "co_names"):
            yield from _module_names(const)


def test_the_reference_stage_tests_run_on_the_port():
    """The stage the reference's tests drive is the port's, and nothing
    they run imports the JAX package."""
    assert Coalescer is port_coalesce.Coalescer  # noqa: F821
    tests = [
        member
        for name, value in list(globals().items()) if name.startswith("TestCoalescerStage")
        for member in vars(value).values()
        if getattr(member, "__code__", None) is not None
    ]
    assert len([t for t in tests if t.__name__.startswith("test_")]) == 12
    for test in tests + [_ok_runner, _member_data]:  # noqa: F821
        assert not any(
            name.startswith("learningorchestra_tpu.") for name in _module_names(test.__code__)
        ), test.__name__


class TestBatchedFitBitIdentity:
    """THE correctness bar: fused == sequential, bit for bit."""

    def _solo_results(self, specs, max_iter=15):
        """Each member through the passthrough (window 0) path — the
        sequential baseline."""
        from learningorchestra_tpu_torch.ml import sweep as lo_sweep

        solo = port_coalesce.Coalescer(window_s=0.0, max_jobs=8)
        runner = lo_sweep.group_runner("cpu")
        results = []
        for i, (X, y, grid) in enumerate(specs):
            key, payload = lo_sweep.prepare_member(
                "lr", X, y, X, y, grid, device="cpu", max_iter=max_iter
            )
            member = solo.register(key, payload, runner, name=f"solo-{i}")
            results.append(solo.run_member(member))
        return results

    def test_coalesced_batch_is_bit_identical_to_sequential(self):
        from learningorchestra_tpu_torch.ml import sweep as lo_sweep

        specs = [
            (*_member_data(i), [{"reg_param": l2}])  # noqa: F821
            for i, l2 in enumerate((0.0, 0.1, 0.01, 0.5, 0.0))
        ]
        fused = port_coalesce.Coalescer(window_s=0.05, max_jobs=8)
        runner = lo_sweep.group_runner("cpu")
        members = []
        for i, (X, y, grid) in enumerate(specs):
            key, payload = lo_sweep.prepare_member(
                "lr", X, y, X, y, grid, device="cpu", max_iter=15
            )
            members.append(fused.register(key, payload, runner, name=f"f{i}"))
        fused_results = [fused.run_member(m) for m in members]
        assert fused.stats()["fused_dispatches"] == 1  # ONE dispatch
        for fused_result, solo_result in zip(fused_results, self._solo_results(specs)):
            f_point, s_point = fused_result["points"][0], solo_result["points"][0]
            # metrics: bit-identical floats, not just close
            assert f_point["accuracy"] == s_point["accuracy"]
            assert f_point["weighted_f1"] == s_point["weighted_f1"]
            # fitted params: bit-identical arrays
            np.testing.assert_array_equal(
                fused_result["params"][0]["w"], solo_result["params"][0]["w"]
            )
            np.testing.assert_array_equal(
                fused_result["params"][0]["b"], solo_result["params"][0]["b"]
            )

    def test_mid_batch_cancel_and_failure_leave_neighbors_bit_identical(self):
        from learningorchestra_tpu_torch.ml import sweep as lo_sweep

        specs = [
            (*_member_data(10 + i), [{"reg_param": 0.05 * i}])  # noqa: F821
            for i in range(5)
        ]
        # member 3 is poisoned: NaN features must fail IT alone
        specs[3][0][7, 2] = np.nan
        fused = port_coalesce.Coalescer(window_s=0.05, max_jobs=8)
        runner = lo_sweep.group_runner("cpu")
        tokens = [CancelToken() for _ in range(5)]  # noqa: F821
        members = []
        for i, (X, y, grid) in enumerate(specs):
            key, payload = lo_sweep.prepare_member(
                "lr", X, y, X, y, grid, device="cpu", max_iter=15
            )
            members.append(
                fused.register(key, payload, runner, token=tokens[i], name=f"f{i}")
            )
        tokens[1].cancel("mid-batch cancel")  # member 1 masked out
        fused_results = {}
        for i, member in enumerate(members):
            if i == 1:
                with pytest.raises(JobCancelledError):  # noqa: F821
                    fused.run_member(member)
            elif i == 3:
                with pytest.raises(ValueError, match="non-finite"):
                    fused.run_member(member)
            else:
                fused_results[i] = fused.run_member(member)
        assert fused.stats()["masked"] == 1
        survivors = [0, 2, 4]
        solo = self._solo_results([specs[i] for i in survivors])
        for solo_result, i in zip(solo, survivors):
            np.testing.assert_array_equal(
                fused_results[i]["params"][0]["w"],
                solo_result["params"][0]["w"],
            )
            assert (
                fused_results[i]["points"][0]["accuracy"]
                == solo_result["points"][0]["accuracy"]
            )

    def test_dt_fused_matches_passthrough_bitwise(self):
        from learningorchestra_tpu_torch.ml import sweep as lo_sweep

        grid = [{"max_depth": 2}, {"max_depth": 3}]
        specs = [(*_member_data(20 + i), grid) for i in range(3)]  # noqa: F821
        runner = lo_sweep.group_runner("cpu")

        def run(window_s):
            co = port_coalesce.Coalescer(window_s=window_s, max_jobs=8)
            members = []
            for i, (X, y, g) in enumerate(specs):
                key, payload = lo_sweep.prepare_member(
                    "dt", X, y, X, y, g, device="cpu"
                )
                members.append(co.register(key, payload, runner, name=f"d{i}"))
            return [co.run_member(m) for m in members], co

        fused_results, fused_co = run(0.05)
        solo_results, _ = run(0.0)
        assert fused_co.stats()["fused_dispatches"] == 1
        for fused_result, solo_result in zip(fused_results, solo_results):
            for f_params, s_params in zip(
                fused_result["params"], solo_result["params"]
            ):
                np.testing.assert_array_equal(
                    f_params["features_heap"], s_params["features_heap"]
                )
                np.testing.assert_array_equal(
                    f_params["leaf_probs"], s_params["leaf_probs"]
                )
            for f_point, s_point in zip(
                fused_result["points"], solo_result["points"]
            ):
                assert f_point["accuracy"] == s_point["accuracy"]

    def test_lr_sweep_tracks_the_solo_estimator(self):
        """Anchor the batched program to the product estimator: same
        data, λ=0, full iteration budget → near-identical params (the
        batched path skips the plateau exit, so compare with tol=0)."""
        from learningorchestra_tpu_torch.ml import sweep as lo_sweep
        from learningorchestra_tpu_torch.ml.logistic import LogisticRegression

        X, y = _member_data(42)  # noqa: F821
        key, payload = lo_sweep.prepare_member(
            "lr", X, y, X, y, [{"reg_param": 0.0}], device="cpu", max_iter=25
        )
        co = port_coalesce.Coalescer(window_s=0.0, max_jobs=8)
        member = co.register(key, payload, lo_sweep.group_runner("cpu"))
        result = co.run_member(member)
        solo = LogisticRegression(max_iter=25, tol=0.0, device="cpu").fit(X, y)
        np.testing.assert_allclose(
            result["params"][0]["w"],
            solo.w.numpy(),
            rtol=1e-4,
            atol=1e-5,
        )
        accuracy, _ = solo.evaluate(X, y)
        assert abs(result["points"][0]["accuracy"] - accuracy) < 1e-6


def test_entry_points_need_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from learningorchestra_tpu_torch.ml import sweep as lo_sweep

    X, y = _member_data(0)  # noqa: F821
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lo_sweep.prepare_member("lr", X, y, X, y, [{"reg_param": 0.0}])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lo_sweep.group_runner()
    _, payload = lo_sweep.prepare_member("lr", X, y, X, y, [{"reg_param": 0.0}], device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lo_sweep.run_group([payload])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lo_sweep.model_from_params({"kind": "lr", "w": np.zeros((6, 2), np.float32)})
    from learningorchestra_tpu_torch.core.jobs import JobManager
    from learningorchestra_tpu_torch.core.store import InMemoryStore
    from learningorchestra_tpu_torch.services import runner

    with pytest.raises(RuntimeError, match="no CUDA device"):
        lo_sweep.run_sweep(InMemoryStore(), {"sweep_name": "s"}, jobs=JobManager(), coalescer=Coalescer())  # noqa: F821
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runner.start_all(InMemoryStore(), ephemeral=True)


def test_knobs_are_the_reference_knobs(monkeypatch):
    from learningorchestra_tpu_torch.sched import config

    monkeypatch.setenv("LO_COALESCE_WINDOW_MS", "10")
    monkeypatch.setenv("LO_COALESCE_MAX_JOBS", "64")
    co = port_coalesce.Coalescer()
    assert (co.window_s, co.max_jobs) == (0.010, 64)
    monkeypatch.setenv("LO_COALESCE_MAX_JOBS", "1.5")
    with pytest.raises(ValueError, match="LO_COALESCE_MAX_JOBS"):
        config.coalesce_max_jobs()
