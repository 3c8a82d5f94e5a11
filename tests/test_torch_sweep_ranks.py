"""The sweep's job axis over data ranks (``ml/sweep.py`` with ``mesh=``),
on gloo ranks on the CPU.

Two and four ranks (``tests/torch_rank_child.py sweep``, one process a
rank, started once a world size) each run ``run_group`` over the data
mesh on the lr and dt grids of two members, a group with a poisoned
member, and ``run_sweep`` into their own store and folder. Held here:

- every rank returns the same outcomes, bit for bit;
- dt is bit-equal to the one-process ``run_group`` (heaps, leaf
  probabilities, metrics): its sums are integer counts;
- each lr slot is bit-identical to the same slot run alone at the
  rank's local padded width (``sweep._lr_slots`` of that slot repeated),
  the coalescer's bar (``tests/test_torch_coalesce.py``); against the
  one-process sweep at full width, the same ``best`` and accuracies and
  ``W``, ``b`` within 1e-4 of their scale (a job axis of another width
  sums in another order);
- both kinds against the JAX package's ``run_group`` over its own mesh,
  at ``tests/test_torch_sweep.py``'s tolerances;
- ``_job_axis`` pads to a multiple of the data size, and the members'
  keys carry the mesh;
- a member poisoned on any rank fails alone, on every rank;
- ``run_sweep`` over ranks writes its document and checkpoint once (one
  rank saves, into the models folder every rank shares).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_rank_child as child  # noqa: E402
from learningorchestra_tpu.ml import sweep as jax_sweep  # noqa: E402
from learningorchestra_tpu.ml.base import resolve_mesh  # noqa: E402
from learningorchestra_tpu_torch.ml import sweep  # noqa: E402
from learningorchestra_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from learningorchestra_tpu_torch.utils.shapegrid import padded_indices  # noqa: E402

WORLDS = (2, 4)


def rank_mesh(world: int, rank: int) -> Mesh:
    """A stand-in for rank ``rank``'s mesh of ``world`` data ranks (no
    group: for the padding, the keys and the block of slots)."""
    return Mesh(shape={"data": world, "model": 1}, data_index=rank, group=None,
                device=torch.device("cpu"))


def payloads(kind: str, mesh=None) -> list:
    grid = child.LAMBDAS if kind == "lr" else child.DEPTHS
    return [
        sweep.prepare_member(kind, X, y, Xe, ye, grid, device="cpu", max_iter=child.MAX_ITER, mesh=mesh)[1]
        for X, y, Xe, ye in child.sweep_members()
    ]


@pytest.fixture(scope="module", params=WORLDS)
def ranks(request, tmp_path_factory):
    folder = tmp_path_factory.mktemp(f"sweep{request.param}")
    results, _ = child.run_ranks("sweep", request.param, folder, folder, timeout_s=240)
    return request.param, results


@pytest.fixture(scope="module")
def one_process():
    return {kind: sweep.run_group(payloads(kind), "cpu") for kind in ("lr", "dt")}


@pytest.fixture(scope="module")
def reference():
    mesh = resolve_mesh(None)
    out = {}
    for kind in ("lr", "dt"):
        grid = child.LAMBDAS if kind == "lr" else child.DEPTHS
        members = [
            jax_sweep.prepare_member(kind, X, y, Xe, ye, grid, mesh=mesh, max_iter=child.MAX_ITER)[1]
            for X, y, Xe, ye in child.sweep_members()
        ]
        out[kind] = jax_sweep.run_group(members, mesh)
    return out


def assert_close_to_scale(got, expected, relative):
    got, expected = np.asarray(got), np.asarray(expected)
    scale = max(np.abs(expected).max(), 1e-30)
    assert np.abs(got - expected).max() <= relative * scale, (np.abs(got - expected).max(), scale)


def assert_same_outcomes(got: list, want: list) -> None:
    """Outcomes equal bit for bit: statuses, points, best and params."""
    assert len(got) == len(want)
    for (status, result), (want_status, want_result) in zip(got, want):
        assert status == want_status == "ok"
        assert result["best"] == want_result["best"]
        assert result["points"] == want_result["points"]
        assert result["_attribution"] == want_result["_attribution"]
        for params, want_params in zip(result["params"], want_result["params"]):
            assert params.keys() == want_params.keys()
            for key, value in params.items():
                if isinstance(value, np.ndarray):
                    assert value.dtype == want_params[key].dtype
                    np.testing.assert_array_equal(value, want_params[key], err_msg=key)
                else:
                    assert value == want_params[key], key


@pytest.mark.parametrize("kind", ["lr", "dt"])
def test_every_rank_returns_the_same_outcomes(ranks, kind):
    world, results = ranks
    assert [result["mesh"] for result in results] == [[world, rank] for rank in range(world)]
    for result in results[1:]:
        assert_same_outcomes(result[kind], results[0][kind])
    # one gather of the verdicts, then one a fused program
    assert all(result["collectives"] == results[0]["collectives"] > 0 for result in results)


def test_dt_is_bit_equal_to_one_process(ranks, one_process):
    _, results = ranks
    assert_same_outcomes(results[0]["dt"], one_process["dt"])


def test_each_lr_slot_is_bit_identical_to_its_solo_run_at_the_local_width(ranks):
    world, results = ranks
    members = payloads("lr", rank_mesh(world, 0))
    chunk = [(member, point) for member in range(len(members)) for point in range(len(child.LAMBDAS))]
    padded = sweep._job_axis(len(chunk), rank_mesh(world, 0))
    slots = [chunk[i] for i in padded_indices(len(chunk), padded)]
    local = padded // world
    assert local * world == padded
    for rank in range(world):
        block = sweep._rank_block(slots, rank_mesh(world, rank))
        assert block == slots[rank * local : (rank + 1) * local]
        for offset, (member, point) in enumerate(block):
            if rank * local + offset >= len(chunk):
                continue   # a dummy slot
            w, b, accuracy, f1 = (array[0] for array in sweep._lr_slots(members, [(member, point)] * local, "cpu"))
            outcome = results[0]["lr"][member][1]
            params = outcome["params"][point]
            np.testing.assert_array_equal(params["w"], w)
            np.testing.assert_array_equal(params["b"], b)
            assert outcome["points"][point]["accuracy"] == float(accuracy)
            assert outcome["points"][point]["weighted_f1"] == float(f1)


def test_lr_matches_one_process_at_full_width(ranks, one_process):
    _, results = ranks
    for (_, got), (_, want) in zip(results[0]["lr"], one_process["lr"]):
        assert got["best"] == want["best"]
        for point, want_point in zip(got["points"], want["points"]):
            assert point["accuracy"] == want_point["accuracy"]
            assert abs(point["weighted_f1"] - want_point["weighted_f1"]) <= 1e-6
        for params, want_params in zip(got["params"], want["params"]):
            np.testing.assert_array_equal(params["mean"], want_params["mean"])
            np.testing.assert_array_equal(params["scale"], want_params["scale"])
            assert_close_to_scale(params["w"], want_params["w"], 1e-4)
            assert_close_to_scale(params["b"], want_params["b"], 1e-4)


@pytest.mark.parametrize("kind", ["lr", "dt"])
def test_both_kinds_match_the_reference_over_its_mesh(ranks, reference, kind):
    _, results = ranks
    for (_, got), (_, want) in zip(results[0][kind], reference[kind]):
        assert got["best"] == want["best"]
        for point, want_point in zip(got["points"], want["points"]):
            assert point["grid"] == want_point["grid"]
            assert point["accuracy"] == want_point["accuracy"]
            assert abs(point["weighted_f1"] - want_point["weighted_f1"]) <= 1e-6
        for params, want_params in zip(got["params"], want["params"]):
            if kind == "lr":
                assert_close_to_scale(params["w"], want_params["w"], 1e-4)
                assert_close_to_scale(params["b"], want_params["b"], 1e-4)
            else:
                np.testing.assert_array_equal(params["features_heap"], want_params["features_heap"])
                np.testing.assert_array_equal(params["thresholds_heap"], want_params["thresholds_heap"])
                np.testing.assert_allclose(params["leaf_probs"], want_params["leaf_probs"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("slots", [1, 5, 8, 9, 18, 100, 128])
def test_the_job_axis_pads_to_a_multiple_of_the_data_size(world, slots):
    mesh = rank_mesh(world, 0)
    padded = sweep._job_axis(slots, mesh)
    assert padded % world == 0 and padded >= sweep._job_axis(slots) >= slots
    assert padded - sweep._job_axis(slots) < world
    assert sweep._job_axis(slots, rank_mesh(1, 0)) == sweep._job_axis(slots)


def test_the_keys_carry_the_mesh_and_the_rows_pad_to_the_data_size(ranks):
    world, results = ranks
    for kind in ("lr", "dt"):
        for key in results[0][f"{kind}_keys"]:
            assert key[-1] == ("cpu", None, "mesh", world, 1)
            assert key[2] % world == 0 and key[2] >= child.ROWS
            assert key[3] % world == 0 and key[3] >= child.EVAL_ROWS
        assert all(result[f"{kind}_keys"] == results[0][f"{kind}_keys"] for result in results)


def test_a_member_poisoned_on_any_rank_fails_alone_on_every_rank(ranks):
    _, results = ranks
    for result in results:
        statuses = [status for status, _ in result["poisoned"]]
        assert statuses == ["ok", "error", "error"]
        assert all("non-finite" in value for status, value in result["poisoned"] if status == "error")
        assert result["poisoned"] == results[0]["poisoned"]


def test_run_sweep_over_ranks_writes_its_document_and_checkpoint_once(ranks):
    _, results = ranks
    assert results[0]["writes"] == {"insert_one": 2}
    assert results[0]["saved"] == ["sweep_lr.model", "sweep_dt.model"]
    for result in results[1:]:
        assert result["writes"] == {} and result["saved"] == []
    for kind in ("lr", "dt"):
        got = {key: value for key, value in results[0]["run_sweep"][kind].items() if key != "document"}
        document = results[0]["run_sweep"][kind]["document"]
        assert document["points"] == got["points"] and document["best"] == got["best"]
        assert document["model_checkpoint"] == got["model_checkpoint"]
        for result in results[1:]:
            assert result["run_sweep"][kind]["document"] is None
            assert {key: value for key, value in result["run_sweep"][kind].items() if key != "document"} == got
