"""K7's class-shard kernels as redesigned: their C interface, geometry and
arithmetic, held on the CPU.

The kernels (learningorchestra_tpu_torch/kernels/csrc/logistic.cu,
``lo_logistic_shard_stats`` and ``lo_logistic_shard_grad``) build and run
only on the card, where chip_smoke.py holds them against their plain
twins and logistic_shard_variants.py against the forms they replaced.
Here:

- each ``lo_logistic_*`` entry point's parameters, parsed from logistic.cu,
  against the ctypes ``argtypes`` that ``kernels._bind_logistic`` gives it,
  and ``ShardLayout``'s fields against ``ml/logistic._ShardLayout``'s;
- the constants both sides state (threads, group rows, register classes,
  rows a stats thread, a grad item's classes, the sum forms, the owners'
  cells, a block's shared memory);
- the wrappers' CUDA branch on ``meta`` tensors: one launch each, its
  arguments, its layout (the geometry's), the grad's chunks and scratch;
- the geometry: at the edge shapes every layout within a block's shared
  memory, the parameters in shared memory exactly where they fit their
  share, x staged exactly where a tile of it fits the block's share, the
  narrow grad form exactly where its cells and group sums fit;
- a float64 numpy model of the grad's order (each cell's 16-row groups
  from the chunk's start, each from 0, the groups in order, then the
  chunks in order) against ``_shard_grad`` in float64;
- chip_smoke's edge-shape check on the CPU (its wrappers take the twins,
  so every comparison is exact) and the paths it covers.
"""

import ctypes
import re
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from learningorchestra_tpu_torch import kernels  # noqa: E402
from learningorchestra_tpu_torch.ml import logistic  # noqa: E402

with open(kernels.SOURCES["logistic"]) as _handle:
    SOURCE = _handle.read()

EDGE_SHAPES = [(F, Cs) for F in chip_smoke.SHARD_EDGE_FEATURES for Cs in chip_smoke.SHARD_EDGE_CLASSES]


# --------------------------------------------------------------------------
# The C interface against its ctypes binding
# --------------------------------------------------------------------------

def _declared_entries(source: str) -> dict:
    """``lo_logistic_*`` name -> its parameters' kinds ("pointer", "int",
    "longlong"), from its declaration in the source."""
    entries = {}
    for name, parameters in re.findall(r"\bint\s+(lo_logistic_\w+)\s*\(([^)]*)\)", source):
        kinds = []
        for parameter in parameters.split(","):
            parameter = " ".join(parameter.split())
            if "*" in parameter:
                kinds.append("pointer")
            elif re.match(r"(const\s+)?long long\b", parameter):
                kinds.append("longlong")
            elif re.match(r"(const\s+)?int\b", parameter):
                kinds.append("int")
            else:
                raise AssertionError(f"{name}: a parameter of no known kind: {parameter!r}")
        entries.setdefault(name, kinds)
    return entries


class _Library:
    """What ``_bind_logistic`` sets, recorded: an attribute a function."""

    def __init__(self):
        self.functions = {}

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return self.functions.setdefault(name, types.SimpleNamespace())


def _bound_entries() -> dict:
    library = _Library()
    kernels._bind_logistic(library)
    kinds = {ctypes.c_void_p: "pointer", ctypes.c_int: "int", ctypes.c_longlong: "longlong"}
    return {name: [kinds[argtype] for argtype in function.argtypes]
            for name, function in library.functions.items() if name.startswith("lo_logistic_")}


DECLARED = _declared_entries(SOURCE)


def test_every_entry_point_is_bound_and_no_other():
    assert set(_bound_entries()) == set(DECLARED)
    assert {"lo_logistic_shard_stats", "lo_logistic_shard_grad"} <= set(DECLARED)


@pytest.mark.parametrize("entry", sorted(DECLARED))
def test_the_binding_matches_the_c_declaration(entry):
    assert _bound_entries()[entry] == DECLARED[entry]


def test_the_shard_entries_take_their_layout_last():
    assert DECLARED["lo_logistic_shard_stats"] == (
        ["pointer", "int"] + ["pointer"] * 4 + ["int"] * 7 + ["pointer", "pointer"])
    assert DECLARED["lo_logistic_shard_grad"] == (
        ["pointer", "int"] + ["pointer"] * 7 + ["int"] * 8 + ["pointer", "pointer"])


def test_the_layout_struct_is_the_c_struct_field_for_field():
    body = re.search(r"struct ShardLayout \{([^}]*)\};", SOURCE).group(1)
    fields = [name.strip() for line in body.split(";") if line.strip()
              for name in line.replace("int ", "", 1).split(",")]
    assert fields == [name for name, _ in logistic._ShardLayout._fields_]
    assert all(kind is ctypes.c_int for _, kind in logistic._ShardLayout._fields_)


def test_the_c_side_states_the_same_constants():
    assert f"constexpr int kThreads = {logistic._THREADS};" in SOURCE
    assert f"constexpr int kGroupRows = {logistic._GROUP_ROWS};" in SOURCE
    assert "constexpr int kRegisterClasses = 16;" in SOURCE
    assert f"constexpr int kStatsRows = {logistic._STATS_ROWS};" in SOURCE
    assert f"constexpr int kGradClasses = {logistic._GRAD_CLASSES};" in SOURCE
    assert (f"constexpr int kShardNarrow = {logistic._SHARD_NARROW}, "
            f"kShardSerial = {logistic._SHARD_SERIAL};") in SOURCE
    assert f"constexpr int kMaxOwned = {logistic._MAX_OWNED};" in SOURCE
    assert f"constexpr int kMaxSharedBytes = {kernels.SHARED_BYTES};" in SOURCE
    assert logistic._STATS_TILES[0] == logistic._THREADS * logistic._STATS_ROWS
    assert logistic._GRAD_TILES[0] == logistic._THREADS
    assert f"constexpr int kGradStages = {logistic._GRAD_STAGES};" in SOURCE
    assert all(tile % 32 == 0 for tile in logistic._STATS_TILES)
    assert all(tile % logistic._GROUP_ROWS == 0 for tile in logistic._GRAD_TILES)
    # the first form's kernels are gone; the profiler reads the new ones
    assert "shard_stats_kernel(" not in SOURCE and "shard_grad_kernel(" not in SOURCE
    assert "stage_rows(" not in SOURCE and "pick_shard_grad_layout" not in SOURCE
    for name in ("shard_stats_tiles_kernel", "shard_grad_tiles_kernel", "sums_kernel"):
        assert re.search(rf"\b{name}\(", SOURCE)
    assert chip_smoke.SHARD_KERNELS == {
        "logistic_shard_stats": ("shard_stats_tiles_kernel",),
        "logistic_shard_grad": ("shard_grad_tiles_kernel", "sums_kernel"),
    }
    assert "atomicAdd" not in SOURCE


# --------------------------------------------------------------------------
# The wrappers' CUDA branch
# --------------------------------------------------------------------------

@pytest.fixture
def recorded(monkeypatch):
    """The wrappers' CUDA branch on ``meta`` tensors: the launch recorded,
    not run, and every ``torch.empty`` the wrapper makes."""
    record = {"launches": [], "empty": []}
    monkeypatch.setattr(kernels, "check_operands", lambda *tensors: None)
    monkeypatch.setattr(kernels, "launch", lambda name, entry, *args: record["launches"].append(
        (name, entry, args)))
    monkeypatch.setattr(kernels, "max_blocks", lambda index: 1056)
    monkeypatch.setattr(logistic, "_stream", lambda tensor: 0)
    real_empty = torch.empty

    def empty(*args, **kwargs):
        tensor = real_empty(*args, **kwargs)
        record["empty"].append((tuple(tensor.shape), tensor.dtype))
        return tensor

    monkeypatch.setattr(torch, "empty", empty)
    return record


def _fields(address: int) -> dict:
    layout = logistic._ShardLayout.from_address(address)
    return {name: getattr(layout, name) for name, _ in logistic._ShardLayout._fields_}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows, F, Cs, points", [
    (524_288, 16, 5, 4), (524_288, 16, 1, 1), (4_097, 444, 33, 4), (257, 2_000, 3, 1),
    (1, 1, 17, 4), (0, 5, 3, 1),
])
def test_a_call_is_one_launch_with_its_layout_and_scratch(recorded, dtype, rows, F, Cs, points):
    X = torch.zeros((rows, F), dtype=dtype, device="meta")
    y = torch.zeros(rows, dtype=torch.int32, device="meta")
    W = torch.zeros((points, F, Cs), device="meta")
    b = torch.zeros((points, Cs), device="meta")
    x_bytes = X.element_size()

    recorded["empty"].clear()
    stats = logistic.shard_stats(W, b, X, y, 3)
    [(name, entry, args)] = recorded["launches"]
    assert (name, entry, len(args)) == ("logistic_shard_stats", "lo_logistic_shard_stats",
                                        len(DECLARED[entry]))
    assert args[1] == int(dtype == torch.bfloat16) and args[6:11] == (rows, F, Cs, points, 3)
    tile, staged, shared = logistic._shard_stats_geometry(F, Cs, points, x_bytes)
    assert _fields(args[-1]) == logistic._shard_layout(F, Cs, points, tile, staged, shared, x_bytes, False)
    assert recorded["empty"] == [((points, rows, 3), torch.float32)]
    assert stats.shape == (points, rows, 3)

    recorded["launches"].clear()
    w = torch.zeros(rows, device="meta")
    lse = torch.zeros(rows, dtype=torch.float64, device="meta")
    recorded["empty"].clear()
    sums = logistic.shard_grad(W[0], b[0], X, y, w, lse, 3)
    [(name, entry, args)] = recorded["launches"]
    assert (name, entry, len(args)) == ("logistic_shard_grad", "lo_logistic_shard_grad",
                                        len(DECLARED[entry]))
    chunks, per_chunk = kernels.row_chunks(rows)
    assert args[9:15] == (rows, F, Cs, 3, chunks, per_chunk)
    tile, staged, shared, form = logistic._shard_grad_geometry(F, Cs, x_bytes)
    assert _fields(args[-1]) == logistic._shard_layout(F, Cs, 1, tile, staged, shared, x_bytes, True, form)
    cells = F * Cs + Cs + 2
    assert recorded["empty"] == [((max(chunks, 1), cells), torch.float64), ((cells,), torch.float64)]
    assert sums.shape == (cells,)


def test_on_the_cpu_nothing_launches(monkeypatch):
    def refuse(*args):
        raise AssertionError("a launch on the CPU")

    monkeypatch.setattr(kernels, "launch", refuse)
    rng = np.random.default_rng(1)
    X = torch.from_numpy(rng.normal(size=(40, 5)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 6, 40).astype(np.int32))
    W = torch.from_numpy(rng.normal(size=(4, 5, 3)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32))
    stats = logistic.shard_stats(W, b, X, y, 2)
    logistic.shard_grad(W[0], b[0], X, y, torch.ones(40), logistic._shard_log_sums(stats[0]), 2)


# --------------------------------------------------------------------------
# The geometry
# --------------------------------------------------------------------------

def _staged_fits(F, Cs, points, x_bytes, grad, shared, form=logistic._SHARD_NARROW) -> bool:
    tiles = logistic._GRAD_TILES if grad else logistic._STATS_TILES
    return logistic._shard_layout(F, Cs, points, tiles[-1], True, shared, x_bytes, grad, form)["bytes"] \
        <= logistic._SHARD_BLOCK_BYTES


@pytest.mark.parametrize("x_bytes", [4, 2])
@pytest.mark.parametrize("points", [1, 4])
@pytest.mark.parametrize("F, Cs", EDGE_SHAPES)
def test_the_stats_geometry_at_the_edge_shapes(F, Cs, points, x_bytes):
    tile, staged, shared = logistic._shard_stats_geometry(F, Cs, points, x_bytes)
    layout = logistic._shard_layout(F, Cs, points, tile, staged, shared, x_bytes, False)
    assert layout["bytes"] <= logistic._SHARD_BLOCK_BYTES <= kernels.SHARED_BYTES
    ws = -(-Cs // 4) * 4
    params = 4 * points * (F * ws + ws)
    assert shared == (params <= logistic._SHARD_PARAMS_BYTES)
    assert layout["ws"] == (ws if shared else 0)
    if shared:
        assert layout["params_b"] - layout["params_w"] >= 4 * points * F * ws
    # rows from global memory exactly where no staged tile fits
    assert staged == _staged_fits(F, Cs, points, x_bytes, False, shared)
    assert layout["xs"] == ((F | 1) if staged else 0)
    # the largest staged tile that fits
    if staged and tile != logistic._STATS_TILES[0]:
        assert logistic._shard_layout(F, Cs, points, 2 * tile, True, shared, x_bytes, False)["bytes"] \
            > logistic._SHARD_BLOCK_BYTES
    assert tile in logistic._STATS_TILES and layout["stage_floats"] == 3 * tile + 4
    offsets = [layout[name] for name in ("params_w", "params_b", "raw", "x", "ring", "stage")]
    assert offsets == sorted(offsets) and all(offset % 16 == 0 for offset in offsets)


@pytest.mark.parametrize("x_bytes", [4, 2])
@pytest.mark.parametrize("F, Cs", EDGE_SHAPES)
def test_the_grad_geometry_at_the_edge_shapes(F, Cs, x_bytes):
    tile, staged, shared, form = logistic._shard_grad_geometry(F, Cs, x_bytes)
    layout = logistic._shard_layout(F, Cs, 1, tile, staged, shared, x_bytes, True, form)
    assert layout["bytes"] <= logistic._SHARD_BLOCK_BYTES
    cells = F * Cs + Cs + 2
    narrow_fits = cells <= logistic._MAX_OWNED * logistic._THREADS and any(
        _staged_fits(F, Cs, 1, x_bytes, True, shared, logistic._SHARD_NARROW) for _ in (0,))
    if staged:
        assert (form == logistic._SHARD_NARROW) == narrow_fits
    # the narrow form has no kernel with its parameters in global memory
    assert shared or form == logistic._SHARD_SERIAL
    assert staged == (narrow_fits or _staged_fits(F, Cs, 1, x_bytes, True, shared, logistic._SHARD_SERIAL))
    assert layout["sums"] + (8 * 2 * (tile // 16) * cells if form == logistic._SHARD_NARROW else 0) \
        <= layout["bytes"]
    assert layout["tp"] >= tile and layout["buffer"] == 16 * tile


@pytest.mark.parametrize("Cs, x_bytes, grad_tile", [(1, 4, 256), (1, 2, 256), (5, 4, 224), (5, 2, 256)])
def test_run_d_takes_the_fast_paths(Cs, x_bytes, grad_tile):
    """At run d's block (16 features, one or five classes a shard, float32
    or bfloat16): the stats stage 512-row tiles, the grad the largest tile
    whose ring of three fits (224 rows at five float32 classes), in the
    narrow form, both with the parameters in shared memory, two blocks an
    SM."""
    assert logistic._shard_stats_geometry(16, Cs, 4, x_bytes) == (512, True, True)
    assert logistic._shard_stats_geometry(16, Cs, 1, x_bytes) == (512, True, True)
    assert logistic._shard_grad_geometry(16, Cs, x_bytes) == (grad_tile, True, True, logistic._SHARD_NARROW)
    for grad, tile in ((False, 512), (True, grad_tile)):
        layout = logistic._shard_layout(16, Cs, 4, tile, True, True, x_bytes, grad)
        assert 2 * (layout["bytes"] + 1024) <= 228 * 1024


@pytest.mark.parametrize("F", [1, 2, 16, 444, 1_278])
def test_the_narrow_forms_cells_always_keep_their_parameters_in_shared_memory(F):
    """Up to the owners' 1,280 cells (F * Cs + Cs + 2), a grad block's
    parameters fit their share at every F, so the narrow form needs no
    kernel that reads them from global memory."""
    owned = logistic._MAX_OWNED * logistic._THREADS
    for Cs in range(1, owned):
        if logistic._shard_cells(F, Cs) > owned:
            break
        assert logistic._params_shared(F, Cs, 1)


def test_a_narrow_item_covers_every_cell_once():
    """The narrow form's items of a group (grad_items): (f, class block) for
    every feature, (F, class block) for db, one for the nll and the weights:
    every cell of the group once."""
    for F, Cs in EDGE_SHAPES:
        blocks = -(-Cs // logistic._GRAD_CLASSES)
        cells = []
        for j in range((F + 1) * blocks + 1):
            if j == (F + 1) * blocks:
                cells += [F * Cs + Cs, F * Cs + Cs + 1]
                continue
            f, c0 = j // blocks, (j % blocks) * logistic._GRAD_CLASSES
            base = f * Cs if f < F else F * Cs
            cells += [base + c for c in range(c0, min(Cs, c0 + logistic._GRAD_CLASSES))]
        assert sorted(cells) == list(range(F * Cs + Cs + 2))


# --------------------------------------------------------------------------
# The grad's order, modelled in float64
# --------------------------------------------------------------------------

def model_shard_grad(X, y, w, lse, W, b, first):
    """float64 model of lo_logistic_shard_grad: each row's residuals from
    its float32 logits, then each cell's sum over a chunk (kernels.row_chunks)
    as the sum of its 16-row groups from the chunk's start, each from 0 in
    row order, added in group order; the chunks added in chunk order."""
    rows, F = X.shape
    Cs = W.shape[1]
    z = (X.astype(np.float64) @ W.astype(np.float64)).astype(np.float32) + b
    local = y.astype(np.int64) - first
    inside = (local >= 0) & (local < Cs)
    onehot = np.zeros((rows, Cs))
    onehot[np.arange(rows)[inside], local[inside]] = 1.0
    residual = (np.exp(z.astype(np.float64) - lse[:, None]) - onehot) * w[:, None]
    at_label = np.where(inside, z[np.arange(rows), np.clip(local, 0, Cs - 1)], 0.0)
    nll = np.where(inside, (lse - at_label) * w, 0.0)
    # each row's terms of every cell: x_f r_c (f-major), r_c, the nll, w
    terms = np.concatenate([(X.astype(np.float64)[:, :, None] * residual[:, None, :]).reshape(rows, F * Cs),
                            residual, nll[:, None], w[:, None].astype(np.float64)], axis=1)
    chunks, per_chunk = kernels.row_chunks(rows)
    total = np.zeros(terms.shape[1])
    for chunk in range(chunks):
        begin, end = chunk * per_chunk, min(rows, (chunk + 1) * per_chunk)
        chunk_sum = np.zeros(terms.shape[1])
        for group in range(begin, end, 16):
            group_sum = np.zeros(terms.shape[1])
            for row in range(group, min(end, group + 16)):
                group_sum = group_sum + terms[row]
            chunk_sum = chunk_sum + group_sum
        total = total + chunk_sum
    return total


@pytest.mark.parametrize("rows, F, Cs", [(0, 3, 2), (1, 1, 1), (17, 5, 3), (2_100, 16, 5), (3_000, 7, 17)])
def test_the_groups_give_the_twin_in_float64(rows, F, Cs):
    rng = np.random.default_rng(rows + F + Cs)
    X = rng.normal(size=(rows, F)).astype(np.float32)
    y = rng.integers(0, 2 * Cs + 1, rows).astype(np.int32)
    w = (rng.random(rows) < 0.8).astype(np.float32)
    W = (rng.normal(size=(F, Cs)) * 0.5).astype(np.float32)
    b = rng.normal(size=Cs).astype(np.float32)
    lse = rng.normal(size=rows) + 2.0
    first = Cs // 2
    model = model_shard_grad(X, y, w, lse, W, b, first)
    twin = logistic._shard_grad(torch.from_numpy(W), torch.from_numpy(b), torch.from_numpy(X),
                                torch.from_numpy(y), torch.from_numpy(w), torch.from_numpy(lse), first).numpy()
    assert model.shape == twin.shape == (F * Cs + Cs + 2,)
    assert np.abs(model - twin).max() <= 1e-12 * max(np.abs(twin).max(), 1.0)
    assert model[-1] == w.sum(dtype=np.float64)
    if rows > kernels.MIN_CHUNK_ROWS:
        assert kernels.row_chunks(rows)[0] > 1


# --------------------------------------------------------------------------
# chip_smoke's edge shapes
# --------------------------------------------------------------------------

def test_the_edge_check_runs_on_the_twins(monkeypatch):
    """chip_smoke's ``check_shard_edges`` with the card's tensors on the
    CPU: its wrappers take their twins, so every comparison is exact; it
    covers every edge shape and, on the card, every path of both kernels:
    rows staged and from global memory, parameters in shared and global
    memory, both grad forms."""
    monkeypatch.setattr(torch.Tensor, "cuda", lambda self, *args, **kwargs: self)
    edges = chip_smoke.check_shard_edges(torch)
    assert edges["shapes"] == (len(chip_smoke.SHARD_EDGE_ROWS) * len(chip_smoke.SHARD_EDGE_FEATURES)
                               * len(chip_smoke.SHARD_EDGE_CLASSES) * 2)
    for key in ("stats_logit_rel", "stats_sum_rel", "grad_err", "nll_rel"):
        assert edges[key] == 0.0
    stats, grad = edges["stats_geometries"], edges["grad_geometries"]
    assert {staged for _, staged, _ in stats} == {True, False}
    assert {shared for _, _, shared in stats} == {True, False}
    assert {staged for _, staged, _, _ in grad} == {True, False}
    assert {shared for _, _, shared, _ in grad} == {True, False}
    assert {form for _, _, _, form in grad} == {logistic._SHARD_NARROW, logistic._SHARD_SERIAL}
    assert 0 in chip_smoke.SHARD_EDGE_ROWS and 4_097 in chip_smoke.SHARD_EDGE_ROWS
    assert max(chip_smoke.SHARD_EDGE_CLASSES) > 16 and min(chip_smoke.SHARD_EDGE_CLASSES) == 1


def test_a_misaligned_copy_of_either_type_starts_four_bytes_in():
    for dtype in (torch.float32, torch.bfloat16):
        X = torch.arange(12, dtype=torch.float32).reshape(3, 4).to(dtype)
        copy = chip_smoke._misaligned(torch, X)
        assert torch.equal(copy, X) and copy.shape == X.shape and copy.is_contiguous()
        assert (copy.data_ptr() - copy.untyped_storage().data_ptr()) == 4


def test_the_held_checks_refuse_what_is_off():
    rng = np.random.default_rng(2)
    X = torch.from_numpy(rng.normal(size=(30, 4)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 5, 30).astype(np.int32))
    W = torch.from_numpy(rng.normal(size=(1, 4, 2)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(1, 2)).astype(np.float32))
    want = logistic._shard_stats(W, b, X, y, 1)
    assert chip_smoke._held_shard_stats("same", want, want, X, W, b) == (0.0, 0.0)
    off = want.clone()
    off[0, 3, 1] *= 1.0 + 1e-5
    with pytest.raises(AssertionError):
        chip_smoke._held_shard_stats("off", off, want, X, W, b)
    w = torch.ones(30)
    lse = logistic._shard_log_sums(want[0])
    grad = logistic._shard_grad(W[0], b[0], X, y, w, lse, 1)
    assert chip_smoke._held_shard_grad("same", grad, grad, 30) == (0.0, 0.0)
    for index, factor in ((0, 1.0 + 1e-3), (-2, 1.0 + 1e-5), (-1, 2.0)):
        off = grad.clone()
        off[index] = off[index] * factor + (1e-3 if index == 0 else 0.0)
        with pytest.raises(AssertionError):
            chip_smoke._held_shard_grad("off", off, grad, 30)
