"""K12's row-slab kernels: their C interface, wrappers and tiling, held on
the CPU.

The kernels (learningorchestra_tpu_torch/kernels/csrc/tsne.cu,
``lo_tsne_z_slab`` and ``lo_tsne_grad_slab``) build and run only on the
card, where chip_smoke.py holds them against their plain versions. Here:

- each ``lo_tsne_*`` entry point's parameters, parsed from tsne.cu, against
  the ctypes ``argtypes`` that ``kernels._bind_tsne`` gives it: the same
  count, and a pointer, an int or a float at each place (a mismatch would
  show on the card only as a wrong answer or a fault);
- the wrappers' argument checks: a bad slab, a P of the wrong shape, a
  tensor that is not float32, an embedding that is not (rows, 2);
- the wrappers' CUDA branch on ``meta`` tensors: the split
  (``ops/tsne._slab_split``, the C side's rule), the scratch they
  allocate and the arguments they pass; the constants both sides share;
- a float64 numpy model of the tiled kernels (row tiles against column
  ranges, each row's own column skipped, the blocks' partials added in the
  kernels' order) against the plain twins in float64;
- chip_smoke's edge-shape check on the CPU (its twins against themselves)
  and the slabs' recounted bounds.
"""

import re
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from learningorchestra_tpu_torch import kernels  # noqa: E402
from learningorchestra_tpu_torch.ops import tsne  # noqa: E402

with open(kernels.SOURCES["tsne"]) as _handle:
    SOURCE = _handle.read()

TILE = tsne.PAIR_TILE
H100_SMS = 132


# --------------------------------------------------------------------------
# The C interface against its ctypes binding
# --------------------------------------------------------------------------

def _declared_entries(source: str) -> dict:
    """``lo_tsne_*`` name -> its parameters' kinds ("pointer", "int",
    "float"), from the first declaration of each in the source."""
    entries = {}
    for name, parameters in re.findall(r"\bint\s+(lo_tsne_\w+)\s*\(([^)]*)\)", source):
        kinds = []
        for parameter in parameters.split(","):
            parameter = " ".join(parameter.split())
            if "*" in parameter:
                kinds.append("pointer")
            elif re.match(r"(const\s+)?int\b", parameter):
                kinds.append("int")
            elif re.match(r"(const\s+)?float\b", parameter):
                kinds.append("float")
            else:
                raise AssertionError(f"{name}: a parameter of no known kind: {parameter!r}")
        entries.setdefault(name, kinds)
    return entries


class _Library:
    """What ``_bind_tsne`` sets, recorded: an attribute a function."""

    def __init__(self):
        self.functions = {}

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return self.functions.setdefault(name, types.SimpleNamespace())


def _bound_entries() -> dict:
    library = _Library()
    kernels._bind_tsne(library)
    kinds = {kernels.ctypes.c_void_p: "pointer", kernels.ctypes.c_int: "int",
             kernels.ctypes.c_float: "float"}
    return {name: [kinds[argtype] for argtype in function.argtypes]
            for name, function in library.functions.items() if name.startswith("lo_tsne_")}


DECLARED = _declared_entries(SOURCE)


def test_every_entry_point_is_bound_and_no_other():
    assert set(_bound_entries()) == set(DECLARED)
    assert {"lo_tsne_z_slab", "lo_tsne_grad_slab"} <= set(DECLARED)


@pytest.mark.parametrize("entry", sorted(DECLARED))
def test_the_binding_matches_the_c_declaration(entry):
    assert _bound_entries()[entry] == DECLARED[entry]


def test_the_slab_entries_take_the_split():
    assert DECLARED["lo_tsne_z_slab"] == ["pointer"] * 3 + ["int"] * 5 + ["int", "pointer"]
    assert DECLARED["lo_tsne_grad_slab"] == (["pointer"] * 5 + ["int"] * 5 + ["float"]
                                            + ["int", "pointer"])


def test_every_declaration_of_an_entry_agrees():
    """A prototype ahead of a definition (``lo_tsne_affinities_slab``) says
    what the definition says."""
    found = re.findall(r"\bint\s+(lo_tsne_\w+)\s*\(([^)]*)\)", SOURCE)
    assert len(found) > len(DECLARED)
    for name, parameters in found:
        assert _declared_entries(f"int {name}({parameters})")[name] == DECLARED[name], name


# --------------------------------------------------------------------------
# The wrappers' argument checks
# --------------------------------------------------------------------------

N = 12


def _operands():
    rng = np.random.default_rng(0)
    Y = torch.from_numpy((rng.normal(size=(N, 2)) * 5.0).astype(np.float32))
    P = torch.from_numpy(rng.random((N, N), dtype=np.float32))
    return Y, P, torch.ones(1, dtype=torch.float32)


BAD_CALLS = {
    "z: first below 0": (lambda Y, P, Z: tsne.tsne_z_slab(Y, -1, 2), ValueError),
    "z: a negative slab": (lambda Y, P, Z: tsne.tsne_z_slab(Y, 0, -1), ValueError),
    "z: rows past the embedding": (lambda Y, P, Z: tsne.tsne_z_slab(Y, 3, N - 2), ValueError),
    "z: a float64 embedding": (lambda Y, P, Z: tsne.tsne_z_slab(Y.double(), 0, 2), TypeError),
    "z: three columns": (lambda Y, P, Z: tsne.tsne_z_slab(torch.zeros(N, 3), 0, 2), ValueError),
    "grad: first below 0": (lambda Y, P, Z: tsne.tsne_grad_slab(Y, P[:2], Z, -1, 1.0), ValueError),
    "grad: rows past the embedding": (
        lambda Y, P, Z: tsne.tsne_grad_slab(Y, P[:2].contiguous(), Z, N - 1, 1.0), ValueError),
    "grad: P one column short": (
        lambda Y, P, Z: tsne.tsne_grad_slab(Y, P[:2, 1:].contiguous(), Z, 0, 1.0), ValueError),
    "grad: P a vector": (lambda Y, P, Z: tsne.tsne_grad_slab(Y, P[0], Z, 0, 1.0), ValueError),
    "grad: P of three dimensions": (
        lambda Y, P, Z: tsne.tsne_grad_slab(Y, P[:2, None], Z, 0, 1.0), ValueError),
    "grad: Z of two entries": (
        lambda Y, P, Z: tsne.tsne_grad_slab(Y, P[:2], torch.ones(2), 0, 1.0), ValueError),
    "grad: a float64 Z": (lambda Y, P, Z: tsne.tsne_grad_slab(Y, P[:2], Z.double(), 0, 1.0), TypeError),
    "grad: a float64 P": (lambda Y, P, Z: tsne.tsne_grad_slab(Y, P[:2].double(), Z, 0, 1.0), TypeError),
    "grad: a float64 embedding": (
        lambda Y, P, Z: tsne.tsne_grad_slab(Y.double(), P[:2], Z, 0, 1.0), TypeError),
    "grad: a bfloat16 Z": (
        lambda Y, P, Z: tsne.tsne_grad_slab(Y, P[:2], Z.to(torch.bfloat16), 0, 1.0), TypeError),
}


@pytest.mark.parametrize("case", sorted(BAD_CALLS))
def test_the_wrappers_refuse_bad_arguments(case):
    call, error = BAD_CALLS[case]
    with pytest.raises(error):
        call(*_operands())


def test_an_empty_slab_gives_nothing_to_add():
    Y, P, Z = _operands()
    assert float(tsne.tsne_z_slab(Y, N, 0)) == 0.0
    assert tsne.tsne_grad_slab(Y, P[:0], Z, N, 1.0).shape == (0, 2)


# --------------------------------------------------------------------------
# The split and the wrappers' CUDA branch
# --------------------------------------------------------------------------

ROWS = (1, 2, 33, 127, 129, 132, 1_001, 5_000, 20_000)


def _slabs(n: int) -> list:
    return sorted({(first, stop - first) for ways in (1, 3, 4) for first, stop in chip_smoke._row_slabs(n, ways)})


@pytest.mark.parametrize("n", ROWS)
@pytest.mark.parametrize("kernel", ["z", "grad"])
def test_the_split_covers_the_columns_within_the_c_rule(n, kernel):
    step, blocks = ((tsne.SLAB_Z_STEP, tsne.SLAB_Z_BLOCKS) if kernel == "z"
                    else (tsne.SLAB_GRAD_STEP, tsne.SLAB_GRAD_BLOCKS))
    for first, slab in _slabs(n):
        span, splits = tsne._slab_split(n, slab, step, blocks)
        tiles = max(1, -(-slab // TILE))
        assert span % step == 0 and step <= span <= tsne.SLAB_MAX_SPAN
        assert splits == -(-n // span) and (splits - 1) * span < n <= splits * span
        # within the blocks a wave holds, unless the least or the largest span
        assert tiles * splits <= blocks or span in (step, tsne.SLAB_MAX_SPAN)
        # the least span that does
        if span > step and tiles * -(-n // (span - step)) <= blocks:
            raise AssertionError(f"a span of {span - step} also fits {blocks} blocks")


def test_the_landmark_slab_fills_the_card():
    """At 1,280 x 5,000 (the landmark fit's slab over four ranks): Z's 790
    blocks of 64 columns, six an SM; the gradient's 230 blocks of 224
    columns (seven chunks of P), two an SM."""
    assert tsne._slab_split(5_000, 1_280, tsne.SLAB_Z_STEP, tsne.SLAB_Z_BLOCKS) == (64, 79)
    assert tsne._slab_split(5_000, 1_280, tsne.SLAB_GRAD_STEP, tsne.SLAB_GRAD_BLOCKS) == (224, 23)
    assert 10 * 79 <= tsne.SLAB_Z_BLOCKS and 10 * 23 <= tsne.SLAB_GRAD_BLOCKS
    assert 10 * 79 > 4 * H100_SMS and 10 * 23 > H100_SMS


def test_the_c_side_states_the_same_constants():
    assert f"constexpr int kMaxSpan = {tsne.SLAB_MAX_SPAN};" in SOURCE
    assert f"constexpr int kChunk = {tsne.SLAB_GRAD_STEP};" in SOURCE
    assert f"constexpr int kTile = {TILE};" in SOURCE
    assert "constexpr int kPairThreads = 256;" in SOURCE and tsne.SLAB_Z_STEP == 256 // 32
    assert (f"__launch_bounds__(kPairThreads, {tsne.SLAB_Z_BLOCKS // H100_SMS})\n"
            "z_slab_tiles_kernel") in SOURCE
    assert (f"__launch_bounds__(kPairThreads, {tsne.SLAB_GRAD_BLOCKS // H100_SMS})\n"
            "grad_slab_tiles_kernel") in SOURCE
    assert "check_slab(n, first, slab, span, splits, kPairWarps)" in SOURCE
    assert "check_slab(n, first, slab, span, splits, kChunk)" in SOURCE
    # the replaced warp-a-row kernels are gone; no float atomics in the slabs
    assert "z_slab_kernel(" not in SOURCE and "grad_slab_kernel(" not in SOURCE
    assert "atomicAdd" not in SOURCE


@pytest.fixture
def recorded(monkeypatch):
    """The wrappers' CUDA branch on ``meta`` tensors: the launch recorded,
    not run, and every ``torch.empty`` the wrapper makes."""
    record = {"launches": [], "empty": []}
    monkeypatch.setattr(kernels, "check_operands", lambda *tensors: None)
    monkeypatch.setattr(kernels, "launch", lambda name, entry, *args: record["launches"].append(
        (name, entry, args)))
    monkeypatch.setattr(tsne, "_stream", lambda tensor: 0)
    real_empty = torch.empty

    def empty(*args, **kwargs):
        tensor = real_empty(*args, **kwargs)
        record["empty"].append((tuple(tensor.shape), tensor.dtype))
        return tensor

    monkeypatch.setattr(torch, "empty", empty)
    return record


@pytest.mark.parametrize("n, first, slab", [(5_000, 0, 1_280), (5_000, 3_840, 1_160), (1, 0, 1),
                                            (33, 14, 14), (20_000, 0, 5_000), (2, 1, 0), (129, 54, 54)])
def test_a_call_is_one_launch_with_its_split_and_scratch(recorded, n, first, slab):
    Y = torch.zeros((n, 2), dtype=torch.float32, device="meta")
    P = torch.zeros((slab, n), dtype=torch.float32, device="meta")
    Z = torch.zeros(1, dtype=torch.float32, device="meta")
    tiles = -(-slab // TILE)

    recorded["empty"].clear()
    total = tsne.tsne_z_slab(Y, first, slab)
    [(name, entry, args)] = recorded["launches"]
    assert (name, entry, len(args)) == ("tsne_z_slab", "lo_tsne_z_slab", len(DECLARED[entry]))
    span, splits = tsne._slab_split(n, slab, tsne.SLAB_Z_STEP, tsne.SLAB_Z_BLOCKS)
    assert args[3:8] == (n, first, slab, span, splits)
    assert recorded["empty"] == [((max(tiles * splits, 1),), torch.float64), ((1,), torch.float64)]
    assert total.shape == (1,) and total.dtype == torch.float64

    recorded["launches"].clear()
    recorded["empty"].clear()
    grad = tsne.tsne_grad_slab(Y, P, Z, first, 12.0)
    [(name, entry, args)] = recorded["launches"]
    assert (name, entry, len(args)) == ("tsne_grad_slab", "lo_tsne_grad_slab", len(DECLARED[entry]))
    span, splits = tsne._slab_split(n, slab, tsne.SLAB_GRAD_STEP, tsne.SLAB_GRAD_BLOCKS)
    assert args[5:11] == (n, first, slab, span, splits, 12.0)
    assert recorded["empty"] == [((splits, max(slab, 1), 3), torch.float64), ((slab, 2), torch.float32)]
    assert grad.shape == (slab, 2)


def test_on_the_cpu_nothing_launches(monkeypatch):
    def refuse(*args):
        raise AssertionError("a launch on the CPU")

    monkeypatch.setattr(kernels, "launch", refuse)
    Y, P, Z = _operands()
    tsne.tsne_z_slab(Y, 2, 5)
    tsne.tsne_grad_slab(Y, P[2:7].contiguous(), Z, 2, 1.0)


# --------------------------------------------------------------------------
# The tiled arithmetic, modelled in float64
# --------------------------------------------------------------------------

def _tile_blocks(n, first, slab, step, blocks):
    """The kernels' blocks in their slots' order: (range, row tile) ->
    the slab's rows and the range's columns."""
    span, splits = tsne._slab_split(n, slab, step, blocks)
    tiles = -(-slab // TILE)
    for s in range(splits):
        for t in range(tiles):
            yield s, t, np.arange(t * TILE, min(slab, (t + 1) * TILE)), np.arange(s * span, min(n, (s + 1) * span))


def _inverse(Y, norms, first, rows, columns):
    d = np.maximum(norms[first + rows, None] + norms[None, columns] - 2.0 * Y[first + rows] @ Y[columns].T, 0.0)
    inv = 1.0 / (1.0 + d)
    inv[(first + rows)[:, None] == columns[None, :]] = 0.0   # each row's own column
    return inv


def model_slab(Y, P_slab, Z, first, exaggeration):
    """float64 model of the tiled kernels: Z's one slot a block (slot s *
    tiles + t), added in slot order; the gradient's (splits, slab, 3)
    partials, each row's added in range order, then 4 (s y - t)."""
    n, slab = Y.shape[0], P_slab.shape[0]
    norms = (Y * Y).sum(axis=1)
    slots = {}
    for s, t, rows, columns in _tile_blocks(n, first, slab, tsne.SLAB_Z_STEP, tsne.SLAB_Z_BLOCKS):
        slots[s * -(-slab // TILE) + t] = _inverse(Y, norms, first, rows, columns).sum()
    z = sum(slots[k] for k in sorted(slots))
    splits = tsne._slab_split(n, slab, tsne.SLAB_GRAD_STEP, tsne.SLAB_GRAD_BLOCKS)[1]
    partials = np.zeros((splits, slab, 3))
    for s, _, rows, columns in _tile_blocks(n, first, slab, tsne.SLAB_GRAD_STEP, tsne.SLAB_GRAD_BLOCKS):
        inv = _inverse(Y, norms, first, rows, columns)
        q = np.maximum(inv / max(Z, 1e-12), 1e-12)
        W = (P_slab[rows][:, columns] * exaggeration - q) * inv
        partials[s, rows] = np.column_stack([W.sum(axis=1), W @ Y[columns]])
    sums = partials.sum(axis=0)
    return z, 4.0 * (sums[:, :1] * Y[first:first + slab] - sums[:, 1:])


@pytest.mark.parametrize("n", [1, 2, 33, 129, 300])
@pytest.mark.parametrize("ways", [1, 3, 4])
def test_the_tiles_give_the_twins_in_float64(n, ways):
    rng = np.random.default_rng(n + ways)
    Y = rng.normal(size=(n, 2)) * 5.0
    P = rng.random((n, n))
    P /= P.sum()
    Y64, P64 = torch.from_numpy(Y), torch.from_numpy(P)
    Z = sum(float(tsne._tsne_z_slab(Y64, first, stop - first)) for first, stop in chip_smoke._row_slabs(n, ways))
    for first, stop in chip_smoke._row_slabs(n, ways):
        z, grad = model_slab(Y, P[first:stop], Z, first, 12.0)
        twin_z = float(tsne._tsne_z_slab(Y64, first, stop - first))
        twin = tsne._tsne_grad_slab(Y64, P64[first:stop], torch.tensor([Z], dtype=torch.float64),
                                    first, 12.0).numpy()
        assert abs(z - twin_z) <= 1e-12 * max(twin_z, 1e-300)
        assert grad.shape == twin.shape
        if grad.size:
            assert np.abs(grad - twin).max() <= 1e-12 * max(np.abs(twin).max(), 1e-300)


# --------------------------------------------------------------------------
# chip_smoke's edge shapes and bounds
# --------------------------------------------------------------------------

def test_the_edge_check_runs_on_the_twins(monkeypatch):
    """chip_smoke's ``check_slab_edges`` with the card's tensors on the CPU:
    its wrappers take their twins, so every comparison is exact; it
    covers every edge shape, empty slabs and both paths for P."""
    monkeypatch.setattr(torch.Tensor, "cuda", lambda self, *args, **kwargs: self)
    edges = chip_smoke.check_slab_edges(torch)
    assert set(edges) == {f"{n}/{ways}" for n in chip_smoke.SLAB_EDGE_ROWS for ways in chip_smoke.SLAB_EDGE_WAYS}
    for key, edge in edges.items():
        n = int(key.split("/")[0])
        assert sum(edge["slabs"]) == n
        assert edge["z_rel_err"] == 0.0 and edge["grad_max_abs_err"] == 0.0
        assert edge["vector_path"] == (n % 4 == 0) and edge["misaligned_bit_equal"] == (True if n % 4 == 0 else None)
    assert 0 in edges["1/4"]["slabs"]
    assert any(n % 4 for n in chip_smoke.SLAB_EDGE_ROWS) and any(n % 4 == 0 for n in chip_smoke.SLAB_EDGE_ROWS)


def test_a_misaligned_copy_starts_four_bytes_into_its_buffer():
    P = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    copy = chip_smoke._misaligned(torch, P)
    assert torch.equal(copy, P) and copy.shape == P.shape and copy.is_contiguous()
    assert copy.storage_offset() == 1
    assert copy.data_ptr() - copy.untyped_storage().data_ptr() == 4


def test_the_slab_bounds_count_float64_at_its_own_rate():
    pairs = 1_280 * 4_999
    z_ms, z_by = chip_smoke._slab_bound("tsne_z_slab", 1_280, 5_000)
    assert z_by == "operations"
    assert z_ms == pytest.approx((pairs * chip_smoke.TSNE_INVERSE_INSTRUCTIONS / chip_smoke.PEAK_FP32_INSTRUCTIONS_PER_S
                                  + pairs / chip_smoke.PEAK_FP64_INSTRUCTIONS_PER_S) * 1e3)
    # the earlier count, every instruction at the float32 rate, was lower
    assert z_ms > pairs * (chip_smoke.TSNE_INVERSE_INSTRUCTIONS + 1) / chip_smoke.PEAK_FP32_INSTRUCTIONS_PER_S * 1e3
    assert chip_smoke.PEAK_FP64_INSTRUCTIONS_PER_S == chip_smoke.PEAK_FP32_INSTRUCTIONS_PER_S / 2
    grad_ms, grad_by = chip_smoke._slab_bound("tsne_grad_slab", 1_280, 5_000)
    assert grad_by == "bytes"
    assert grad_ms == pytest.approx((1_280 * 5_000 * 4 + 5_000 * 8 + 1_280 * 8 + 4) / chip_smoke.PEAK_BYTES_PER_S * 1e3)


def test_the_new_kernels_are_the_ones_the_profiler_reads():
    assert chip_smoke.FORM_KERNELS["tsne_z_slab"] == ("z_slab_tiles_kernel", "slab_total_kernel")
    assert chip_smoke.FORM_KERNELS["tsne_grad_slab"] == ("grad_slab_tiles_kernel", "gradient_finish_kernel")
    for names in (chip_smoke.FORM_KERNELS["tsne_z_slab"], chip_smoke.FORM_KERNELS["tsne_grad_slab"]):
        for name in names:
            assert re.search(rf"\b{name}\(", SOURCE)
