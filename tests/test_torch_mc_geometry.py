"""The Monte-Carlo kernel's launch geometry and leaf test (csrc/mc_eval.cu),
on the CPU.

``envelope.mc_geometry`` mirrors the kernel's ``geometry_of``; the walk
below is the kernel's loops written out (blocks over chunks of M and over
(p, s) with the grid's y stride, threads over channels and row lanes,
rows a batch at a time), and every (p, s, m, c) of the output must be written
exactly once. The built library's own numbers are held against
``mc_geometry`` on the card by chip_smoke.py. The kernel tests a leaf
[lb, ub) on integer order keys; ``leaf_live`` is that test in numpy, held
against the float compares of the plain version.
"""
import re
from pathlib import Path

import numpy as np
import pytest

from repro_torch.kernels import envelope

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "kernels" / "csrc" / "mc_eval.cu")


def kernel_writes(g: envelope.McGeometry, ps_total: int, m: int, c: int):
    """How often the kernel writes each (p*s, m, c), as an outer product
    of the (p, s) loop's counts and the (m, c) counts of one (p, s)."""
    rows = np.zeros((m, c), np.int64)
    for by in range(g.grid_y):
        for chunk in range(by, g.chunks, g.grid_y):
            first = chunk * g.chunk_rows
            end = min(m, first + g.chunk_rows)
            for t in range(g.threads):
                lane = t // c
                if lane >= g.row_lanes:
                    continue
                for ch in range(t % c, c, g.threads):
                    row0 = first + lane
                    # batches of MC_BATCH rows from row0, R apart, each
                    # row written where it is < end
                    step = envelope.MC_BATCH * g.row_lanes
                    for i in range(envelope.MC_BATCH):
                        rows[row0 + i * g.row_lanes:end:step, ch] += 1
    per_ps = np.zeros(ps_total, np.int64)
    for bx in range(g.grid_x):
        per_ps[bx::g.grid_x] += 1
    return per_ps, rows


CASES = ([(16, 32, m, c, n) for c in (3, 21, 200) for n in (2, 16, 64, 128)
          for m in (257, 1000)]
         + [(1, 32, 636, 21, 16), (6, 32, 636, 21, 16), (64, 32, 8192, 21, 16),
            (1, 1, 1, 21, 16), (2100, 32, 16, 3, 16), (2, 3, 300, 200, 64),
            (3, 8, 999, 21, 2), (4, 2, 257, 256, 4), (5, 3, 257, 300, 2),
            (2, 2, 1000, 1000, 8), (1, 4, 33, 7000, 2)])


@pytest.mark.parametrize("p,s,m,c,n", CASES)
def test_every_output_is_written_once(p, s, m, c, n):
    g = envelope.mc_geometry(p, s, m, c, n)
    per_ps, rows = kernel_writes(g, p * s, m, c)
    assert (per_ps == 1).all() and (rows == 1).all()
    assert g.chunk_rows % (g.row_lanes * envelope.MC_BATCH) == 0
    assert g.row_lanes * min(c, g.threads) <= g.threads
    assert 1 <= g.grid_y <= envelope.MAX_DESIGNS
    assert 1 <= g.grid_x <= envelope.MC_MAX_GRID_X
    assert g.chunks * g.chunk_rows >= m > (g.chunks - 1) * g.chunk_rows
    # a chunk's x fits MC_CHUNK_BYTES unless one batch is larger
    assert (4 * c * g.chunk_rows <= envelope.MC_CHUNK_BYTES
            or g.chunk_rows == g.row_lanes * envelope.MC_BATCH)
    assert g.leaves == (n if n in envelope.MC_REGISTER_LEAVES else 0)
    assert g.smem_bytes == envelope.mc_smem_bytes(c, n)


def test_paths_shapes_fill_the_card():
    """The search shape, evaluate_robustness's, the single-design call
    and the wide call: two blocks per SM of an H100 at least, and as many
    row lanes of cardio's 21 channels as the threads hold."""
    for p, s, m in ((16, 32, 636), (6, 32, 636), (1, 32, 636),
                    (64, 32, 8192)):
        g = envelope.mc_geometry(p, s, m, 21, 16)
        assert g.row_lanes == envelope.MC_THREADS // 21
        assert g.grid_x * g.grid_y >= min(envelope.MC_MIN_BLOCKS, p * s * 7)


def test_source_constants_match_the_mirror():
    text = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"{name} = (\d+);", text).group(1))

    assert const("kThreads") == envelope.MC_THREADS
    assert const("kBatch") == envelope.MC_BATCH
    assert const("kChunkBytes") == envelope.MC_CHUNK_BYTES
    assert const("kMinBlocks") == envelope.MC_MIN_BLOCKS
    assert const("kMaxGridX") == envelope.MC_MAX_GRID_X
    unrolled = re.search(r"const bool unrolled = ([^;]+);", text).group(1)
    assert tuple(int(v) for v in re.findall(r"n == (\d+)", unrolled)) == \
        envelope.MC_REGISTER_LEAVES
    cases = tuple(int(v) for v in re.findall(r"case (\d+): return launch",
                                             text))
    assert cases == envelope.MC_REGISTER_LEAVES


def test_envelope_only_widens():
    """Every (C, 2^N) the shared-memory-only kernel took (4 * (3 C 2^N +
    2 C) bytes within the limit) is still taken."""
    for n in (1, 2, 3, 4, 8, 16, 32, 64, 128, 256, 512):
        for c in range(1, 10_000, 7):
            before = 4 * (3 * c * n + 2 * c) <= envelope.SMEM_MAX_BYTES
            if before:
                assert envelope.outside_mc_envelope(c, n) is None, (c, n)
    assert envelope.outside_mc_envelope(8, 128) is None
    assert envelope.outside_mc_envelope(19_000, 1) is None


def order_key(f: np.ndarray) -> np.ndarray:
    """csrc/mc_eval.cu's ``order_key``: -0.0 made +0.0, then the bits
    with the magnitude flipped where the sign is set, as int64."""
    with np.errstate(invalid="ignore"):
        b = (f.astype(np.float32) + np.float32(0.0)).view(np.int32)
    b = b.astype(np.int64)
    return np.where(b < 0, b ^ 0x7FFFFFFF, b)


def leaf_live(u, lb, ub):
    """The kernel's leaf test: (unsigned)(key(u) - key(lb)) < width."""
    key = order_key(lb)
    with np.errstate(invalid="ignore"):
        width = np.where(lb < ub, (order_key(ub) - key) % 2 ** 32, 0)
    return (order_key(u) - key) % 2 ** 32 < width


def test_order_key_leaf_test_is_the_float_compare():
    rng = np.random.default_rng(5)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0,
                        1e-45, -1e-45, 1.17e-38, -3.4e38, 3.4e38],
                       np.float32)
    neg_nan = np.array([0xFFC00000, 0xFF800001], np.uint32).view(np.float32)
    pool = np.concatenate([special, neg_nan,
                           rng.normal(0, 4, 200).astype(np.float32),
                           rng.integers(-3, 4, 50).astype(np.float32)])
    u, lb, ub = np.meshgrid(pool, pool, pool, indexing="ij")
    with np.errstate(invalid="ignore"):
        want = (u >= lb) & (u < ub)
        got = leaf_live(u, lb, ub)
    assert want.any() and (got == want).all()


# The tile knob (``block_m``): a chunk of block_m rows, a whole number of
# row lanes x MC_BATCH; the walk above must cover every output once at
# any such tile, a tile off that grid raises naming its limit, and no
# tile is the launch the kernel had before the knob.
TILE_CASES = [(p, s, m, c, n, k) for p, s, m, c, n in
              ((16, 32, 636, 21, 16), (1, 32, 636, 21, 16),
               (3, 8, 999, 21, 2), (5, 3, 257, 300, 2), (2, 3, 300, 200, 64),
               (1, 1, 1, 21, 16), (2, 2, 1000, 1000, 8))
              for k in (1, 2, 3, 7, 1000)]


@pytest.mark.parametrize("p,s,m,c,n,k", TILE_CASES)
def test_tile_writes_every_output_once(p, s, m, c, n, k):
    unit = envelope.mc_row_lanes(c) * envelope.MC_BATCH
    g = envelope.mc_geometry(p, s, m, c, n, k * unit)
    assert g.chunk_rows == k * unit
    per_ps, rows = kernel_writes(g, p * s, m, c)
    assert (per_ps == 1).all() and (rows == 1).all()
    assert g.chunks * g.chunk_rows >= m > (g.chunks - 1) * g.chunk_rows
    assert 1 <= g.grid_y <= envelope.MAX_DESIGNS
    heuristic = envelope.mc_geometry(p, s, m, c, n)
    assert (g.row_lanes, g.grid_x, g.leaves, g.smem_bytes) == (
        heuristic.row_lanes, heuristic.grid_x, heuristic.leaves,
        heuristic.smem_bytes)


@pytest.mark.parametrize("p,s,m,c,n", CASES)
def test_heuristic_tile_is_the_heuristic(p, s, m, c, n):
    g = envelope.mc_geometry(p, s, m, c, n)
    assert envelope.mc_geometry(p, s, m, c, n, g.chunk_rows) == g
    assert envelope.mc_geometry(p, s, m, c, n, 0) == g


def test_invalid_tiles_raise_naming_the_limit():
    unit = envelope.mc_row_lanes(21) * envelope.MC_BATCH
    assert unit == 48
    too_big = unit * (envelope.MC_MAX_CHUNK_ROWS // unit + 1)
    for bm, limit in ((-1, "at least one row"), (50, "MC_BATCH"),
                      (unit + 1, "MC_BATCH"),
                      (too_big, "MC_MAX_CHUNK_ROWS")):
        with pytest.raises(ValueError, match=limit):
            envelope.mc_geometry(16, 32, 636, 21, 16, bm)
        assert limit in envelope.mc_tile_error(21, bm)
    assert envelope.mc_tile_error(21, 96) is None
    assert envelope.mc_tile_error(300, 8) is None      # one lane at C > 128


# the launches before the tile knob at the paths' shapes (P, S, M, C, 2^N)
TODAY = {(16, 32, 636, 21, 16): (128, 6, 672, 1, 512, 1, 16, 4032),
         (1, 32, 636, 21, 16): (128, 6, 96, 7, 32, 7, 16, 4032),
         (6, 32, 636, 21, 16): (128, 6, 336, 2, 192, 2, 16, 4032),
         (64, 32, 8192, 21, 16): (128, 6, 768, 11, 2048, 11, 16, 4032),
         (16, 32, 1488, 21, 16): (128, 6, 768, 2, 512, 2, 16, 4032)}


@pytest.mark.parametrize("shape", sorted(TODAY))
def test_no_tile_is_todays_geometry(shape):
    assert tuple(envelope.mc_geometry(*shape)) == TODAY[shape]
    assert tuple(envelope.mc_geometry(*shape, block_m=None)) == TODAY[shape]


def test_source_tile_limits_match_the_mirror():
    text = SOURCE.read_text()
    got = re.search(r"kMaxChunkRows = int64_t\{1\} << (\d+);", text)
    assert got and 1 << int(got.group(1)) == envelope.MC_MAX_CHUNK_ROWS
    for rule in (r"if \(block_m % \(int64_t\{g\.row_lanes\} \* kBatch\) "
                 r"!= 0\) return kTileNotWholeBatches;",
                 r"if \(block_m > kMaxChunkRows\) return "
                 r"kTileAboveMaxChunkRows;",
                 r"\} else if \(block_m < 0\) \{\s+return kTileBelowOne;"):
        assert re.search(rule, text), rule
    assert re.search(r"long long block_m,\s+long long\* out", text)


def _default_candidates():
    from repro_torch.perf import autotune, cost_model
    return [(w, bm) for w in autotune.default_workloads()
            if cost_model.family(w.entry) == "mc"
            for bm in autotune.candidate_block_ms(w)]


@pytest.mark.parametrize("w,block_m", _default_candidates(),
                         ids=lambda v: getattr(v, "entry", str(v)))
def test_every_tuning_candidate_writes_every_output_once(w, block_m):
    """Every chunk the autotuner times at the paths' shapes
    (autotune.default_workloads) covers each output exactly once."""
    g = envelope.mc_geometry(w.p, w.s, w.m, w.c, w.levels, block_m)
    per_ps, rows = kernel_writes(g, w.p * w.s, w.m, w.c)
    assert (per_ps == 1).all() and (rows == 1).all()
