"""The launch geometry of the population quantizer (csrc/adc_quantize.cu)
and of the classifier bank kernels (csrc/qmlp_bank.cu), on the CPU.

``envelope.quantize_geometry`` and ``envelope.bank_geometry`` mirror the
kernels' ``geometry_of``; the walks below are the kernels' loops written
out (blocks over spans or tiles and groups, threads over chunks, rows and
design lanes, the channel of each element found incrementally as the
kernels do), and every output must be written exactly once. The built
libraries' own numbers are held against the mirrors on the card by
chip_smoke.py. The range rows the wrappers keep are held against
``core.adc.range_rows_tensors``. The tensor-core attention backward's
``Cfg<DH>`` (csrc/flash_attention_bwd_tc.cu), its constants parsed from
the source, is held against the envelope's ``flash_bwd_tc_*`` mirrors.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.adc import range_rows_tensors
from repro_torch.core.spec import AdcSpec
from repro_torch.kernels import adc_quantize, envelope

CSRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
        / "kernels" / "csrc")


def add_mod(a, b, c):
    s = a + b
    return np.where(s >= c, s - c, s)


def quantize_writes(g: envelope.QuantizeGeometry, p: int, m: int, c: int):
    """How often the quantizer writes each (p, flat m*C + c) output; the
    channel the kernel derives for each element is checked on the way."""
    total = m * c
    writes = np.zeros((p, total), np.int64)
    t = np.arange(g.threads)[:, None, None]
    k = np.arange(envelope.Q_CHUNKS)[None, :, None]
    j = np.arange(4)[None, None, :]
    e = 4 * (t + k * g.threads) + j                     # (threads, chunks, 4)
    ch_thread = (4 * np.arange(g.threads)) % c
    ch_chunk = (4 * g.threads) % c
    ch_span = g.span % c
    ch_grid = (g.grid_x % c) * ch_span % c
    for bx in range(g.grid_x):
        ch_base = (bx % c) * ch_span % c
        sp = bx
        while True:
            base = sp * g.span
            rem = min(g.span, total - base)
            ch = add_mod(ch_base, ch_thread, c)          # per thread
            chans = np.empty(e.shape, np.int64)
            for kk in range(envelope.Q_CHUNKS):
                cj = ch.copy()
                for jj in range(4):
                    chans[:, kk, jj] = cj
                    cj = np.where(cj + 1 == c, 0, cj + 1)
                ch = add_mod(ch, ch_chunk, c)
            live = e < rem
            assert (chans[live] == (base + e[live]) % c).all()
            flat = base + e[live]
            for by in range(g.grid_y):
                p0 = by * g.group
                for gi in range(min(g.group, p - p0)):
                    np.add.at(writes[p0 + gi], flat, 1)
            sp += g.grid_x
            if sp >= g.spans:
                break
            ch_base = (ch_base + ch_grid) % c
    return writes


QUANTIZE_CASES = ([(p, m, c, n) for p in (1, 5, 16, 33)
                   for m, c in ((1488, 21), (636, 21), (257, 3), (999, 200))
                   for n in (2, 16, 64)]
                  + [(16, 1, 21, 16), (2, 3, 1, 2), (7, 10, 7, 8),
                     (64, 4096, 21, 16), (40, 1000, 21, 16),
                     (3, 600, 200, 64), (1, 5, 14_000, 2), (17, 2, 2, 2)])


@pytest.mark.parametrize("p,m,c,n", QUANTIZE_CASES)
def test_quantizer_writes_every_output_once(p, m, c, n):
    g = envelope.quantize_geometry(p, m, c, n)
    assert (quantize_writes(g, p, m, c) == 1).all()
    assert g.span % 4 == 0 and 4 <= g.span <= envelope.Q_SPAN_MAX
    assert g.spans * g.span >= m * c > (g.spans - 1) * g.span
    assert g.group * g.groups >= p > g.group * (g.groups - 1)
    assert 1 <= g.group <= max(1, min(p, envelope.Q_MAX_GROUP))
    assert 1 <= g.grid_y <= envelope.MAX_DESIGNS
    assert g.smem_bytes == 4 * (g.group * c * n + 2 * c)
    assert g.smem_bytes <= max(envelope.quantize_smem_bytes(c, n),
                               envelope.Q_GROUP_BYTES)
    if g.group > 1:       # a group's tables and rows fit the group budget
        assert g.smem_bytes <= envelope.Q_GROUP_BYTES


def code_slot(g: envelope.BankGeometry, r, c):
    """Where the bank kernel keeps the code of tile row r, feature c:
    feature-major, the 16-byte word of rows 4q..4q+3 at word q ^ (c & 7)
    of its row of codes where the padded layout has R / 4 a multiple of 8
    (csrc/qmlp_bank.cu, ``sw``)."""
    units = g.rows // g.per_thread
    sw = 7 if g.per_thread == 4 and units % 8 == 0 else 0
    return c * g.rows + (((r >> 2) ^ (c & sw)) << 2) + (r & 3)


def bank_writes(g: envelope.BankGeometry, kind, d, m, f, o):
    """How often the bank kernel writes each (d, m) row of logits (all O
    at once). On the way: every code slot of a tile is written once, with
    the (row, feature) the kernel carries equal to the element's, and the
    16-byte word a thread gathers through holds its own rows' codes."""
    writes = np.zeros((d, m), np.int64)
    nt = g.threads
    t = np.arange(nt)
    units = g.rows // g.per_thread
    unit, lane = t % units, t // units
    compute = lane < g.lanes
    iters = -(-g.group // g.lanes)
    slots = g.rows * f
    # the codes each thread writes: e = t, t + nt, ... < R * F, eight at a
    # time, (row, feature) carried as the kernel does
    r, c = t // f, t % f
    slot_hits = np.zeros(slots, np.int64)
    e0 = t.copy()
    first = True
    while first or (e0 < slots).any():
        for k in range(8):
            e = e0 + k * nt
            live = e < slots
            assert (r[live] == e[live] // f).all() and \
                (c[live] == e[live] % f).all()
            np.add.at(slot_hits, code_slot(g, r[live], c[live]), 1)
            r = r + nt // f
            c = c + nt % f
            wrap = c >= f
            c = np.where(wrap, c - f, c)
            r = np.where(wrap, r + 1, r)
        e0 = e0 + 8 * nt
        first = False
    assert (slot_hits == 1).all()
    if g.per_thread == 4:           # the gather's word is its rows' codes
        sw = 7 if units % 8 == 0 else 0
        for cc in range(f):
            word = cc * g.rows + 4 * (np.arange(units) ^ (cc & sw))
            assert (word == code_slot(g, 4 * np.arange(units), cc)).all()
    for by in range(g.grid_y):
        d0 = by * g.group
        count = min(g.group, d - d0)
        for bx in range(g.grid_x):
            for tile in range(bx, g.tiles, g.grid_x):
                row0 = tile * g.rows
                rows_here = min(g.rows, m - row0)
                r0 = unit * g.per_thread
                for it in range(iters):
                    gi = lane + it * g.lanes
                    act = compute & (gi < count)
                    if g.staged:
                        # a warp's units are 32 consecutive units of one
                        # design; its run is clipped at the ragged end
                        for w in range(nt // 32):
                            tw = np.arange(32 * w, 32 * w + 32)
                            if not act[tw].all():
                                assert not act[tw].any()
                                continue
                            assert (gi[tw] == gi[tw[0]]).all()
                            assert (unit[tw] - unit[tw[0]]
                                    == np.arange(32)).all()
                            first = unit[tw[0]] * g.per_thread
                            last = min(rows_here, first + 32 * g.per_thread)
                            if last > first:
                                writes[d0 + gi[tw[0]],
                                       row0 + first:row0 + last] += 1
                        continue
                    act = act & (r0 < rows_here)
                    for i in range(g.per_thread):
                        ok = act & (r0 + i < rows_here)
                        np.add.at(writes, (d0 + gi[ok], row0 + r0[ok] + i), 1)
    return writes


BANK_CASES = ([(kind, d, m, 21, 16, 5, 3) for kind in ("mlp", "svm")
               for d in (1, 3, 6, 17, 64) for m in (1, 636, 1024, 1000)]
              + [("mlp", 3, 333, 16, 16, 20, 11),
                 ("svm", 3, 333, 16, 16, 0, 11),
                 ("mlp", 2, 300, 200, 64, 8, 4),
                 ("svm", 2, 300, 200, 64, 0, 4),
                 ("mlp", 4, 1000, 21, 2, 5, 3), ("mlp", 4, 1000, 21, 64, 5, 3),
                 ("svm", 1, 40, 4000, 8, 0, 2), ("mlp", 5, 777, 21, 16, 5, 3),
                 ("mlp", 1, 50, 200, 256, 5, 3), ("svm", 1, 50, 2000, 8, 0, 9),
                 ("svm", 40, 5000, 21, 16, 0, 3), ("mlp", 2, 9, 3, 4, 1, 1)])


@pytest.mark.parametrize("kind,d,m,f,n,h,o", BANK_CASES)
def test_bank_writes_every_output_once(kind, d, m, f, n, h, o):
    g = envelope.bank_geometry(kind, d, m, f, n, h, o)
    assert (bank_writes(g, kind, d, m, f, o) == 1).all()
    assert g.threads == envelope.BANK_THREADS
    assert g.per_thread == (envelope.BANK_ROWS_PER_THREAD if g.padded else 1)
    assert g.rows % g.per_thread == 0
    assert 1 <= (g.rows // g.per_thread) * g.lanes <= g.threads
    assert 1 <= g.lanes <= g.group
    assert g.group * g.groups >= d > g.group * (g.groups - 1)
    assert g.tiles * g.rows >= m > (g.tiles - 1) * g.rows
    assert 1 <= g.grid_y <= envelope.MAX_DESIGNS
    assert g.smem_bytes <= envelope.SMEM_MAX_BYTES
    assert g.staged == int(bool(g.padded) and o <= envelope.BANK_O_CHUNK
                           and (g.rows // g.per_thread) % 32 == 0)
    assert g.smem_bytes == 4 * (
        envelope.bank_operand_words(kind, bool(g.padded), g.group, f, n, h,
                                    o) + g.rows * f
        + (g.threads // 32 * envelope.BANK_WARP_RUN if g.staged else 0))


def test_paths_shapes_fill_the_card():
    """Two quantizer blocks an SM of an H100 at the search's shapes (the
    cardio train and test splits, P = 16 and 32, and the P = 1 call), one
    bank block an SM at the serve shapes (M 1024, D 6 / 3 / 1), and every
    SM busy at the wide shapes."""
    sms = 132
    for p, m in ((16, 1488), (16, 636), (32, 1488), (32, 636), (1, 636),
                 (64, 65536)):
        g = envelope.quantize_geometry(p, m, 21, 16)
        assert g.grid_x * g.grid_y >= 2 * sms, (p, m, g)
    for kind, h in (("mlp", 5), ("svm", 0)):
        for d, m in ((6, 1024), (3, 1024), (1, 1024), (64, 65536)):
            g = envelope.bank_geometry(kind, d, m, 21, 16, h, 3)
            assert g.grid_x * g.grid_y >= sms, (kind, d, m, g)
    # the wide calls: x is read P / G = 2 times, a design's operands by
    # 256 rows at a time, four designs a thread; the search shape takes
    # one table a block, the P = 32 one three
    g = envelope.quantize_geometry(64, 65536, 21, 16)
    assert (g.group, g.span) == (32, envelope.Q_SPAN_MAX)
    assert envelope.quantize_geometry(16, 1488, 21, 16).group == 1
    assert envelope.quantize_geometry(32, 1488, 21, 16).group == 3
    g = envelope.bank_geometry("mlp", 64, 65536, 21, 16, 5, 3)
    assert (g.group, g.rows, g.lanes, g.padded, g.staged) == \
        (16, 256, 4, 1, 1)
    # the serve shapes: one design a block, so little to stage
    for d in (6, 3, 1):
        assert envelope.bank_geometry("mlp", d, 1024, 21, 16, 5, 3).group == 1


def _consts(name, names):
    text = (CSRC / name).read_text()
    out = {}
    for c in names:
        found = re.search(rf"constexpr \w+ {c} = ([^;]+);", text)
        assert found, c
        out[c] = found.group(1).strip()
    return out


def test_source_constants_match_the_mirror():
    q = _consts("adc_quantize.cu", ("kThreads", "kChunks", "kSpanMax",
                                    "kSpanFull", "kGroupBytes", "kMaxGroup",
                                    "kMinBlocks", "kMaxGridX"))
    assert int(q["kThreads"]) == envelope.Q_THREADS
    assert int(q["kChunks"]) == envelope.Q_CHUNKS
    assert q["kSpanMax"] == "kThreads * 4 * kChunks"
    assert envelope.Q_SPAN_MAX == envelope.Q_THREADS * 4 * envelope.Q_CHUNKS
    assert q["kSpanFull"] == "kThreads * 4"
    assert envelope.Q_SPAN_FULL == envelope.Q_THREADS * 4
    assert int(q["kGroupBytes"]) == envelope.Q_GROUP_BYTES
    assert int(q["kMaxGroup"]) == envelope.Q_MAX_GROUP
    assert int(q["kMinBlocks"]) == envelope.Q_MIN_BLOCKS
    assert int(q["kMaxGridX"]) == envelope.MAX_GRID_X
    b = _consts("qmlp_bank.cu", ("kThreads", "kRowsPerThread", "kMaxRows",
                                 "kCodeWords", "kGroupBytes", "kMaxGroup",
                                 "kMinBlocks", "kSmemMax", "kMaxGridX",
                                 "kOChunk", "kWarpRun"))
    assert int(b["kOChunk"]) == envelope.BANK_O_CHUNK
    assert b["kWarpRun"] == "32 * kRowsPerThread * kOChunk"
    assert int(b["kThreads"]) == envelope.BANK_THREADS
    assert int(b["kRowsPerThread"]) == envelope.BANK_ROWS_PER_THREAD
    assert int(b["kMaxRows"]) == envelope.BANK_MAX_ROWS
    assert int(b["kCodeWords"]) == envelope.BANK_CODE_WORDS
    assert int(b["kGroupBytes"]) == envelope.BANK_GROUP_BYTES
    assert int(b["kMaxGroup"]) == envelope.BANK_MAX_GROUP
    assert int(b["kMinBlocks"]) == envelope.BANK_MIN_BLOCKS
    assert int(b["kSmemMax"]) == envelope.SMEM_MAX_BYTES
    assert int(b["kMaxGridX"]) == envelope.MAX_GRID_X


def test_quantizer_envelope_only_widens():
    """Every (C, 2^N) one table admitted (4 * (C 2^N + 2 C) bytes within
    the limit) is still taken, with a geometry inside the limit."""
    for n in (1, 2, 4, 8, 16, 32, 64, 128, 256, 512):
        for c in range(1, 20_000, 37):
            before = 4 * (c * n + 2 * c) <= envelope.SMEM_MAX_BYTES
            if before:
                assert envelope.outside_quantize_envelope(c, n, 7) is None
                g = envelope.quantize_geometry(7, 3, c, n)
                assert g.smem_bytes <= envelope.SMEM_MAX_BYTES, (c, n)
    assert envelope.outside_quantize_envelope(200, 64, 3) is None
    g = envelope.quantize_geometry(3, 600, 200, 64)
    assert g.group == 1 and g.smem_bytes > envelope.SMEM_DEFAULT_BYTES


@pytest.mark.parametrize("kind", ["mlp", "svm"])
def test_bank_envelope_only_widens(kind):
    """Every (F, 2^N, H, O) the first bank kernel admitted (one design
    and two range rows within the limit) is still taken, with a
    geometry inside the limit, whatever D and M."""
    seen_unpadded = 0
    for n in (2, 4, 16, 64, 256):
        for f in (1, 3, 21, 200, 1000, 4000, 9000):
            for h in ((1, 5, 9, 64) if kind == "mlp" else (0,)):
                for o in (1, 3, 8, 9, 40):
                    if envelope.smem_bytes(kind, f, n, h, o) > \
                            envelope.SMEM_MAX_BYTES:
                        continue
                    assert envelope.outside_envelope(kind, f, n, h, o,
                                                     5) is None
                    for d, m in ((1, 1), (5, 1024), (64, 65536)):
                        g = envelope.bank_geometry(kind, d, m, f, n, h, o)
                        assert g.smem_bytes <= envelope.SMEM_MAX_BYTES
                        assert g.rows >= 1
                        seen_unpadded += not g.padded
    # the edge of the envelope: one design that fills it but for the rows
    f, o = 1000, 3
    n = 52 if kind == "svm" else 36
    h = 0 if kind == "svm" else 20
    assert envelope.outside_envelope(kind, f, n, h, o, 1) is None
    g = envelope.bank_geometry(kind, 1, 1024, f, n, h, o)
    assert not g.padded and g.rows >= 1 and \
        g.smem_bytes <= envelope.SMEM_MAX_BYTES
    assert seen_unpadded > 0


def test_wrapper_keeps_the_range_rows(monkeypatch):
    """The quantizer's and the banks' wrappers build a spec's range rows
    once per (bits, vmin, vmax, C, device): equal to range_rows_tensors,
    and a second call builds nothing."""
    built = []

    def counting(*args, **kw):
        built.append(args)
        return range_rows_tensors(*args, **kw)

    adc_quantize._range_rows.cache_clear()
    monkeypatch.setattr(adc_quantize, "range_rows_tensors", counting)
    for spec in (AdcSpec(bits=4), AdcSpec(bits=3, vmin=(0.0, -1.0, 0.25),
                                          vmax=(1.0, 2.0, 0.5))):
        lo, scale = adc_quantize.range_rows(spec, 3, "cpu")
        want = range_rows_tensors(spec.bits, spec.vmin, spec.vmax, 3, "cpu")
        assert torch.equal(lo, want[0]) and torch.equal(scale, want[1])
        assert lo.dtype == scale.dtype == torch.float32
        again = adc_quantize.range_rows(spec, 3, torch.device("cpu"))
        assert again[0] is lo and again[1] is scale
    assert len(built) == 2
    adc_quantize.range_rows(AdcSpec(bits=4), 21, "cpu")
    assert len(built) == 3
    adc_quantize._range_rows.cache_clear()


# ------------------------------------------------------------- the tile
# The tile knob (``block_m``): the bank's rows, the quantizer's span of
# block_m * C elements, each a geometry the kernels' walks above must
# cover exactly once; a tile the kernel cannot take raises, naming its
# limit; no tile (None or 0) is the geometry the kernels had before the
# knob, here at the paths' shapes.
QUANTIZE_TILE_CASES = [(p, m, c, n, bm) for p, m, c, n in
                       ((16, 636, 21, 16), (5, 257, 3, 2), (7, 10, 7, 8),
                        (2, 3, 1, 2), (17, 2, 2, 2), (3, 600, 200, 64))
                       for bm in (1, 2, 3, 7, 87, envelope.Q_SPAN_MAX // c)
                       if bm * c <= envelope.Q_SPAN_MAX]


@pytest.mark.parametrize("p,m,c,n,block_m", QUANTIZE_TILE_CASES)
def test_quantizer_tile_writes_every_output_once(p, m, c, n, block_m):
    g = envelope.quantize_geometry(p, m, c, n, block_m)
    heuristic = envelope.quantize_geometry(p, m, c, n)
    assert g.span == -(-block_m * c // 4) * 4 <= envelope.Q_SPAN_MAX
    assert (g.group, g.groups, g.smem_bytes) == (heuristic.group,
                                                 heuristic.groups,
                                                 heuristic.smem_bytes)
    assert (quantize_writes(g, p, m, c) == 1).all()
    assert g.spans * g.span >= m * c > (g.spans - 1) * g.span


def _bank_tiles(kind, d, m, f, n, h, o):
    g = envelope.bank_geometry(kind, d, m, f, n, h, o)
    unit = g.per_thread
    top = min(envelope.BANK_MAX_ROWS, max(unit, envelope.BANK_CODE_WORDS // f))
    return sorted({unit, 2 * unit, 3 * unit, 5 * unit, g.rows,
                   top // unit * unit} - {0})


BANK_TILE_CASES = [case + (bm,) for case in
                   (("mlp", 6, 1024, 21, 16, 5, 3), ("svm", 3, 256, 21, 16,
                                                     0, 3),
                    ("mlp", 1, 636, 21, 16, 5, 3), ("svm", 17, 1000, 21, 16,
                                                    0, 3),
                    ("mlp", 3, 333, 16, 16, 20, 11),
                    ("mlp", 2, 300, 200, 64, 8, 4),
                    ("mlp", 1, 50, 200, 256, 5, 3), ("mlp", 2, 9, 3, 4, 1, 1),
                    ("mlp", 1, 1024, 1000, 36, 20, 3))
                   for bm in _bank_tiles(*case)]


@pytest.mark.parametrize("kind,d,m,f,n,h,o,block_m", BANK_TILE_CASES)
def test_bank_tile_writes_every_output_once(kind, d, m, f, n, h, o, block_m):
    heuristic = envelope.bank_geometry(kind, d, m, f, n, h, o)
    if envelope.bank_tile_error(kind, bool(heuristic.padded),
                                heuristic.group, f, n, h, o, block_m):
        with pytest.raises(ValueError, match="bank tile"):
            envelope.bank_geometry(kind, d, m, f, n, h, o, block_m)
        return
    g = envelope.bank_geometry(kind, d, m, f, n, h, o, block_m)
    assert g.rows == block_m
    assert (g.group, g.groups, g.padded, g.per_thread) == (
        heuristic.group, heuristic.groups, heuristic.padded,
        heuristic.per_thread)
    assert (bank_writes(g, kind, d, m, f, o) == 1).all()
    assert g.tiles * g.rows >= m > (g.tiles - 1) * g.rows
    assert 1 <= (g.rows // g.per_thread) * g.lanes <= g.threads
    assert g.smem_bytes == 4 * envelope.bank_words(
        kind, bool(g.padded), g.group, g.rows, f, n, h, o) \
        <= envelope.SMEM_MAX_BYTES


@pytest.mark.parametrize("kind,d,m,f,n,h,o", BANK_CASES)
def test_bank_heuristic_tile_is_the_heuristic(kind, d, m, f, n, h, o):
    """The heuristic's own rows, passed as the tile, give its launch back
    (the autotuner measures the heuristic that way); 0 is no tile."""
    g = envelope.bank_geometry(kind, d, m, f, n, h, o)
    assert envelope.bank_geometry(kind, d, m, f, n, h, o, g.rows) == g
    assert envelope.bank_geometry(kind, d, m, f, n, h, o, 0) == g


def test_invalid_tiles_raise_naming_the_limit():
    bank = ("mlp", 6, 1024, 21, 16, 5, 3)
    for bm, limit in ((-1, "at least one row"),
                      (6, "BANK_ROWS_PER_THREAD"),
                      (260, "BANK_MAX_ROWS")):
        with pytest.raises(ValueError, match=limit):
            envelope.bank_geometry(*bank, block_m=bm)
    with pytest.raises(ValueError, match="BANK_CODE_WORDS"):
        envelope.bank_geometry("mlp", 2, 300, 200, 64, 8, 4, block_m=44)
    # one design near the limit (the unpadded layout, one row a thread):
    # two rows of codes fit beside its operands, eight do not
    edge = ("mlp", 1, 1024, 1000, 36, 20, 3)
    assert not envelope.bank_geometry(*edge).padded
    with pytest.raises(ValueError, match="shared memory"):
        envelope.bank_geometry(*edge, block_m=8)
    assert envelope.bank_geometry(*edge, block_m=1).rows == 1
    assert envelope.bank_geometry(*edge, block_m=2).rows == 2
    for bm, limit in ((-1, "at least one row"), (196, "Q_SPAN_MAX")):
        with pytest.raises(ValueError, match=limit):
            envelope.quantize_geometry(16, 1488, 21, 16, bm)
        assert limit in envelope.quantize_tile_error(21, bm)
    assert envelope.quantize_tile_error(21, 195) is None
    assert envelope.quantize_geometry(16, 1488, 21, 16, 195).span == 4096


# the launches before the tile knob, at the paths' shapes: the quantizer
# (P, M, C, 2^N) -> QuantizeGeometry, the banks (kind, D, M, F, 2^N, H,
# O) -> BankGeometry
TODAY_QUANTIZE = {
    (16, 1488, 21, 16): (256, 1, 16, 1836, 18, 18, 16, 1512),
    (16, 636, 21, 16): (256, 1, 16, 784, 18, 18, 16, 1512),
    (32, 1488, 21, 16): (256, 3, 11, 1300, 25, 25, 11, 4200),
    (1, 636, 21, 16): (256, 1, 1, 48, 279, 279, 1, 1512),
    (64, 65536, 21, 16): (256, 32, 2, 4096, 336, 336, 2, 43176),
    (16, 1980, 16, 8): (256, 1, 16, 1864, 17, 17, 16, 640),
    (16, 1680, 24, 8): (256, 2, 8, 1220, 34, 34, 8, 1728),
    (8, 600, 16, 4): (256, 1, 8, 288, 34, 34, 8, 384)}
TODAY_BANK = {
    ("mlp", 6, 1024, 21, 16, 5, 3): (256, 44, 4, 1, 1, 6, 24, 24, 6, 1, 0,
                                     5840),
    ("svm", 3, 1024, 21, 16, 0, 3): (256, 20, 4, 1, 1, 3, 52, 52, 3, 1, 0,
                                     3376),
    ("mlp", 1, 1024, 21, 16, 5, 3): (256, 4, 4, 1, 1, 1, 256, 256, 1, 1, 0,
                                     2480),
    ("svm", 1, 1024, 21, 16, 0, 3): (256, 4, 4, 1, 1, 1, 256, 256, 1, 1, 0,
                                     2032),
    ("mlp", 6, 256, 21, 16, 5, 3): (256, 8, 4, 1, 1, 6, 32, 32, 6, 1, 0,
                                    2816),
    ("svm", 3, 256, 21, 16, 0, 3): (256, 4, 4, 1, 1, 3, 64, 64, 3, 1, 0,
                                    2032),
    ("mlp", 64, 65536, 21, 16, 5, 3): (256, 256, 4, 4, 16, 4, 256, 256, 4,
                                       1, 1, 71936),
    ("svm", 64, 65536, 21, 16, 0, 3): (256, 256, 4, 4, 16, 4, 256, 256, 4,
                                       1, 1, 64960),
    ("mlp", 6, 636, 21, 16, 5, 3): (256, 28, 4, 1, 1, 6, 23, 23, 6, 1, 0,
                                    4496)}


@pytest.mark.parametrize("shape", sorted(TODAY_QUANTIZE))
def test_no_quantizer_tile_is_todays_geometry(shape):
    assert tuple(envelope.quantize_geometry(*shape)) == TODAY_QUANTIZE[shape]
    assert tuple(envelope.quantize_geometry(*shape, block_m=None)) == \
        tuple(envelope.quantize_geometry(*shape, block_m=0))


@pytest.mark.parametrize("shape", sorted(TODAY_BANK))
def test_no_bank_tile_is_todays_geometry(shape):
    assert tuple(envelope.bank_geometry(*shape)) == TODAY_BANK[shape]
    assert tuple(envelope.bank_geometry(*shape, block_m=None)) == \
        tuple(envelope.bank_geometry(*shape, block_m=0))


def test_source_tile_limits_match_the_mirror():
    """The CUDA sources refuse the tiles the mirrors refuse: the bank's
    rows above kMaxRows, kCodeWords / F (at least the rows a thread), off
    kRowsPerThread in the padded layout or above kSmemMax; the
    quantizer's span above kSpanMax; block_m 0 the heuristic."""
    bank = (CSRC / "qmlp_bank.cu").read_text()
    for rule in (r"if \(block_m > kMaxRows\) return kTileAboveMaxRows;",
                 r"kCodeWords / f > g\.per_thread \? kCodeWords / f : "
                 r"g\.per_thread",
                 r"if \(block_m > by_codes\) return kTileAboveCodeWords;",
                 r"if \(block_m % g\.per_thread != 0\) return "
                 r"kTileNotWholeRowGroups;",
                 r"block_words\(mlp, g\.pad, g\.group, block_m, f, n, h, o\) "
                 r"> kSmemMax\)",
                 r"\} else if \(block_m < 0\) \{\s+return kTileBelowOne;"):
        assert re.search(rule, bank), rule
    quant = (CSRC / "adc_quantize.cu").read_text()
    for rule in (r"span = ceil_div\(block_m \* c, 4\) \* 4;",
                 r"if \(span > kSpanMax\) return kTileAboveSpanMax;",
                 r"\} else if \(block_m < 0\) \{\s+return kTileBelowOne;"):
        assert re.search(rule, quant), rule
    for src in (bank, quant):
        assert "int64_t block_m" in src
        assert re.search(r"long long block_m,\s+long long\* out", src)


def _default_candidates(families):
    from repro_torch.perf import autotune, cost_model
    return [(w, bm) for w in autotune.default_workloads()
            if cost_model.family(w.entry) in families
            for bm in autotune.candidate_block_ms(w)]


@pytest.mark.parametrize("w,block_m", _default_candidates(("quantize",
                                                           "bank")),
                         ids=lambda v: getattr(v, "entry", str(v)))
def test_every_tuning_candidate_writes_every_output_once(w, block_m):
    """Every tile the autotuner times at the paths' shapes
    (autotune.default_workloads) covers each output exactly once."""
    from repro_torch.perf import cost_model
    g = cost_model.geometry(w, block_m)
    if cost_model.family(w.entry) == "quantize":
        assert (quantize_writes(g, w.p, w.m, w.c) == 1).all()
    else:
        kind = "mlp" if w.entry.endswith("mlp") else "svm"
        assert g.rows == block_m
        assert (bank_writes(g, kind, w.d, w.m, w.c, w.o) == 1).all()


def _c_to_py(expr: str) -> str:
    """A C integer expression of the Cfg structs (+, -, *, integer /,
    comparisons, ?: nested on the right) as Python."""
    if "?" not in expr:
        return expr
    cond, rest = expr.split("?", 1)
    then, other = rest.split(":", 1)
    return (f"(({_c_to_py(then)}) if ({_c_to_py(cond)}) "
            f"else ({_c_to_py(other)}))")


def _cfg_consts(name: str, dh: int) -> dict:
    """The constants of ``struct Cfg`` in csrc/<name>, evaluated at DH = dh
    in the order they are declared, after the namespace's own constexpr
    ints that precede the struct."""
    text = re.sub(r"//[^\n]*", "", (CSRC / name).read_text())
    head, body = re.search(r"(.*?)struct Cfg \{(.*?)\n\};", text,
                           re.S).groups()
    env = {"DH": dh, "true": True, "false": False}
    decls = (re.findall(r"^constexpr int (\w+) = ([^;]+);", head, re.M)
             + re.findall(r"static constexpr (?:int|bool) (\w+) = ([^;]+);",
                          body))
    for key, expr in decls:
        py = _c_to_py(expr.replace("/", "//"))
        env[key] = eval(py, {"__builtins__": {}}, dict(env))
    return env


def test_backward_tc_instantiations_are_the_envelope_widths():
    """csrc/flash_attention_bwd_tc.cu launches (and sizes) exactly the
    head widths ``envelope.FLASH_BWD_TC_HEAD_DIMS`` names."""
    src = (CSRC / "flash_attention_bwd_tc.cu").read_text()
    launched = sorted(int(d) for d in re.findall(
        r"case (\d+): return launch<\1>", src))
    sized = sorted(int(d) for d in re.findall(
        r"case (\d+): return smem_of<\1>", src))
    assert launched == sized == sorted(envelope.FLASH_BWD_TC_HEAD_DIMS)
    assert 256 in launched


@pytest.mark.parametrize("dh", envelope.FLASH_BWD_TC_HEAD_DIMS)
def test_backward_tc_cfg_matches_the_envelope(dh):
    """Cfg<DH> of csrc/flash_attention_bwd_tc.cu, its constants parsed
    from the source and evaluated at each instantiated width (Cfg<256>
    included), gives the envelope's geometry: each ring's depth, the row
    passes' kv-tile keys, the dk/dv pass's q rows and walks, and each
    pass's shared memory."""
    c = _cfg_consts("flash_attention_bwd_tc.cu", dh)
    assert c["kChunks"] == -(-dh // 64)
    assert c["kRowStages"] == envelope.flash_bwd_tc_stages(0, dh) \
        == envelope.flash_bwd_tc_stages(2, dh)
    assert c["kColStages"] == envelope.flash_bwd_tc_stages(1, dh)
    assert c["kBK"] == envelope.flash_bwd_tc_key_rows(dh)
    assert c["kQB"] == envelope.FLASH_BWD_TC_Q_ROWS
    assert c["kColWalks"] == envelope.flash_bwd_tc_walks(dh)
    assert [c["kRowBytes"], c["kColBytes"], c["kRowBytes"]] == [
        envelope.flash_bwd_tc_smem_bytes(p, dh) for p in range(3)]
    assert max(c["kRowBytes"], c["kColBytes"]) <= envelope.SMEM_MAX_BYTES
