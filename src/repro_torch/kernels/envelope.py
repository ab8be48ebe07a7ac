"""The Hopper envelope of the hand-written kernels: the fused classifier
bank kernels, the population quantizer, the Monte-Carlo kernel and the
flash-attention kernel.

The reference's limits (``repro/kernels/envelope.py``: ``MAX_UNROLL_BITS``,
``MAX_CHANNELS``, ``VMEM_BUDGET_F32``) describe a TPU: how far a one-hot
selection sum unrolls and what fits a VMEM tile. None of them binds the
CUDA kernels, which gather from tables in shared memory. What binds the
bank kernels on an H100 is that a block stages at least one design's
operands and its codes in shared memory; a shape is admitted where the
first bank kernel's footprint fits,

    table (F, 2^N) + W1 (F, H) + b1 (H) + W2 (H, O) + b2 (O) + 2 range rows (F)

for an MLP design (SVM: table + W (F, O) + b (O) + 2 rows), all float32,
so that the envelope never narrows (the kernel needs the operands and F
words of codes a row).
A block may use at most 227 KB (232,448 bytes) of shared memory; above
48 KB only as dynamic shared memory after
``cudaFuncAttributeMaxDynamicSharedMemorySize`` is raised (the launcher
in csrc/qmlp_bank.cu does so). The design axis is the grid's y dimension,
at most 65,535. Hidden and output widths of any size run in register
chunks, and M is bounded only by 64-bit offsets.

The bank kernels' launch (``bank_geometry``; ``qmlp_bank_geometry`` in
the built library returns the same): a block takes R sample rows and a
group of G designs, and stages the group's operands (weight rows padded to
16 bytes) and the R x F codes; one design at the limit runs unpadded with
R cut to what is left, so every shape ``smem_bytes`` admits still runs.

The population quantizer (csrc/adc_quantize.cu) stages the tables of a
group of G individuals (one where a table needs more than 48 KB) and the
two range rows (C) in shared memory, under the same 227 KB limit (above
48 KB its launcher raises the attribute too); the group axis is the
grid's y dimension, at most 65,535 (P itself is held to that).
``quantize_geometry`` gives its launch (``adc_quantize_geometry`` in the
built library returns the same).

The Monte-Carlo kernel (csrc/mc_eval.cu) stages, per (design,
instance), its leaves (C, 2^N) in shared memory as keys, widths and
values: ``12 * C * 2^N`` bytes for both the nominal and the calibrated
variant (the two drifted range rows are read into registers), under the
same 227 KB limit (its launcher raises the attribute above 48 KB).
The (design, instance) axis is the grid's x dimension, M's chunks its y
dimension, each looped beyond the grid's limit. ``mc_geometry`` gives its
launch geometry (``mc_eval_geometry`` in the built library returns the
same).

Each of these three families takes a tile (``block_m``, sample rows, the
reference's Pallas M-tile; perf/autotune.py tunes it): the bank kernels'
R, the quantizer's span of block_m * C elements, the Monte-Carlo
kernel's chunk. ``*_geometry(..., block_m)`` mirror the kernels' launch
at a tile, ``bank_tile_error`` / ``quantize_tile_error`` /
``mc_tile_error`` name the limit a tile breaks (the kernels refuse the
same ones), and None or 0 is the heuristic. A tile decides which block
computes which rows, never an output's bits.

The CUDA-core flash-attention kernel (csrc/flash_attention.cu) is
compiled for dh padded to DHP = 64, 128 or 256 (``flash_head_pad``), up
to gemma2's 256, with a BQ-row q tile, BK-key kv tiles and row groups of
``lanes`` threads (``flash_tiles``: 256 x 64 and 8 lanes at DHP 64, 128 x
32 and 16 lanes at DHP 128, 64 x 32 and 16 lanes at DHP 256; each thread
keeps 16 BQ / 256 rows of BK / lanes scores and DHP / lanes output
columns in registers). It stages, as float32, the q tile, two K and two
V buffers, the BK x (BQ + 4) transposed probability tile and two ints
(the block's live kv-tile range); K rows are padded to DHP + 4 words.
At DHP 64 q is transposed (d-major, rows of BQ + 4 words):
``4 * (64 (BQ + 4) + 2 BK (64 + 4) + 2 BK * 64 + BK (BQ + 4)) + 8``
= 200,712 bytes; above it q is row-major with rows of DHP + 4 words:
``4 * (BQ (DHP + 4) + 2 BK (DHP + 4) + 2 BK DHP + BK (BQ + 4)) + 8``
= 151,048 at DHP 128 and 207,368 at 256 (its launcher raises the
attribute; ``flash_attention_smem_bytes`` in the built library returns
the same). One block per (q tile, batch * head): B*H is the grid's y
dimension, at most 65,535.

The tensor-core flash-attention kernel (csrc/flash_attention_tc.cu) takes
bf16 at the head widths of the repo's attention configs (64, 96, 112, 128,
256). It keeps a 128-row q tile resident and a ring of ``st`` K and V
tiles (3 at dh = 64, else 2), bf16, in 64-column boxes under the 128-byte
swizzle (dh padded to a multiple of 64), the ring's key positions and
per-stage tile words, 1 + 2 st mbarriers and 1 KB of slack to align the
tiles to the swizzle's 1 KB atom:
``2 * dh_pad * (128 + 2 * st * BK) + st * (4 * BK + 8) + (1 + 2 st) * 8
+ 1024`` bytes, BK = 128 keys (64 at dh = 256): 117,328 at dh = 64,
165,944 at dh = 96, 112 and 128, 198,200 at dh = 256 (its launcher
raises the attribute). The route rule (``flash_route``) sends float32,
and bf16 at any other width, to the CUDA-core kernel.

The flash-attention backward (csrc/flash_attention_bwd.cu) is compiled
for dh padded to DHP = 64, 128 or 256 (``flash_bwd_head_pad``; up to
gemma2's 256) with T-row q tiles and T-key kv tiles (``flash_bwd_tile``:
T = 64, but 32 at DHP 256) staged as float32 in rows of DHP + 4 words,
256 threads. Its three passes ask for (``flash_bwd_smem_bytes``): the
row statistics four tiles (q, do, k, v) and two position rows, ``4 * (4
T (DHP + 4) + 2 T)``; dk/dv four tiles, P and dS (T x (T + 1) words
each), lse and D, two position rows, ``4 * (4 T (DHP + 4) + 2 T (T + 1)
+ 4 T)``; dq four tiles, dS, lse and D, two position rows, ``4 * (4 T
(DHP + 4) + T (T + 1) + 4 T)``: 70,144 / 103,936 / 87,296 bytes at DHP
64, 135,680 / 169,472 / 152,832 at 128 and 133,376 / 142,080 / 137,856
at 256 (a 64-row tile there would need 266,752 for the statistics
alone). Their grids are one-dimensional (tiles x batch x heads).

The tensor-core backward (csrc/flash_attention_bwd_tc.cu) takes bf16 at
head widths 64, 96, 112, 128 and 256 (``flash_bwd_route``; 96 and 112 run
as 128; c = ceil(dh / 64) boxes of 64 columns under the 128-byte
swizzle). Its passes stage bf16 tiles by TMA. The row statistics and dq
passes hold a 128-row q and dO tile and a ring of st stages (4 at dh 64,
3 at 96-128, 2 at 256) of kr-key K and V tiles (kr = 64, 32 at dh 256:
``flash_bwd_tc_key_rows``) with the keys' positions and a tile word
pair: ``2 c 16384 + 2 st c 128 kr + st (4 kr + 8) + (1 + 2 st) 8 +
1024`` bytes. The dk/dv pass holds a 128-key K and V tile and a ring of
st stages (4, 2 at dh 256) of 32-row Q and dO tiles with lse, D and the
queries' positions: ``2 c 16384 + 2 st c 4096 + st (384 + 8) + (1 + 2
st) 8 + 1024`` bytes (``flash_bwd_tc_smem_bytes``): 100,456 / 68,200 /
100,456 at dh 64, 165,712 / 133,736 / 165,712 at 96-128 and 197,944 /
198,456 / 197,944 at 256, where the layouts with 64-key K and V tiles or
4 stages of Q and dO would need 262,144 bytes before positions and
barriers. At dh 256 the dk/dv pass walks the q tiles twice, dv then dk
(``flash_bwd_tc_walks``), so a consumer thread holds one 128-float
accumulator, not two. Their grids are (tiles, batch x heads), heads the
query heads for the row passes and the kv heads for dk/dv.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

SMEM_MAX_BYTES = 232_448          # opt-in shared memory per block, sm_90
SMEM_DEFAULT_BYTES = 48 * 1024    # above this the attribute must be raised
MAX_DESIGNS = 65_535              # gridDim.y


def resident_floats(kind: str, f: int, n: int, h: int, o: int) -> int:
    """float32 words one block keeps in shared memory for one design
    (``h`` is ignored for an SVM)."""
    if kind == "mlp":
        return f * n + f * h + h + h * o + o + 2 * f
    if kind == "svm":
        return f * n + f * o + o + 2 * f
    raise ValueError(f"unknown classifier kind {kind!r}")


def smem_bytes(kind: str, f: int, n: int, h: int, o: int) -> int:
    return 4 * resident_floats(kind, f, n, h, o)


def outside_envelope(kind: str, f: int, n: int, h: int, o: int,
                     d: int) -> Optional[str]:
    """None when the bank kernel takes this shape, else the limit it
    breaks, named."""
    need = smem_bytes(kind, f, n, h, o)
    if need > SMEM_MAX_BYTES:
        return (f"one {kind} design needs {need} bytes of shared memory "
                f"(F={f}, 2^N={n}, H={h}, O={o}); the H100 limit per block "
                f"is {SMEM_MAX_BYTES}")
    if d > MAX_DESIGNS:
        return f"D={d} designs exceed the grid's y limit of {MAX_DESIGNS}"
    return None


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _round4(v: int) -> int:
    return _ceil(v, 4) * 4


BANK_THREADS = 256                # threads per bank block
BANK_ROWS_PER_THREAD = 4          # rows a thread carries (padded layout)
BANK_MAX_ROWS = 256               # rows a bank block takes at most
BANK_CODE_WORDS = 8192            # codes of a block's x tile, R > 4
BANK_GROUP_BYTES = 65536          # a group's design operands, G > 1
BANK_MAX_GROUP = 16               # designs a bank block serves
BANK_O_CHUNK = 4                  # logits in registers at once
BANK_WARP_RUN = 32 * BANK_ROWS_PER_THREAD * BANK_O_CHUNK   # staged logits
BANK_MIN_BLOCKS = 132             # one block an SM of an H100
MAX_GRID_X = 2 ** 31 - 1          # gridDim.x


class BankGeometry(NamedTuple):
    """The bank kernels' launch (csrc/qmlp_bank.cu, ``geometry_of``):
    block (x, y) takes tiles x, x + grid_x, ... of ``rows`` sample rows
    and designs y * group .. y * group + group - 1; all ``threads`` load
    and stage, and thread t < (rows / per_thread) * lanes takes rows
    per_thread * (t % (rows / per_thread)) + 0 .. per_thread - 1 and
    design lane t // (rows / per_thread), its designs lane, lane + lanes,
    ... of the group. ``padded``: weight rows padded to 16 bytes (and
    ``per_thread`` 4); unpadded only where that would not fit (one row a
    thread). ``staged``: each warp (32 consecutive units of one design)
    writes its logits through a run in shared memory (O <= 4)."""
    threads: int
    rows: int
    per_thread: int
    lanes: int
    group: int
    groups: int
    tiles: int
    grid_x: int
    grid_y: int
    padded: int
    staged: int
    smem_bytes: int


def bank_operand_words(kind: str, pad: bool, g: int, f: int, n: int, h: int,
                       o: int) -> int:
    """float32 words of g designs' staged operands, one region each;
    padded: weight rows and regions rounded up to 4 words."""
    region = _round4 if pad else (lambda w: w)
    op = _round4(o) if pad else o
    if kind == "svm":
        return region(g * f * n) + region(g * f * op) + region(g * o)
    if kind != "mlp":
        raise ValueError(f"unknown classifier kind {kind!r}")
    hp = _round4(h) if pad else h
    return (region(g * f * n) + region(g * f * hp) + region(g * h)
            + region(g * h * op) + region(g * o))


def _bank_staged(pad: bool, rows: int, o: int) -> bool:
    """Whether each warp writes its logits through a run in shared memory:
    the padded layout, O <= ``BANK_O_CHUNK`` and warps of 32 units."""
    return (pad and o <= BANK_O_CHUNK
            and (rows // BANK_ROWS_PER_THREAD) % 32 == 0)


def bank_words(kind: str, pad: bool, g: int, rows: int, f: int, n: int,
               h: int, o: int) -> int:
    """float32 words of shared memory a bank block of ``g`` designs and
    ``rows`` sample rows stages: the operands, the R x F codes and, where
    staged, the warps' runs of logits."""
    run = BANK_THREADS // 32 * BANK_WARP_RUN if _bank_staged(pad, rows,
                                                              o) else 0
    return bank_operand_words(kind, pad, g, f, n, h, o) + rows * f + run


def bank_tile_error(kind: str, pad: bool, group: int, f: int, n: int, h: int,
                    o: int, block_m: int) -> Optional[str]:
    """None when a bank block takes a tile of ``block_m`` sample rows in
    this layout, else the limit the tile breaks, named (csrc/qmlp_bank.cu
    refuses the same tiles)."""
    rpt = BANK_ROWS_PER_THREAD if pad else 1
    by_codes = max(rpt, BANK_CODE_WORDS // f)
    if block_m < 1:
        return "a bank tile takes at least one row"
    if block_m > BANK_MAX_ROWS:
        return f"above BANK_MAX_ROWS = {BANK_MAX_ROWS} rows a bank block takes"
    if block_m > by_codes:
        return (f"above BANK_CODE_WORDS // F = {by_codes} rows (the codes of "
                f"a block's x tile, {BANK_CODE_WORDS} words at F={f})")
    if block_m % rpt:
        return (f"not a multiple of BANK_ROWS_PER_THREAD = {rpt} rows (the "
                f"padded layout's rows a thread)")
    need = 4 * bank_words(kind, pad, group, block_m, f, n, h, o)
    if need > SMEM_MAX_BYTES:
        return (f"needs {need} bytes of shared memory; the H100 limit per "
                f"block is {SMEM_MAX_BYTES}")
    return None


def bank_geometry(kind: str, d: int, m: int, f: int, n: int, h: int,
                  o: int, block_m: Optional[int] = None) -> BankGeometry:
    """The launch of one bank call, M, D >= 1 (``h`` is ignored for an
    SVM): G designs whose operands fit ``BANK_GROUP_BYTES`` (at most
    ``BANK_MAX_GROUP``), the largest such G that still leaves
    ``BANK_MIN_BLOCKS`` blocks of full tiles (``BANK_MAX_ROWS`` rows), 1
    where none does, D split evenly; R rows, a multiple of 4, so that
    the tiles times the groups give ``BANK_MIN_BLOCKS`` wherever M allows
    (at most ``BANK_MAX_ROWS`` and ``BANK_CODE_WORDS // F``); L = min(G,
    threads / (R / 4)) design lanes. One design at the limit: unpadded,
    one row a thread, R cut to the shared memory left.

    ``block_m`` (the tile knob; None or 0: the heuristic above) sets R and
    nothing else: the group and the layout stay the heuristic's. A tile
    the kernel cannot take raises ValueError naming the limit
    (``bank_tile_error``); it is never clamped."""
    h = h if kind == "mlp" else 0
    fit = BANK_GROUP_BYTES // (4 * bank_operand_words(kind, True, 1, f, n,
                                                      h, o))
    fit = min(fit, BANK_MAX_GROUP, d)
    full = max(1, m // BANK_MAX_ROWS)
    while fit > 1 and _ceil(d, fit) * full < BANK_MIN_BLOCKS:
        fit -= 1
    fit = max(1, fit)
    groups = _ceil(d, fit)
    group = _ceil(d, groups)
    by_fill = m * groups // BANK_MIN_BLOCKS
    rpt = BANK_ROWS_PER_THREAD
    rows = min(BANK_MAX_ROWS, BANK_CODE_WORDS // f, by_fill, _round4(m))
    rows = max(rpt, rows // rpt * rpt)
    pad = True
    if 4 * bank_words(kind, True, group, rows, f, n, h, o) > SMEM_MAX_BYTES:
        pad, rpt = False, 1
        one = bank_operand_words(kind, False, 1, f, n, h, o)
        rows = max(1, min(BANK_MAX_ROWS, BANK_CODE_WORDS // f, by_fill, m,
                          (SMEM_MAX_BYTES // 4 - one) // f))
    if block_m:
        why = bank_tile_error(kind, pad, group, f, n, h, o, block_m)
        if why is not None:
            raise ValueError(f"bank tile block_m={block_m} (F={f}, "
                             f"2^N={n}, H={h}, O={o}, G={group}): {why}")
        rows = block_m
    lanes = min(group, BANK_THREADS // (rows // rpt))
    tiles = _ceil(m, rows)
    words = bank_words(kind, pad, group, rows, f, n, h, o)
    return BankGeometry(BANK_THREADS, rows, rpt, lanes, group, groups, tiles,
                        min(tiles, MAX_GRID_X), groups, int(pad),
                        int(_bank_staged(pad, rows, o)), 4 * words)


Q_THREADS = 256                   # threads per quantizer block
Q_CHUNKS = 4                      # chunks of 4 elements a thread carries
Q_SPAN_MAX = Q_THREADS * 4 * Q_CHUNKS   # elements of x a block takes
Q_SPAN_FULL = Q_THREADS * 4       # a span of one chunk a thread
Q_GROUP_BYTES = 49152             # a group's tables, G > 1
Q_MAX_GROUP = 32                  # individuals a quantizer block serves
Q_MIN_BLOCKS = 264                # two blocks an SM of an H100


class QuantizeGeometry(NamedTuple):
    """The population quantizer's launch (csrc/adc_quantize.cu,
    ``geometry_of``): x is one flat array of M*C elements; block (x, y)
    takes spans x, x + grid_x, ... of ``span`` elements and individuals
    y * group .. y * group + group - 1; thread t takes the chunks of 4
    elements at 4 (t + k * threads), k < ``Q_CHUNKS``, of a span."""
    threads: int
    group: int
    groups: int
    span: int
    spans: int
    grid_x: int
    grid_y: int
    smem_bytes: int


def quantize_tile_error(c: int, block_m: int) -> Optional[str]:
    """None when a quantizer block takes a tile of ``block_m`` rows at C
    channels (a span of block_m * C elements rounded up to a multiple of
    4), else the limit the tile breaks, named (csrc/adc_quantize.cu
    refuses the same tiles)."""
    if block_m < 1:
        return "a tile takes at least one row"
    span = _round4(block_m * c)
    if span > Q_SPAN_MAX:
        return (f"{span} elements at C={c}, above Q_SPAN_MAX = {Q_SPAN_MAX} "
                f"elements a quantizer block takes ({Q_THREADS} threads x "
                f"{Q_CHUNKS} chunks of 4)")
    return None


def quantize_geometry(p: int, m: int, c: int, n: int,
                      block_m: Optional[int] = None) -> QuantizeGeometry:
    """The launch of one quantizer call, P, M >= 1: G tables fit
    ``Q_GROUP_BYTES`` beside the range rows (at most ``Q_MAX_GROUP``),
    the largest such G that still leaves ``Q_MIN_BLOCKS`` blocks of full
    spans (``Q_SPAN_FULL`` elements), 1 where none does, P split evenly;
    the flat x cut into spans, a multiple of 4 elements, at most
    ``Q_SPAN_MAX``, and enough of them that the groups times the spans
    give ``Q_MIN_BLOCKS`` wherever M*C allows.

    ``block_m`` (the tile knob; None or 0: the heuristic above) sets the
    span to block_m * C rounded up to a multiple of 4 and nothing else; a
    tile the kernel cannot take raises ValueError naming the limit
    (``quantize_tile_error``)."""
    total = m * c
    fit = min((Q_GROUP_BYTES - 8 * c) // (4 * c * n), Q_MAX_GROUP, p)
    full = max(1, total // Q_SPAN_FULL)
    while fit > 1 and _ceil(p, fit) * full < Q_MIN_BLOCKS:
        fit -= 1
    fit = max(1, fit)
    groups = _ceil(p, fit)
    group = _ceil(p, groups)
    if block_m:
        why = quantize_tile_error(c, block_m)
        if why is not None:
            raise ValueError(f"quantizer tile block_m={block_m}: {why}")
        span = _round4(block_m * c)
    else:
        spans = max(_ceil(total, Q_SPAN_MAX), _ceil(Q_MIN_BLOCKS, groups))
        span = max(4, _ceil(total, spans) // 4 * 4)
    spans = _ceil(total, span)
    return QuantizeGeometry(Q_THREADS, group, groups, span, spans,
                            min(spans, MAX_GRID_X), groups,
                            4 * (group * c * n + 2 * c))


def quantize_smem_bytes(c: int, n: int) -> int:
    """Shared memory a quantizer block of one individual stages (G = 1,
    the envelope's case): the (C, 2^N) table and the two (C,) range rows,
    float32."""
    return 4 * (c * n + 2 * c)


def outside_quantize_envelope(c: int, n: int, p: int) -> Optional[str]:
    """None when the population quantizer takes this shape, else the
    limit it breaks, named."""
    need = quantize_smem_bytes(c, n)
    if need > SMEM_MAX_BYTES:
        return (f"one table needs {need} bytes of shared memory (C={c}, "
                f"2^N={n}); the H100 limit per block is {SMEM_MAX_BYTES}")
    if p > MAX_DESIGNS:
        return f"P={p} individuals exceed the grid's y limit of {MAX_DESIGNS}"
    return None


MC_THREADS = 128                  # threads per Monte-Carlo block
MC_BATCH = 8                      # rows a row lane carries at once
MC_CHUNK_BYTES = 65536            # x bytes of a block's chunk of M
MC_MIN_BLOCKS = 264               # two blocks an SM of an H100
MC_MAX_GRID_X = MAX_GRID_X
MC_MAX_CHUNK_ROWS = 1 << 30       # a chunk's rows, counted in 32-bit ints
MC_REGISTER_LEAVES = (2, 4, 8, 16, 32)   # 2^N unrolled in registers


class McGeometry(NamedTuple):
    """The Monte-Carlo kernel's launch (csrc/mc_eval.cu, ``geometry_of``):
    block (x, y) takes (p, s) = x, x + grid_x, ... and chunks y, y +
    grid_y, ... of M, ``chunk_rows`` rows each; thread t takes channel
    t % C (and t + threads, ... where C exceeds the threads) and row lane
    t // C of ``row_lanes``, its rows r, r + row_lanes, ... of a chunk
    ``MC_BATCH`` at a time; ``leaves`` is the unrolled leaf count, 0 for
    the run-time leaf loop."""
    threads: int
    row_lanes: int
    chunk_rows: int
    chunks: int
    grid_x: int
    grid_y: int
    leaves: int
    smem_bytes: int


def mc_row_lanes(c: int) -> int:
    """Rows a Monte-Carlo block walks side by side at C channels."""
    return 1 if c >= MC_THREADS else MC_THREADS // c


def mc_tile_error(c: int, block_m: int) -> Optional[str]:
    """None when a Monte-Carlo block takes a chunk of ``block_m`` rows at
    C channels, else the limit the chunk breaks, named (csrc/mc_eval.cu
    refuses the same tiles)."""
    unit = mc_row_lanes(c) * MC_BATCH
    if block_m < 1:
        return "a chunk takes at least one row"
    if block_m % unit:
        return (f"not a whole number of row lanes x MC_BATCH = "
                f"{mc_row_lanes(c)} x {MC_BATCH} = {unit} rows at C={c}")
    if block_m > MC_MAX_CHUNK_ROWS:
        return (f"above MC_MAX_CHUNK_ROWS = {MC_MAX_CHUNK_ROWS} rows (the "
                f"kernel counts a chunk's rows in 32-bit ints)")
    return None


def mc_geometry(p: int, s: int, m: int, c: int, n: int,
                block_m: Optional[int] = None) -> McGeometry:
    """The launch geometry of one Monte-Carlo call, M >= 1: M cut into
    chunks whose x fits ``MC_CHUNK_BYTES`` (it stays in L1 while a block
    walks it), and finer where P*S alone gives fewer than
    ``MC_MIN_BLOCKS`` blocks; each chunk a whole number of batches of
    ``MC_BATCH`` rows for every row lane.

    ``block_m`` (the tile knob; None or 0: the heuristic above) sets the
    chunk's rows and nothing else; a chunk the kernel cannot take raises
    ValueError naming the limit (``mc_tile_error``)."""
    ceil = lambda a, b: -(-a // b)                      # noqa: E731
    lanes = mc_row_lanes(c)
    if block_m:
        why = mc_tile_error(c, block_m)
        if why is not None:
            raise ValueError(f"Monte-Carlo tile block_m={block_m}: {why}")
        chunk_rows = block_m
    else:
        batches = ceil(ceil(m, lanes), MC_BATCH)
        batch_bytes = 4 * c * lanes * MC_BATCH
        chunks = ceil(batches, MC_CHUNK_BYTES // batch_bytes
                      if batch_bytes < MC_CHUNK_BYTES else 1)
        chunks = max(chunks, min(ceil(MC_MIN_BLOCKS, p * s), batches))
        chunk_rows = lanes * MC_BATCH * ceil(batches, chunks)
    chunks = ceil(m, chunk_rows)
    return McGeometry(MC_THREADS, lanes, chunk_rows, chunks,
                      min(p * s, MC_MAX_GRID_X), min(chunks, MAX_DESIGNS),
                      n if n in MC_REGISTER_LEAVES else 0,
                      mc_smem_bytes(c, n))


def mc_smem_bytes(c: int, n: int) -> int:
    """Shared memory one Monte-Carlo block stages: one (design,
    instance)'s leaves (C, 2^N) as keys, widths and values, 4 bytes
    each."""
    return 12 * c * n


def outside_mc_envelope(c: int, n: int) -> Optional[str]:
    """None when the Monte-Carlo kernel takes this shape, else the limit
    it breaks, named."""
    need = mc_smem_bytes(c, n)
    if need > SMEM_MAX_BYTES:
        return (f"one (design, instance) needs {need} bytes of shared "
                f"memory (C={c}, 2^N={n}); the H100 limit per block is "
                f"{SMEM_MAX_BYTES}")
    return None


FLASH_MAX_HEAD_DIM = 256          # the widest compiled head width (DHP)


def flash_head_pad(dh: int) -> int:
    """The head width DHP the CUDA-core kernel is compiled for at dh."""
    return 64 if dh <= 64 else 128 if dh <= 128 else 256


def flash_tiles(dh: int):
    """(q rows per block, keys per kv tile, lanes per row group) of the
    CUDA-core kernel at dh (csrc/flash_attention.cu's Narrow and Wide
    layouts; 256 threads, 256 / lanes row groups)."""
    dhp = flash_head_pad(dh)
    if dhp == 64:
        return 256, 64, 8
    return (128 if dhp == 128 else 64), 32, 16


def flash_smem_bytes(dh: int) -> int:
    """Dynamic shared memory one CUDA-core flash block asks for at head
    width dh (csrc/flash_attention.cu, ``smem_of<Layout>``)."""
    dhp = flash_head_pad(dh)
    bq, bk, _ = flash_tiles(dh)
    q = dhp * (bq + 4) if dhp == 64 else bq * (dhp + 4)  # q^T at DHP 64
    return 4 * (q + 2 * bk * (dhp + 4) + 2 * bk * dhp + bk * (bq + 4)) + 8


def outside_flash_envelope(b: int, h: int, dh: int) -> Optional[str]:
    """None when the flash-attention kernel takes B batch rows of H heads
    at head width dh, else the limit it breaks, named."""
    if dh > FLASH_MAX_HEAD_DIM:
        return (f"head_dim={dh} exceeds the kernel's register tile, "
                f"compiled for head_dim <= {FLASH_MAX_HEAD_DIM}")
    need = flash_smem_bytes(dh)
    if need > SMEM_MAX_BYTES:
        return (f"head_dim={dh} needs {need} bytes of shared memory; the "
                f"H100 limit per block is {SMEM_MAX_BYTES}")
    if b * h > MAX_DESIGNS:
        return (f"B*H={b * h} exceeds the grid's y limit of "
                f"{MAX_DESIGNS}")
    return None


FLASH_TC_HEAD_DIMS = (64, 96, 112, 128, 256)   # the configs' head widths
FLASH_TC_BQ = 128                 # query rows per block (two warpgroups)


def flash_tc_bk(dh: int) -> int:
    """Keys per kv tile of the tensor-core kernel at head width dh."""
    return 64 if dh > 128 else 128


def flash_tc_stages(dh: int) -> int:
    """Depth of the tensor-core kernel's K/V ring at head width dh."""
    return 3 if dh <= 64 else 2


def flash_tc_smem_bytes(dh: int) -> int:
    """Dynamic shared memory one tensor-core flash block asks for at head
    width dh (csrc/flash_attention_tc.cu, ``Cfg<DH>::kBytes``)."""
    pad = 64 * -(-dh // 64)
    bk, stages = flash_tc_bk(dh), flash_tc_stages(dh)
    tiles = 2 * pad * (FLASH_TC_BQ + 2 * stages * bk)
    return (tiles + stages * 4 * bk + stages * 8 + (1 + 2 * stages) * 8
            + 1024)


def flash_route(bf16: bool, dh: int) -> str:
    """The flash-attention kernel a CUDA call takes: 'tensor_core' for
    bf16 at a head width the tensor-core kernel is instantiated for,
    'cuda_core' otherwise (float32 is held at 2e-5, which neither bf16
    nor TF32 products meet)."""
    return "tensor_core" if bf16 and dh in FLASH_TC_HEAD_DIMS else "cuda_core"


def outside_flash_tc_envelope(b: int, h: int, dh: int) -> Optional[str]:
    """None when the tensor-core flash kernel takes B batch rows of H
    heads at head width dh, else the limit it breaks, named."""
    if dh not in FLASH_TC_HEAD_DIMS:
        return (f"head_dim={dh} has no tensor-core instantiation "
                f"({FLASH_TC_HEAD_DIMS})")
    need = flash_tc_smem_bytes(dh)
    if need > SMEM_MAX_BYTES:
        return (f"head_dim={dh} needs {need} bytes of shared memory; the "
                f"H100 limit per block is {SMEM_MAX_BYTES}")
    if b * h > MAX_DESIGNS:
        return (f"B*H={b * h} exceeds the grid's y limit of "
                f"{MAX_DESIGNS}")
    return None


FLASH_BWD_MAX_HEAD_DIM = 256      # the widest compiled backward head width
MAX_BLOCKS_1D = 2 ** 31 - 1       # gridDim.x


def flash_bwd_head_pad(dh: int) -> int:
    """The head width DHP the backward kernel is compiled for at dh."""
    return 64 if dh <= 64 else 128 if dh <= 128 else 256


def flash_bwd_tile(dh: int) -> int:
    """Query rows and keys of a backward tile at head width dh
    (csrc/flash_attention_bwd.cu, ``Tile<DHP>::kT``)."""
    return 32 if flash_bwd_head_pad(dh) == 256 else 64


def flash_bwd_smem_bytes(pass_: int, dh: int) -> int:
    """Dynamic shared memory one block of backward pass ``pass_`` (0 row
    statistics, 1 dk/dv, 2 dq) asks for at head width dh
    (csrc/flash_attention_bwd.cu, ``smem_stats/dkdv/dq<DHP>``)."""
    t = flash_bwd_tile(dh)
    tile = t * (flash_bwd_head_pad(dh) + 4)
    words = {0: 4 * tile + 2 * t,
             1: 4 * tile + 2 * t * (t + 1) + 4 * t,
             2: 4 * tile + t * (t + 1) + 4 * t}[pass_]
    return 4 * words


FLASH_BWD_TC_HEAD_DIMS = (64, 96, 112, 128, 256)


def flash_bwd_route(bf16: bool, dh: int) -> str:
    """The backward kernel a CUDA call takes: 'tensor_core' for bf16 at a
    head width the tensor-core backward is instantiated for, 'cuda_core'
    otherwise (float32 is held at 1e-5, which bf16 products do not
    meet)."""
    return ("tensor_core" if bf16 and dh in FLASH_BWD_TC_HEAD_DIMS
            else "cuda_core")


def flash_bwd_tc_stages(pass_: int, dh: int) -> int:
    """Depth of the tensor-core backward's ring in pass ``pass_`` at head
    width dh (``Cfg<DH>::kRowStages / kColStages``)."""
    if dh > 128:
        return 2
    return 4 if pass_ == 1 or dh <= 64 else 3


def flash_bwd_tc_key_rows(dh: int) -> int:
    """Keys of a kv tile in the tensor-core backward's row passes at head
    width dh (``Cfg<DH>::kBK``)."""
    return 32 if dh > 128 else 64


def flash_bwd_tc_walks(dh: int) -> int:
    """Walks of the tensor-core dk/dv pass over the q tiles at head width
    dh: 1 (dk and dv together), 2 at dh 256 (dv, then dk;
    ``Cfg<DH>::kColWalks``)."""
    return 2 if dh > 128 else 1


FLASH_BWD_TC_Q_ROWS = 32          # query rows of a dk/dv step


def flash_bwd_tc_smem_bytes(pass_: int, dh: int) -> int:
    """Dynamic shared memory one block of tensor-core backward pass
    ``pass_`` (0 row statistics, 1 dk/dv, 2 dq) asks for at head width dh
    (csrc/flash_attention_bwd_tc.cu, ``Cfg<DH>::kRowBytes / kColBytes``)."""
    chunks, st = -(-dh // 64), flash_bwd_tc_stages(pass_, dh)
    if pass_ == 1:      # Q, dO; lse, D and positions of each row
        rows, per_stage = FLASH_BWD_TC_Q_ROWS, 12 * FLASH_BWD_TC_Q_ROWS
    else:               # K, V; the keys' positions
        rows = flash_bwd_tc_key_rows(dh)
        per_stage = 4 * rows
    return (2 * chunks * 16384 + 2 * st * chunks * 128 * rows
            + st * (per_stage + 8) + (1 + 2 * st) * 8 + 1024)


def outside_flash_bwd_tc_envelope(b: int, h: int, dh: int
                                  ) -> Optional[str]:
    """None when the tensor-core backward takes B batch rows of H query
    heads at head width dh, else the limit it breaks, named."""
    if dh not in FLASH_BWD_TC_HEAD_DIMS:
        return (f"head_dim={dh} has no tensor-core backward instantiation "
                f"({FLASH_BWD_TC_HEAD_DIMS})")
    need = max(flash_bwd_tc_smem_bytes(p, dh) for p in range(3))
    if need > SMEM_MAX_BYTES:
        return (f"head_dim={dh} needs {need} bytes of shared memory; the "
                f"H100 limit per block is {SMEM_MAX_BYTES}")
    if b * h > MAX_DESIGNS:
        return (f"B*H={b * h} exceeds the grid's y limit of "
                f"{MAX_DESIGNS}")
    return None


def outside_flash_bwd_envelope(b: int, s: int, h: int, dh: int
                               ) -> Optional[str]:
    """None when the backward kernel takes B batch rows of H heads over S
    queries at head width dh, else the limit it breaks, named."""
    if dh > FLASH_BWD_MAX_HEAD_DIM:
        return (f"head_dim={dh} exceeds the backward kernel's tiles, "
                f"compiled for head_dim <= {FLASH_BWD_MAX_HEAD_DIM}")
    need = max(flash_bwd_smem_bytes(p, dh) for p in range(3))
    if need > SMEM_MAX_BYTES:
        return (f"head_dim={dh} needs {need} bytes of shared memory; the "
                f"H100 limit per block is {SMEM_MAX_BYTES}")
    blocks = -(-s // flash_bwd_tile(dh)) * b * h
    if blocks > MAX_BLOCKS_1D:
        return (f"{blocks} backward blocks exceed the grid's x limit of "
                f"{MAX_BLOCKS_1D}")
    return None
