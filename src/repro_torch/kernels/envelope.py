"""The Hopper envelope of the hand-written kernels: the fused classifier
bank kernels, the population quantizer, the Monte-Carlo kernel and the
flash-attention kernel.

The reference's limits (``repro/kernels/envelope.py``: ``MAX_UNROLL_BITS``,
``MAX_CHANNELS``, ``VMEM_BUDGET_F32``) describe a TPU: how far a one-hot
selection sum unrolls and what fits a VMEM tile. None of them binds the
CUDA kernels, which gather from a table and stream one sample row per
thread. What binds them on an H100 is that one block stages one design's
resident operands in shared memory:

    table (F, 2^N) + W1 (F, H) + b1 (H) + W2 (H, O) + b2 (O) + 2 range rows (F)

for an MLP design (SVM: table + W (F, O) + b (O) + 2 rows), all float32.
A block may use at most 227 KB (232,448 bytes) of shared memory; above
48 KB only as dynamic shared memory after
``cudaFuncAttributeMaxDynamicSharedMemorySize`` is raised (the launcher
in csrc/qmlp_bank.cu does so). The design axis is the grid's y dimension,
at most 65,535. Hidden and output widths of any size run in register
chunks, and M is bounded only by 64-bit offsets.

The population quantizer (csrc/adc_quantize.cu) stages one individual's
table (C, 2^N) and the two range rows (C) in shared memory, under the same
227 KB limit (above 48 KB its launcher raises the attribute too); the
population axis is the grid's y dimension, at most 65,535.

The Monte-Carlo kernel (csrc/mc_eval.cu) stages, per (design,
instance), its leaves (C, 2^N) in shared memory as keys, widths and
values: ``12 * C * 2^N`` bytes for both the nominal and the calibrated
variant (the two drifted range rows are read into registers), under the
same 227 KB limit (its launcher raises the attribute above 48 KB).
The (design, instance) axis is the grid's x dimension, M's chunks its y
dimension, each looped beyond the grid's limit. ``mc_geometry`` gives its
launch geometry (``mc_eval_geometry`` in the built library returns the
same).

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


def quantize_smem_bytes(c: int, n: int) -> int:
    """Shared memory one quantizer block stages: the (C, 2^N) table and
    the two (C,) range rows, float32."""
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
MC_MAX_GRID_X = 2 ** 31 - 1       # gridDim.x
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


def mc_geometry(p: int, s: int, m: int, c: int, n: int) -> McGeometry:
    """The launch geometry of one Monte-Carlo call, M >= 1: M cut into
    chunks whose x fits ``MC_CHUNK_BYTES`` (it stays in L1 while a block
    walks it), and finer where P*S alone gives fewer than
    ``MC_MIN_BLOCKS`` blocks; each chunk a whole number of batches of
    ``MC_BATCH`` rows for every row lane."""
    ceil = lambda a, b: -(-a // b)                      # noqa: E731
    lanes = 1 if c >= MC_THREADS else MC_THREADS // c
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
