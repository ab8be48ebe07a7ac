"""Port parity, flash attention: the plain version behind
repro_torch.kernels.flash_attention (and models.layers.attention, which
routes to it) against the JAX package's Pallas kernel run in interpret
mode and its jnp ``layers.attention``, on numpy-seeded inputs; plus the
wrapper's routing, checks, envelope and build.

Tolerances: float32 rtol=atol=2e-5, the JAX package's own kernel test
(tests/test_kernels.py); the port computes one-pass softmax scores per q
block where the Pallas kernel runs an online softmax over kv blocks, so
the two round differently (measured: at most 7.5e-8). bfloat16:
rtol=atol=8e-3, two bf16 ulps at the outputs' magnitude (< 1); both
packages round p to bf16 before P.V, but relative to different running
maxima, and round the output to bf16 (measured: 9.8e-4, one ulp). On the
card (kernel against plain) bfloat16 uses chip_smoke.py's limit, two ulps
of the output (rtol=2^-6) with atol=2^-7, on inputs drawn so the softmax
is peaked and the outputs are O(1)."""
import pytest

torch = pytest.importorskip("torch")

import types  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention import flash_attention_pallas  # noqa
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels import (_build, dispatch, envelope,  # noqa: E402
                                 flash_attention, ops, ref)
from repro_torch.models import layers  # noqa: E402

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=8e-3, atol=8e-3)
CARD_BF16_TOL = dict(rtol=2 ** -6, atol=2 ** -7)
LOG2E = 1.4426950408889634        # the tensor-core kernel's exp2 factor

# (b, s, h, kv, dh, window, softcap): the four cases of
# tests/test_kernels.py::test_flash_kernel_matches_attention
CASES = [(1, 64, 4, 2, 16, 0, 0.0),
         (2, 128, 4, 4, 32, 0, 30.0),       # MHA + softcap
         (1, 128, 8, 2, 16, 48, 0.0),       # GQA + sliding window
         (1, 96, 2, 1, 8, 0, 0.0)]          # MQA, non-pow2 seq


def _qkv(rng, b, s, h, kv, dh, sk=None):
    sk = s if sk is None else sk
    q = (rng.normal(size=(b, s, h, dh)) * 0.3).astype(np.float32)
    k = (rng.normal(size=(b, sk, kv, dh)) * 0.3).astype(np.float32)
    v = (rng.normal(size=(b, sk, kv, dh)) * 0.3).astype(np.float32)
    return q, k, v


def _pallas(q, k, v, qpos, kpos, *, window=0, cap=0.0, dtype=jnp.float32):
    out = flash_attention_pallas(
        jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(v, dtype),
        jnp.asarray(qpos), jnp.asarray(kpos), causal=True, window=window,
        attn_softcap=cap, q_block=32, kv_block=32, interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _port(q, k, v, qpos, kpos, *, window=0, cap=0.0, dtype=torch.float32):
    t = lambda a: torch.from_numpy(a).to(dtype)  # noqa: E731
    out = ops.flash_attention(t(q), t(k), t(v), torch.from_numpy(qpos),
                              torch.from_numpy(kpos), causal=True,
                              window=window, attn_softcap=cap)
    return out.float().numpy()


@pytest.mark.parametrize("b,s,h,kv,dh,win,cap", CASES)
def test_plain_matches_pallas_interpret(b, s, h, kv, dh, win, cap):
    rng = np.random.default_rng(s + h)
    q, k, v = _qkv(rng, b, s, h, kv, dh)
    pos = np.arange(s, dtype=np.int32)
    want = _pallas(q, k, v, pos, pos, window=win, cap=cap)
    got = _port(q, k, v, pos, pos, window=win, cap=cap)
    np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("b,s,h,kv,dh,win,cap", CASES)
def test_layers_attention_matches_jax_attention(b, s, h, kv, dh, win, cap):
    """The port's layers.attention (the prefill's call) against the JAX
    package's jnp layers.attention, which its prefill calls."""
    rng = np.random.default_rng(7 * s + h)
    q, k, v = _qkv(rng, b, s, h, kv, dh)
    pos = np.arange(s, dtype=np.int32)
    want = np.asarray(jlayers.attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_positions=jnp.asarray(pos), k_positions=jnp.asarray(pos),
        causal=True, window=win or None, attn_softcap=cap, q_block=32))
    got = layers.attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_positions=torch.from_numpy(pos), k_positions=torch.from_numpy(pos),
        causal=True, window=win or None, attn_softcap=cap).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_empty_key_slots_are_masked():
    """k_positions holding -1 (empty cache slots) are never attended."""
    rng = np.random.default_rng(11)
    q, k, v = _qkv(rng, 2, 64, 4, 2, 16)
    pos = np.arange(64, dtype=np.int32)
    kpos = pos.copy()
    kpos[rng.choice(64, size=20, replace=False)] = -1
    kpos[0] = 0                        # row 0 keeps its diagonal key
    want = _pallas(q, k, v, pos, kpos)
    got = _port(q, k, v, pos, kpos)
    np.testing.assert_allclose(got, want, **F32_TOL)
    # the same as attention over the surviving keys alone
    keep = kpos >= 0
    sub = _port(q, np.ascontiguousarray(k[:, keep]),
                np.ascontiguousarray(v[:, keep]), pos, kpos[keep])
    np.testing.assert_allclose(got, sub, **F32_TOL)


def test_fully_masked_row_is_zero():
    """A query that sees no key (all its keys in its future) gives 0, in
    both packages, and the other rows are unaffected."""
    rng = np.random.default_rng(12)
    q, k, v = _qkv(rng, 1, 64, 2, 2, 16)
    qpos = np.arange(64, dtype=np.int32)
    kpos = np.arange(64, dtype=np.int32) + 8      # rows 0..7 see nothing
    want = _pallas(q, k, v, qpos, kpos)
    got = _port(q, k, v, qpos, kpos)
    np.testing.assert_allclose(got, want, **F32_TOL)
    assert np.all(got[:, :8] == 0.0)
    assert np.all(np.abs(got[:, 8:]).max(axis=(2, 3)) > 0)


def test_bf16_matches_pallas_interpret():
    rng = np.random.default_rng(13)
    q, k, v = _qkv(rng, 2, 64, 4, 2, 32)
    pos = np.arange(64, dtype=np.int32)
    want = _pallas(q, k, v, pos, pos, window=40, cap=20.0,
                   dtype=jnp.bfloat16)
    got = _port(q, k, v, pos, pos, window=40, cap=20.0,
                dtype=torch.bfloat16)
    np.testing.assert_allclose(got, want, **BF16_TOL)


def test_plain_is_independent_of_q_block_and_ragged():
    """A ragged S and Sk that cross the plain version's block of
    FLASH_Q_BLOCK query rows give JAX's jnp attention taken in one block;
    no keys at all give 0."""
    rng = np.random.default_rng(14)
    s = ref.FLASH_Q_BLOCK + 13
    q, k, v = _qkv(rng, 1, s, 2, 1, 8)
    pos = np.arange(s, dtype=np.int32)
    want = np.asarray(jlayers.attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_positions=jnp.asarray(pos), k_positions=jnp.asarray(pos),
        causal=True, window=300, attn_softcap=0.0, q_block=s))
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    got = ref.flash_attention_ref(t(q), t(k), t(v), t(pos), t(pos),
                                  window=300)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    empty = ref.flash_attention_ref(t(q), t(k[:, :0]), t(v[:, :0]), t(pos),
                                    t(pos[:0]))
    assert torch.equal(empty, torch.zeros_like(empty))


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_nothing():
    rng = np.random.default_rng(15)
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 1, 40, 4, 2, 16))
    pos = torch.arange(40, dtype=torch.int32)
    flash_attention.reset_launches()
    got = flash_attention.flash_attention(q, k, v, pos, pos, window=16,
                                          attn_softcap=10.0)
    want = ref.flash_attention_ref(q, k, v, pos, pos, window=16,
                                   attn_softcap=10.0)
    assert torch.equal(got, want)
    # bf16 at a tensor-core head width: the plain version too, on the CPU
    qb, kb, vb = (torch.from_numpy(a).to(torch.bfloat16)
                  for a in _qkv(rng, 1, 40, 4, 2, 64))
    got = flash_attention.flash_attention(qb, kb, vb, pos, pos)
    assert torch.equal(got, ref.flash_attention_ref(qb, kb, vb, pos, pos))
    assert flash_attention.launches == {"flash_attention": 0,
                                        "flash_attention_tc": 0,
                                        "flash_attention_bwd": 0,
                                        "flash_attention_bwd_tc": 0}
    assert flash_attention.total_launches() == 0


def test_wrapper_rejects_bad_shapes():
    q = torch.zeros(1, 8, 4, 16)
    k = torch.zeros(1, 8, 2, 16)
    pos = torch.arange(8, dtype=torch.int32)
    bad = [(torch.zeros(8, 4, 16), k, k, pos, pos),          # q rank
           (q, k, torch.zeros(1, 8, 2, 8), pos, pos),         # v != k
           (q, torch.zeros(1, 8, 2, 8), torch.zeros(1, 8, 2, 8), pos, pos),
           (q, torch.zeros(2, 8, 2, 16), torch.zeros(2, 8, 2, 16), pos, pos),
           (q, torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 3, 16), pos, pos),
           (q, k, k, pos[:4], pos),
           (q, k, k, pos, pos[:4])]
    for args in bad:
        with pytest.raises(ValueError, match="flash_attention"):
            flash_attention.flash_attention(*args)


def _fake_cuda(shape, dtype=torch.float32):
    """Stand-in for a CUDA tensor: resolve_flash reads device, shape and
    dtype."""
    return types.SimpleNamespace(device=torch.device("cuda", 0), shape=shape,
                                 dtype=dtype)


def _config_head_dims():
    """{arch: head width} of every attention config of the port."""
    from repro_torch.configs import ARCH_NAMES, get_config
    return {name: get_config(name).resolved_head_dim for name in ARCH_NAMES
            if get_config(name).num_heads}


def test_dispatch_rules():
    q = torch.zeros(2, 16, 4, 64)
    res = dispatch.resolve_flash("flash_attention", q)
    assert (res.path, res.device) == ("plain", "cpu")
    # musicgen-medium's prefill and gemma2's head width take the kernel
    for shape in ((4, 2048, 24, 64), (1, 4096, 8, 256)):
        res = dispatch.resolve_flash("flash_attention", _fake_cuda(shape))
        assert (res.path, res.device) == ("kernel", "cuda:0")
    with pytest.raises(ValueError, match="head_dim=320"):
        dispatch.resolve_flash("flash_attention",
                               _fake_cuda((1, 16, 4, 320)))
    with pytest.raises(ValueError, match="grid"):
        dispatch.resolve_flash("flash_attention",
                               _fake_cuda((65536, 16, 2, 64)))
    with pytest.raises(ValueError, match="unsupported device"):
        dispatch.resolve_flash("flash_attention", q.to("meta"))
    # routes: float32 -> the CUDA-core kernel; bf16 at every config head
    # width -> the tensor-core kernel; bf16 off that list -> CUDA cores
    assert res.route == "cuda_core"
    assert dispatch.resolve_flash("flash_attention", q).route == "plain"
    widths = sorted(set(_config_head_dims().values()))
    assert widths == list(envelope.FLASH_TC_HEAD_DIMS)
    for dh in widths:
        res = dispatch.resolve_flash(
            "flash_attention", _fake_cuda((4, 2048, 8, dh), torch.bfloat16))
        assert (res.path, res.route) == ("kernel", "tensor_core")
        assert res.as_dict()["route"] == "tensor_core"
        res = dispatch.resolve_flash("flash_attention",
                                     _fake_cuda((4, 2048, 8, dh)))
        assert (res.path, res.route) == ("kernel", "cuda_core")
    for dh in (8, 16, 32, 80, 160, 192):
        res = dispatch.resolve_flash(
            "flash_attention", _fake_cuda((1, 64, 4, dh), torch.bfloat16))
        assert (res.path, res.route) == ("kernel", "cuda_core")
    cpu16 = dispatch.resolve_flash("flash_attention",
                                   torch.zeros(1, 8, 2, 64,
                                               dtype=torch.bfloat16))
    assert (cpu16.path, cpu16.route) == ("plain", "plain")
    with pytest.raises(ValueError, match="grid"):
        dispatch.resolve_flash("flash_attention",
                               _fake_cuda((65536, 16, 2, 64), torch.bfloat16))
    assert envelope.flash_route(True, 64) == "tensor_core"
    assert envelope.flash_route(False, 64) == "cuda_core"
    assert envelope.flash_route(True, 72) == "cuda_core"


def test_envelope_is_shared_memory_and_registers():
    # the CUDA-core kernel: smem_of<Layout> of csrc/flash_attention.cu,
    # q, two K and two V buffers, p^T (BK x (BQ + 4)), two ints; at
    # DHP 64 q^T (64 x (BQ + 4)) and K^T (64 x (BK + 4)) are d-major
    assert envelope.flash_smem_bytes(64) == 4 * (
        64 * 260 + 2 * 64 * 68 + 2 * 64 * 64 + 64 * 260) + 8 == 200_712
    assert envelope.flash_smem_bytes(128) == 4 * (
        128 * 132 + 2 * 32 * 132 + 2 * 32 * 128 + 32 * 132) + 8 == 151_048
    assert envelope.flash_smem_bytes(256) == 4 * (
        64 * 260 + 2 * 32 * 260 + 2 * 32 * 256 + 32 * 68) + 8 == 207_368
    assert [envelope.flash_head_pad(d) for d in (8, 64, 65, 96, 128, 129,
                                                 256)] == [
        64, 64, 128, 128, 128, 256, 256]
    assert [envelope.flash_tiles(d) for d in (64, 128, 256)] == [
        (256, 64, 8), (128, 32, 16), (64, 32, 16)]
    for dh in (1, 16, 32, 64, 96, 112, 128, 160, 256):
        assert envelope.flash_smem_bytes(dh) == envelope.flash_smem_bytes(
            envelope.flash_head_pad(dh))
    assert envelope.flash_smem_bytes(256) <= envelope.SMEM_MAX_BYTES
    assert envelope.flash_smem_bytes(64) > envelope.SMEM_DEFAULT_BYTES
    assert envelope.outside_flash_envelope(4, 24, 64) is None
    assert envelope.outside_flash_envelope(1, 8, 256) is None
    assert "register tile" in envelope.outside_flash_envelope(1, 8, 257)
    assert "grid" in envelope.outside_flash_envelope(
        1, envelope.MAX_DESIGNS + 1, 64)
    # the tensor-core kernel: Cfg<DH>::kBytes of csrc/flash_attention_tc.cu
    assert envelope.flash_tc_smem_bytes(64) == (
        2 * 64 * (128 + 6 * 128) + 3 * 4 * 128 + 24 + 56 + 1024) == 117_328
    assert envelope.flash_tc_smem_bytes(96) == 165_944
    assert envelope.flash_tc_smem_bytes(112) == 165_944
    assert envelope.flash_tc_smem_bytes(128) == 165_944
    assert envelope.flash_tc_smem_bytes(256) == 198_200
    assert envelope.flash_tc_bk(128) == 128 and envelope.flash_tc_bk(256) == 64
    assert [envelope.flash_tc_stages(d) for d in (64, 128, 256)] == [3, 2, 2]
    for arch, dh in _config_head_dims().items():
        assert envelope.flash_tc_smem_bytes(dh) <= envelope.SMEM_MAX_BYTES, \
            arch
        assert envelope.outside_flash_tc_envelope(4, 64, dh) is None, arch
    assert "no tensor-core" in envelope.outside_flash_tc_envelope(1, 8, 80)
    assert "grid" in envelope.outside_flash_tc_envelope(
        1, envelope.MAX_DESIGNS + 1, 64)


def test_build_lists_the_source():
    assert _build.SOURCES["flash_attention"].name == "flash_attention.cu"
    assert _build.SOURCES["flash_attention"].is_file()
    path = _build.library_path("flash_attention")
    assert path.name.startswith("libflash_attention-")
    src = _build.SOURCES["flash_attention"].read_text()
    assert "flash_attention.py:74" in src       # what it replaces
    assert "cudaGetLastError" in src
    tc = _build.SOURCES["flash_attention_tc"]
    assert tc.name == "flash_attention_tc.cu" and tc.is_file()
    assert _build.library_path("flash_attention_tc").name.startswith(
        "libflash_attention_tc-")
    src = tc.read_text()
    assert "flash_attention.py:74" in src
    assert "cudaGetLastError" in src
    for word in ("wgmma.mma_async", "cp.async.bulk.tensor.4d",
                 "cuTensorMapEncodeTiled", "__grid_constant__"):
        assert word in src, word
    src = _build.SOURCES["flash_attention"].read_text()
    for word in ("cp.async.cg.shared.global", "flash_attention_smem_bytes",
                 "exp2f", "__syncwarp"):
        assert word in src, word
    assert "--use_fast_math" not in " ".join(_build.NVCC_FLAGS)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_card(dtype):
    """On the card: the CUDA kernel against its plain version on a GQA,
    sliding-window, softcapped, ragged call with empty key slots, the
    launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(16)
    dt = getattr(torch, dtype)
    dev = torch.device("cuda")
    q = rng.normal(size=(2, 200, 8, 64)) * 1.5
    k = rng.normal(size=(2, 203, 2, 64)) * 1.5
    v = rng.normal(size=(2, 203, 2, 64)) + 1.0
    q, k, v = (torch.from_numpy(a).to(dev, dt) for a in (q, k, v))
    qpos = torch.arange(3, 203, dtype=torch.int32, device=dev)
    kpos = torch.arange(203, dtype=torch.int32, device=dev)
    kpos[::7] = -1
    key = "flash_attention_tc" if dtype == "bfloat16" else "flash_attention"
    before = flash_attention.launches[key]
    got = ops.flash_attention(q, k, v, qpos, kpos, window=50,
                              attn_softcap=30.0)
    want = ref.flash_attention_ref(q, k, v, qpos, kpos, window=50,
                                   attn_softcap=30.0)
    torch.cuda.synchronize()
    assert flash_attention.launches[key] == before + 1
    tol = F32_TOL if dtype == "float32" else CARD_BF16_TOL
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dh", [64, 96, 112, 128, 256])
def test_tensor_core_kernel_matches_plain_on_card(dh):
    """On the card: the tensor-core kernel at each head width against the
    plain version, GQA, ragged S and Sk, a window and empty key slots,
    counted on its own key."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(17 + dh)
    dev = torch.device("cuda")
    q = rng.normal(size=(2, 261, 8, dh)) * 1.5
    k = rng.normal(size=(2, 300, 2, dh)) * 1.5
    v = rng.normal(size=(2, 300, 2, dh)) + 1.0
    q, k, v = (torch.from_numpy(a).to(dev, torch.bfloat16) for a in (q, k, v))
    qpos = torch.arange(39, 300, dtype=torch.int32, device=dev)
    kpos = torch.arange(300, dtype=torch.int32, device=dev)
    kpos[::11] = -1
    before = dict(flash_attention.launches)
    got = flash_attention.flash_attention(q, k, v, qpos, kpos, window=120)
    want = ref.flash_attention_ref(q, k, v, qpos, kpos, window=120)
    torch.cuda.synchronize()
    assert flash_attention.launches["flash_attention_tc"] == \
        before["flash_attention_tc"] + 1
    assert flash_attention.launches["flash_attention"] == \
        before["flash_attention"]
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **CARD_BF16_TOL)


def _tc_schedule(q, k, v, qpos, kpos, *, bk, causal=True, window=0, cap=0.0):
    """float32/bf16 emulation of csrc/flash_attention_tc.cu's schedule at
    its kv tile of ``bk`` keys: the softmax in log2 units (x = scores
    times log2(e), p = exp2(x - m)), running max over the tiles, p
    rounded to bf16 against the running max before P.V (f32
    accumulation), corr rescale of acc and l, l summing the unrounded p,
    out in bf16. q, k, v bf16 (B, S, H, dh), (B, Sk, KV, dh); positions
    int32."""
    b, s, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    kf = k.float().repeat_interleave(rep, dim=2)          # (B, Sk, H, dh)
    vf = v.float().repeat_interleave(rep, dim=2)
    qf = q.float()
    m = torch.full((b, h, s), ref.FLASH_NEG)
    l = torch.zeros(b, h, s)
    acc = torch.zeros(b, h, s, dh)
    for k0 in range(0, sk, bk):
        kt, vt = kf[:, k0:k0 + bk], vf[:, k0:k0 + bk]
        kp = kpos[k0:k0 + bk].long()
        sc = torch.einsum("bqhd,bkhd->bhqk", qf, kt) * (1.0 / np.sqrt(dh))
        if cap:
            sc = torch.tanh(sc / cap) * cap
        dpos = qpos.long()[:, None] - kp[None, :]
        ok = (kp >= 0)[None, :].expand(s, -1)
        if causal:
            ok = ok & (dpos >= 0)
        if window:
            ok = ok & (dpos < window)
        sc = torch.where(ok, sc * LOG2E, ref.FLASH_NEG)   # log2 units
        m_new = torch.maximum(m, sc.amax(-1))
        corr = torch.where(m <= ref.FLASH_NEG, 0.0, torch.exp2(m - m_new))
        p = torch.where((m_new <= ref.FLASH_NEG)[..., None], 0.0,
                        torch.exp2(sc - m_new[..., None]))
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(torch.bfloat16).float(), vt)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(torch.bfloat16)


@pytest.mark.parametrize("b,s,sk,h,kv,dh,win,cap", [
    (1, 512, 512, 4, 2, 64, 0, 0.0),          # smoke-sized causal, BK 128
    (2, 300, 300, 4, 2, 112, 100, 0.0),       # ragged, windowed, dh padded
    (1, 260, 260, 2, 1, 256, 0, 50.0),        # gemma2's width, BK 64
])
def test_tensor_core_schedule_within_card_bf16_limit(b, s, sk, h, kv, dh,
                                                     win, cap):
    """Before any chip run: the tensor-core kernel's schedule at its own kv
    tile (p rounded to bf16 against the online max of 64- or 128-key
    tiles) stays inside chip_smoke.py's bf16 limit (rtol 2^-6, atol 2^-7)
    of the plain version, on inputs drawn as chip_smoke.py draws them
    (q, k ~ N(0, 1.5^2), v ~ N(1, 1)). The share of the limit is printed."""
    rng = np.random.default_rng(31 + dh)
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).to(  # noqa: E731
        torch.bfloat16)
    q = bf(rng.normal(size=(b, s, h, dh)) * 1.5)
    k = bf(rng.normal(size=(b, sk, kv, dh)) * 1.5)
    v = bf(rng.normal(size=(b, sk, kv, dh)) + 1.0)
    qpos = torch.arange(s, dtype=torch.int32)
    kpos = torch.arange(sk, dtype=torch.int32)
    kw = dict(causal=True, window=win, attn_softcap=cap)
    want = ref.flash_attention_ref(q, k, v, qpos, kpos, **kw).float()
    got = _tc_schedule(q, k, v, qpos, kpos, bk=envelope.flash_tc_bk(dh),
                       causal=True, window=win, cap=cap).float()
    share = float(((got - want).abs() / (CARD_BF16_TOL["atol"]
                                        + CARD_BF16_TOL["rtol"] * want.abs())
                   ).max())
    print(f"tensor-core schedule dh={dh} bk={envelope.flash_tc_bk(dh)}: "
          f"{share:.3f} of the card's bf16 limit")
    assert share <= 1.0
    np.testing.assert_allclose(got.numpy(), want.numpy(), **CARD_BF16_TOL)


def _ex2(x):
    """ex2.approx.ftz: 2^x with results below 2^-126 flushed to 0."""
    e = torch.exp2(x)
    return torch.where(e < 2.0 ** -126, torch.zeros_like(e), e)


def _cuda_core_schedule(q, k, v, qpos, kpos, *, causal=True, window=0,
                        cap=0.0):
    """float32 emulation of csrc/flash_attention.cu's schedule: q tiles,
    kv tiles and row groups of envelope.flash_tiles(dh); q scaled once by
    scale * log2(e) in float32 (by scale under a softcap, log2(e) after
    tanh); each kv tile classified from the q tile's min/max query
    position (masked: skipped; full: no mask; partial: the per-element
    rule; the kernel classifies per warp, which skips more tiles and
    changes no value: a masked tile leaves a row as it was); the online
    softmax in log2 units with ex2.approx.ftz, corr = ex2(m - m_new)
    without a guard, p = ex2(x - m_new), or ex2(x - 1e30) on a row that
    has seen no key; each lane tx of a row group summing p over its keys
    tx + lanes j in key order, its share of l rescaled by corr, the
    shares reduced at the end by the xor butterfly. Returns (out in
    float32, the count of each tile kind)."""
    b, s, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    bq, bk, lanes = envelope.flash_tiles(dh)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    scale = f32(1.0 / np.sqrt(dh))                       # ctypes c_float
    qmul = scale if cap else scale * f32(LOG2E)
    qs = (q.float() * qmul).permute(0, 2, 1, 3)           # (B, H, S, dh)
    kf = k.float().repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)
    vf = v.float().repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)
    n_tiles = -(-sk // bk)
    kp_all = torch.full((n_tiles * bk,), -1, dtype=torch.int64)
    kp_all[:sk] = kpos.long()
    keys = torch.arange(bk)
    lane_of = keys % lanes
    # owned[tx] = the keys of lane tx in the order it sums them
    owned = torch.stack([keys[lane_of == tx] for tx in range(lanes)])
    out = torch.zeros(b, h, s, dh)
    kinds = {"masked": 0, "full": 0, "partial": 0}
    for q0 in range(0, s, bq):
        qp = qpos[q0:q0 + bq].long()
        rows = qp.shape[0]
        qmin, qmax = int(qp.min()), int(qp.max())
        m = torch.full((b, h, rows), ref.FLASH_NEG)
        l_lane = torch.zeros(b, h, rows, lanes)
        acc = torch.zeros(b, h, rows, dh)
        for t in range(n_tiles):
            kp = kp_all[t * bk:(t + 1) * bk]
            live = kp >= 0
            full = kp >= 0
            if causal:
                live, full = live & (kp <= qmax), full & (kp <= qmin)
            if window > 0:
                live = live & (qmin - kp < window)
                full = full & (qmax - kp < window)
            if not bool(live.any()):
                kinds["masked"] += 1
                continue
            kind = "full" if bool(full.all()) else "partial"
            kinds[kind] += 1
            ks = slice(t * bk, min((t + 1) * bk, sk))
            n = ks.stop - ks.start
            x = torch.zeros(b, h, rows, bk)
            x[..., :n] = torch.einsum("bhqd,bhkd->bhqk",
                                      qs[:, :, q0:q0 + rows], kf[:, :, ks])
            if cap:
                x = torch.tanh(x / f32(cap)) * f32(cap) * f32(LOG2E)
            if kind == "partial":
                dpos = qp[:, None] - kp[None, :]
                ok = (kp >= 0)[None, :].expand(rows, -1)
                if causal:
                    ok = ok & (dpos >= 0)
                if window > 0:
                    ok = ok & (dpos < window)
                x = torch.where(ok, x, f32(ref.FLASH_NEG))
            m_new = torch.maximum(m, x.amax(-1))
            corr = _ex2(m - m_new)
            sub = torch.where(m_new <= ref.FLASH_NEG, f32(-ref.FLASH_NEG),
                              m_new)
            p = _ex2(x - sub[..., None])
            share = torch.zeros(b, h, rows, lanes)
            for j in range(owned.shape[1]):               # in key order
                share = share + p[..., owned[:, j]]
            l_lane = l_lane * corr[..., None] + share
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p[..., :n], vf[:, :, ks])
            m = m_new
        off = lanes // 2
        while off:
            l_lane = l_lane + l_lane[..., torch.arange(lanes) ^ off]
            off //= 2
        out[:, :, q0:q0 + rows] = acc / torch.clamp(
            l_lane[..., :1], min=1e-30)
    return out.permute(0, 2, 1, 3), kinds


def _pallas_padded(q, k, v, qpos, kpos, *, window, cap):
    """The JAX package's Pallas kernel (interpret mode, 32-row blocks) on
    a ragged call: q rows and k/v keys padded to a multiple of 32, the
    padded keys at position -1, the padded rows cut off."""
    s, sk = q.shape[1], k.shape[1]
    ps, psk = -(-s // 32) * 32, -(-sk // 32) * 32
    pad = lambda a, n: np.concatenate(  # noqa: E731
        [a, np.zeros((a.shape[0], n - a.shape[1]) + a.shape[2:], a.dtype)],
        axis=1)
    qp = np.concatenate([qpos, np.full(ps - s, qpos[-1], np.int32)])
    kp = np.concatenate([kpos, np.full(psk - sk, -1, np.int32)])
    return _pallas(pad(q, ps), pad(k, psk), pad(v, psk), qp, kp,
                   window=window, cap=cap)[:, :s]


@pytest.mark.parametrize("b,s,sk,h,kv,dh,win,cap,qstart,kstart,hole,kinds", [
    # ragged causal at musicgen's width: 256 x 64 tiles, all three kinds
    (1, 600, 600, 4, 2, 64, 0, 0.0, 0, 0, 0, "mfp"),
    # softcap, Sk > S (queries at the end of the keys), MHA
    (2, 300, 320, 4, 4, 32, 0, 30.0, 20, 0, 0, "fp"),
    # GQA + sliding window: tiles before the window are masked
    (1, 300, 300, 8, 2, 16, 48, 0.0, 0, 0, 0, "mp"),
    # phi3's width (DHP 128: 128 x 32 tiles)
    (1, 300, 300, 2, 1, 96, 0, 0.0, 0, 0, 0, "mfp"),
    # gemma2's width (DHP 256: 64 x 32 tiles), window, softcap, empty slots
    (1, 300, 300, 4, 2, 256, 150, 50.0, 0, 0, 97, "mfp"),
    # fully masked rows (keys start at 100) and empty slots
    (2, 192, 192, 4, 2, 64, 0, 0.0, 0, 100, 5, "mp"),
])
def test_cuda_core_schedule_within_f32_limit(b, s, sk, h, kv, dh, win, cap,
                                             qstart, kstart, hole, kinds):
    """Before any chip run: the CUDA-core kernel's float32 schedule (its
    tiles, the three tile kinds, exp2 with log2(e) folded into the q
    scale, per-lane row sums reduced by the butterfly) within rtol = atol
    = 2e-5 of the plain version and of the JAX package's Pallas kernel in
    interpret mode, on inputs drawn as chip_smoke.py draws them."""
    rng = np.random.default_rng(7 * dh + s)
    q = (rng.normal(size=(b, s, h, dh)) * 1.5).astype(np.float32)
    k = (rng.normal(size=(b, sk, kv, dh)) * 1.5).astype(np.float32)
    v = (rng.normal(size=(b, sk, kv, dh)) + 1.0).astype(np.float32)
    qpos = np.arange(qstart, qstart + s, dtype=np.int32)
    kpos = np.arange(kstart, kstart + sk, dtype=np.int32)
    if hole:
        kpos[::hole] = -1
    t = torch.from_numpy
    got, seen = _cuda_core_schedule(t(q), t(k), t(v), t(qpos), t(kpos),
                                    window=win, cap=cap)
    assert {key[0] for key, n in seen.items() if n} == set(kinds), seen
    want = ref.flash_attention_ref(t(q), t(k), t(v), t(qpos), t(kpos),
                                   window=win, attn_softcap=cap)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)
    jax_out = _pallas_padded(q, k, v, qpos, kpos, window=win, cap=cap)
    np.testing.assert_allclose(got.numpy(), jax_out, **F32_TOL)
    if kstart:
        assert not got[:, :kstart - qstart].any()
