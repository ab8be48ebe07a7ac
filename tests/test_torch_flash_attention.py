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
    assert flash_attention.launches == {"flash_attention": 0}


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


def _fake_cuda(shape):
    """Stand-in for a CUDA tensor: resolve_flash reads device and shape."""
    return types.SimpleNamespace(device=torch.device("cuda", 0), shape=shape)


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


def test_envelope_is_shared_memory_and_registers():
    assert envelope.flash_smem_bytes(64) == 4 * (
        64 * 65 + 64 * 65 + 64 * 64 + 64 * 65) + 4 * 64
    assert envelope.flash_smem_bytes(256) <= envelope.SMEM_MAX_BYTES
    assert envelope.flash_smem_bytes(64) > envelope.SMEM_DEFAULT_BYTES
    assert envelope.outside_flash_envelope(4, 24, 64) is None
    assert envelope.outside_flash_envelope(1, 8, 256) is None
    assert "register tile" in envelope.outside_flash_envelope(1, 8, 257)
    assert "grid" in envelope.outside_flash_envelope(
        1, envelope.MAX_DESIGNS + 1, 64)


def test_build_lists_the_source():
    assert _build.SOURCES["flash_attention"].name == "flash_attention.cu"
    assert _build.SOURCES["flash_attention"].is_file()
    path = _build.library_path("flash_attention")
    assert path.name.startswith("libflash_attention-")
    src = _build.SOURCES["flash_attention"].read_text()
    assert "flash_attention.py:74" in src       # what it replaces
    assert "cudaGetLastError" in src


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
    before = flash_attention.launches["flash_attention"]
    got = ops.flash_attention(q, k, v, qpos, kpos, window=50,
                              attn_softcap=30.0)
    want = ref.flash_attention_ref(q, k, v, qpos, kpos, window=50,
                                   attn_softcap=30.0)
    torch.cuda.synchronize()
    assert flash_attention.launches["flash_attention"] == before + 1
    tol = F32_TOL if dtype == "float32" else CARD_BF16_TOL
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **tol)
