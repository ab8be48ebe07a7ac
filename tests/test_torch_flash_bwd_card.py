"""On the card: both routes of the attention backward against the plain
autograd (``ref.flash_attention_bwd_ref`` in float32 at the same inputs).
This file imports no JAX, so it runs on a machine with a CUDA card and no
JAX: ``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_flash_bwd_card.py``. Without a card every test skips.

Tolerance (chip_smoke.py's BWD_TOL): bf16 one bf16 ulp of the element
(2^-7 relative) plus 2^-12 of the largest element, float32 1e-5 and 1e-5;
each gradient bitwise the same across two runs (no atomics). A control (a
plain gradient with a fault: a 64-key span dropped, the wrong kv head) is
rejected when every gradient's share of the bound exceeds 1 and the
largest exceeds CONTROL_FACTOR (chip_smoke.py's bwd_control_rejected)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention, ops, ref  # noqa: E402

TOL = {"bfloat16": (2 ** -7, 2 ** -12), "float32": (1e-5, 1e-5)}
CONTROL_FACTOR = 100.0


def _shares(got, want, dtype):
    """Each gradient's largest |got - want| / (rtol |want| + atol
    max|want|), both rounded to ``dtype``."""
    rtol, atol = TOL[str(dtype).split(".")[-1]]
    out = []
    for g, w in zip(got, want):
        w = w.to(dtype).float()
        lim = rtol * w.abs() + atol * w.abs().max()
        out.append(float(((g.to(dtype).float() - w).abs() / lim).max()))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,dh,key", [
    ("bfloat16", 64, "flash_attention_bwd_tc"),
    ("bfloat16", 112, "flash_attention_bwd_tc"),
    ("bfloat16", 128, "flash_attention_bwd_tc"),
    ("bfloat16", 80, "flash_attention_bwd"),
    ("float32", 64, "flash_attention_bwd"),
    ("bfloat16", 256, "flash_attention_bwd_tc"),
    ("float32", 256, "flash_attention_bwd")])
def test_backward_routes_match_plain_on_card(dtype, dh, key):
    """GQA, ragged S, a window, a softcap and empty key slots; each call
    counted once on its route's key (dh 256, gemma2's: bf16 on the
    tensor-core kernel's Cfg<256>, float32 on the CUDA-core kernel's
    32-row tiles)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(37)
    dt = getattr(torch, dtype)
    dev = torch.device("cuda")
    b, s, h, kv = 2, 300, 8, 2
    q = rng.normal(size=(b, s, h, dh)) * 1.5
    k = rng.normal(size=(b, s, kv, dh)) * 1.5
    v = rng.normal(size=(b, s, kv, dh)) + 1.0
    do = rng.normal(size=(b, s, h, dh))
    q, k, v, do = (torch.from_numpy(a).to(dev, dt) for a in (q, k, v, do))
    pos = torch.arange(s, dtype=torch.int32, device=dev)
    kpos = pos.clone()
    kpos[::13] = -1
    kw = dict(window=150, attn_softcap=30.0)
    before = dict(flash_attention.launches)
    got = ops.flash_attention_bwd(q, k, v, do, pos, kpos, **kw)
    again = ops.flash_attention_bwd(q, k, v, do, pos, kpos, **kw)
    want = ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                       do.float(), pos, kpos, **kw)
    torch.cuda.synchronize()
    moved = {n: c - before[n] for n, c in flash_attention.launches.items()
             if c != before[n]}
    assert moved == {key: 2}
    rtol, atol = TOL[dtype]
    for g, a, w in zip(got, again, want):
        assert g.dtype == dt and g.shape == w.shape
        assert torch.equal(g, a)
        w = w.to(dt).float()
        assert bool(((g.float() - w).abs()
                     <= rtol * w.abs() + atol * w.abs().max()).all())


@pytest.mark.gpu
@pytest.mark.parametrize("window", [4096, 0])
def test_gemma2_head_dim_256_tensor_core_backward_on_card(window):
    """gemma2's bf16 dh-256 backward on the tensor-core route at a reduced
    layer (B 1, S 4500, 4 query heads over 2 kv heads, softcap 50; window
    4096 and global): against the plain autograd at BWD_TOL, bitwise
    twice, counted on flash_attention_bwd_tc; both controls (keys
    1024..1087 dropped, the wrong kv head) rejected on every gradient and
    by CONTROL_FACTOR on one. The CUDA-core kernel, called directly on the
    same bf16 inputs, is held to the same bound."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(41)
    dev = torch.device("cuda")
    b, s, h, kv, dh = 1, 4500, 4, 2, 256
    q = rng.normal(size=(b, s, h, dh)) * 1.5
    k = rng.normal(size=(b, s, kv, dh)) * 1.5
    v = rng.normal(size=(b, s, kv, dh)) + 1.0
    do = rng.normal(size=(b, s, h, dh))
    q, k, v, do = (torch.from_numpy(a).to(dev, torch.bfloat16)
                   for a in (q, k, v, do))
    pos = torch.arange(s, dtype=torch.int32, device=dev)
    kw = dict(window=window, attn_softcap=50.0)
    before = dict(flash_attention.launches)
    got = ops.flash_attention_bwd(q, k, v, do, pos, pos, **kw)
    again = ops.flash_attention_bwd(q, k, v, do, pos, pos, **kw)
    want = ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                       do.float(), pos, pos, **kw)
    torch.cuda.synchronize()
    moved = {n: c - before[n] for n, c in flash_attention.launches.items()
             if c != before[n]}
    assert moved == {"flash_attention_bwd_tc": 2}
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    assert max(_shares(got, want, torch.bfloat16)) <= 1.0
    direct = flash_attention._launch_bwd("cuda_core", q, k, v, do, pos, pos,
                                         causal=True, **kw)
    assert max(_shares(direct, want, torch.bfloat16)) <= 1.0
    drop = pos.clone()
    drop[1024:1088] = -1
    wrong = (torch.arange(kv, device=dev) + 1) % kv
    for kk, vv, kp in ((k, v, drop),
                       (k[:, :, wrong].contiguous(),
                        v[:, :, wrong].contiguous(), pos)):
        bad = ref.flash_attention_bwd_ref(q.float(), kk.float(), vv.float(),
                                          do.float(), pos, kp, **kw)
        shares = _shares(bad, want, torch.bfloat16)
        assert min(shares) > 1.0 and max(shares) > CONTROL_FACTOR, shares
