"""On the card: both routes of the attention backward against the plain
autograd (``ref.flash_attention_bwd_ref`` in float32 at the same inputs).
This file imports no JAX, so it runs on a machine with a CUDA card and no
JAX: ``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_flash_bwd_card.py``. Without a card every test skips.

Tolerance (chip_smoke.py's BWD_TOL): bf16 one bf16 ulp of the element
(2^-7 relative) plus 2^-12 of the largest element, float32 1e-5 and 1e-5;
each gradient bitwise the same across two runs (no atomics)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention, ops, ref  # noqa: E402

TOL = {"bfloat16": (2 ** -7, 2 ** -12), "float32": (1e-5, 1e-5)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,dh,key", [
    ("bfloat16", 64, "flash_attention_bwd_tc"),
    ("bfloat16", 112, "flash_attention_bwd_tc"),
    ("bfloat16", 128, "flash_attention_bwd_tc"),
    ("bfloat16", 80, "flash_attention_bwd"),
    ("float32", 64, "flash_attention_bwd")])
def test_backward_routes_match_plain_on_card(dtype, dh, key):
    """GQA, ragged S, a window, a softcap and empty key slots; each call
    counted once on its route's key."""
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
