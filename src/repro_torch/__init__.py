"""PyTorch/CUDA port of the ``repro`` package for NVIDIA Hopper (H100).

The JAX package ``repro`` stays the reference; this package mirrors its
module layout (``repro_torch.core.deploy`` <-> ``repro.core.deploy`` and so
on) so every port file has an obvious counterpart. It imports ``torch``
and ``numpy`` only: never ``jax`` and nothing of ``repro``.

The ported slice is deployment serving: an exported ADC+classifier front
is loaded (``core.deploy.load_front``), stacked into one multi-design bank
and served through the hand-written Hopper bank kernels
(``kernels/csrc/qmlp_bank.cu``) by the fixed-microbatch driver
(``launch.serve_classifier``). Entry points run on ``cuda`` unless the
caller passes ``device="cpu"`` (``device.resolve_device``); on a CPU tensor
every kernel wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"
