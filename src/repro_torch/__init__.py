"""PyTorch/CUDA port of the ``repro`` package for NVIDIA Hopper (H100).

The JAX package ``repro`` stays the reference; this package mirrors its
module layout (``repro_torch.core.deploy`` <-> ``repro.core.deploy`` and so
on) so every port file has an obvious counterpart. It imports ``torch``
and ``numpy`` only: never ``jax`` and nothing of ``repro``.

Two slices are ported. The in-training search (``core.search``): NSGA-II
over pruned-ADC genomes with batched QAT of the printed MLP/SVM, each
generation quantizing the shared data through the whole population in one
launch of the hand-written quantizer (``kernels/csrc/adc_quantize.cu``),
and ``core.deploy.export_front`` turning the front into deployable
designs. Deployment serving: an exported front is loaded
(``core.deploy.load_front``), stacked into one multi-design bank and
served through the hand-written bank kernels
(``kernels/csrc/qmlp_bank.cu``) by the fixed-microbatch driver
(``launch.serve_classifier``). ``api`` wraps both as verbs. Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``
(``device.resolve_device``); on a CPU tensor every kernel wrapper runs its
plain PyTorch version.
"""

__version__ = "0.1.0"
