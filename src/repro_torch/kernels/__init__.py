"""Hand-written Hopper kernels and their plain PyTorch versions.

  ref       - plain PyTorch versions of every ported kernel (the CPU path
              and the yardstick the kernels are held to on the card).
  qmlp      - wrappers of the fused ADC + printed-MLP/SVM bank kernels
              (csrc/qmlp_bank.cu), with launch counters.
  adc_quantize - wrapper of the population quantizer kernel
              (csrc/adc_quantize.cu), with its launch counter.
  mc_eval   - wrappers of the Monte-Carlo non-ideal ADC kernel
              (csrc/mc_eval.cu), four entries with launch counters.
  flash_attention - wrapper of the two flash-attention kernels, the
              tensor-core one (csrc/flash_attention_tc.cu) and the
              CUDA-core one (csrc/flash_attention.cu), a launch counter each.
  envelope  - the Hopper shared-memory envelope of those kernels.
  dispatch  - the kernel-or-plain decision (and, for attention, the
              route) and its record.
  ops       - named entry points (adc_quantize{,_population},
              classifier_bank, bespoke_mlp/svm, mc_eval{,_cal}{,_population},
              flash_attention).
  _build    - nvcc build of csrc/*.cu at first CUDA use, ctypes binding.
"""
