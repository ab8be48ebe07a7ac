"""Fault tolerance for pruned binary-search ADCs. Counterpart of
``repro/faulttol``: a redundancy-aware genome, the yield objective and
per-instance calibration, on top of the non-ideality model
(core/nonideal.py).

* ``spec``       - ``FaultTolSpec``: which redundancy/repair actions the
                   search genome may take (frozen, JSON meta).
* ``redundancy`` - the 3-replica draw stream, the majority-vote fold onto
                   ordinary per-node draws, and the gene decoder.
* ``calibrate``  - measured-interval value-table re-bake and the
                   calibrated-table MC operand compiler.

Search wiring is in ``core/search.py``, pricing in ``core/area.py``
(``tmr_tc`` / ``calibration_tc`` / ``faulttol_tc``), deployment in
``core/deploy.py`` (``calibrate_front`` / ``make_calibrated_bank_fn``).
"""
from repro_torch.faulttol.calibrate import (calibrated_value_rows,
                                            mc_operands_ft)
from repro_torch.faulttol.redundancy import (REPLICAS, RedundantDraws,
                                             decode_genes, draw_redundant,
                                             effective_draws)
from repro_torch.faulttol.spec import FaultTolSpec

__all__ = [
    "FaultTolSpec", "RedundantDraws", "REPLICAS", "calibrated_value_rows",
    "decode_genes", "draw_redundant", "effective_draws", "mc_operands_ft",
]
