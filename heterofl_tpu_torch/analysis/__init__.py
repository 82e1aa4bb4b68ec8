"""Post-hoc analysis tools: the model profiler (:mod:`.summary`), the
experiment grid generator (:mod:`.make`) and the result aggregation
(:mod:`.process`).

Port of ``heterofl_tpu/analysis/``.  The reference counts a program's
FLOPs with XLA's ``cost_analysis``; the port counts them with
``torch.utils.flop_counter.FlopCounterMode`` (:func:`.summary.flop_count`).
``compare_reference.py`` drives the original PyTorch code from a mounted
checkout and is not ported.
"""
