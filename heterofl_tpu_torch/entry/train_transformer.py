"""Centralised masked-LM baseline.

Port of ``heterofl_tpu/entry/train_transformer.py``: the global-rate
transformer trained epoch by epoch over the whole train stream (the
control's split is forced to ``none``: 100 rows of bptt 64 a step, the
reference's epochs and milestones), the test stream every epoch, a
checkpoint every epoch and a copy of the best by the minimised Perplexity.
Runs on CUDA unless ``--device cpu``::

    python -m heterofl_tpu_torch.entry.train_transformer \\
        --control_name 1_1_1_none_fix_a1_bn_1_1 --synthetic 1 --output_dir ./output
"""

from .central import run_central_main


def main(argv=None):
    return run_central_main("heterofl-tpu (PyTorch/CUDA) centralised transformer",
                            "transformer", "WikiText2", pivot_metric="Perplexity",
                            pivot_mode="min", argv=argv)


if __name__ == "__main__":
    main()
