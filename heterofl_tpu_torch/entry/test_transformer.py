"""Evaluation of a centralised masked-LM checkpoint.

Port of ``heterofl_tpu/entry/test_transformer.py``: the test stream on
``output_dir/model/{tag}_best.pkl`` at the epoch it was logged at, bundled
to ``output_dir/result/{tag}.pkl``.  The control's split must be ``none``,
as the training run's tag has it::

    python -m heterofl_tpu_torch.entry.test_transformer \\
        --control_name 1_1_1_none_fix_a1_bn_1_1 --synthetic 1 --output_dir ./output
"""

from .evaluate import run_test_main


def main(argv=None):
    return run_test_main("heterofl-tpu (PyTorch/CUDA) test_transformer", "transformer",
                         "WikiText2", argv=argv)


if __name__ == "__main__":
    main()
