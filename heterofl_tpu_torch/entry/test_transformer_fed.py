"""Evaluation of a federated masked-LM checkpoint.

Port of ``heterofl_tpu/entry/test_transformer_fed.py``: Global of
``output_dir/model/{tag}_best.pkl`` (written by either package) at the
epoch it was logged at, bundled to ``output_dir/result/{tag}.pkl``.  Runs
on CUDA unless ``--device cpu``; pass the training run's flags::

    python -m heterofl_tpu_torch.entry.test_transformer_fed \\
        --control_name 1_100_0.01_iid_fix_a1-b1-c1-d1-e1_bn_1_1 --synthetic 1 \\
        --output_dir ./output
"""

from .evaluate import run_test_main


def main(argv=None):
    return run_test_main("heterofl-tpu (PyTorch/CUDA) test_transformer_fed", "transformer",
                         "WikiText2", argv=argv)


if __name__ == "__main__":
    main()
