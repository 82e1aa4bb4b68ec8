"""Federated masked-LM training.

Port of ``heterofl_tpu/entry/train_transformer_fed.py``: per round sample
``ceil(frac * num_users)`` users, train each on its token rows' bptt
windows with its width and label mask, aggregate with the counted average,
evaluate Global (no sBN, no Local) every ``eval_interval`` rounds and after
the last, checkpoint every round and copy the best by the minimised
Global-Perplexity.  Runs on CUDA unless ``--device cpu``::

    python -m heterofl_tpu_torch.entry.train_transformer_fed \\
        --control_name 1_100_0.01_iid_fix_a1-b1-c1-d1-e1_bn_1_1 --synthetic 1 \\
        --output_dir ./output

Without ``--synthetic 1`` it reads the token files under
``data_dir/WikiText2`` and raises when they are absent.
"""

from .common import run_main


def main(argv=None):
    return run_main("heterofl-tpu (PyTorch/CUDA) federated transformer", "transformer",
                    "WikiText2", pivot_metric="Global-Perplexity", pivot_mode="min", argv=argv)


if __name__ == "__main__":
    main()
