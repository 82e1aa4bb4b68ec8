"""Federated vision training (the flagship entry point).

Port of ``heterofl_tpu/entry/train_classifier_fed.py``: per round sample
``ceil(frac * num_users)`` users, train them with heterogeneous widths,
aggregate with the counted average.  Runs on CUDA unless ``--device cpu``::

    python -m heterofl_tpu_torch.entry.train_classifier_fed \\
        --control_name 1_100_0.1_iid_fix_a1-b1-c1-d1-e1_bn_1_1 --synthetic 1 \\
        --pallas_norm 1
"""

from .common import run_main


def main(argv=None):
    return run_main("heterofl-tpu (PyTorch/CUDA) federated classifier", "resnet18",
                    "CIFAR10", argv=argv)


if __name__ == "__main__":
    main()
