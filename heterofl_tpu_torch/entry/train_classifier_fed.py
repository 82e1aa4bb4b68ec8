"""Federated vision training (the flagship entry point).

Port of ``heterofl_tpu/entry/train_classifier_fed.py``: per round sample
``ceil(frac * num_users)`` users, train them with heterogeneous widths,
aggregate with the counted average, evaluate (sBN, Local, Global) every
``eval_interval`` rounds and after the last, checkpoint every round and
copy the best by Global accuracy.  Runs on CUDA unless ``--device cpu``::

    python -m heterofl_tpu_torch.entry.train_classifier_fed \\
        --control_name 1_100_0.1_iid_fix_a1-b1-c1-d1-e1_bn_1_1 --synthetic 1 \\
        --pallas_norm 1 --output_dir ./output

``--resume_mode 1`` continues from ``output_dir/model/{tag}_checkpoint.pkl``
(``2``: its params and data split only, from round 1).
"""

from .common import run_main


def main(argv=None):
    return run_main("heterofl-tpu (PyTorch/CUDA) federated classifier", "resnet18",
                    "CIFAR10", pivot_metric="Global-Accuracy", pivot_mode="max", argv=argv)


if __name__ == "__main__":
    main()
