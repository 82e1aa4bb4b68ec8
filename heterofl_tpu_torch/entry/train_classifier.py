"""Centralised vision baseline (the paper's non-federated comparison).

Port of ``heterofl_tpu/entry/train_classifier.py``: the global-rate model
trained epoch by epoch on the whole train set (the control's split is
forced to ``none``: batch 100, the reference's epochs and milestones),
sBN and the test every epoch, a checkpoint every epoch and a copy of the
best by test accuracy.  Runs on CUDA unless ``--device cpu``::

    python -m heterofl_tpu_torch.entry.train_classifier \\
        --control_name 1_1_1_none_fix_a1_bn_1_1 --synthetic 1 --pallas_norm 1 \\
        --output_dir ./output
"""

from .central import run_central_main


def main(argv=None):
    return run_central_main("heterofl-tpu (PyTorch/CUDA) centralised classifier", "resnet18",
                            "CIFAR10", pivot_metric="Accuracy", pivot_mode="max", argv=argv)


if __name__ == "__main__":
    main()
