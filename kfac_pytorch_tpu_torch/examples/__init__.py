"""Trainers of the PyTorch port: ``cifar10_resnet`` and ``imagenet_resnet``
(run with ``python -m kfac_pytorch_tpu_torch.examples.<name>``)."""
