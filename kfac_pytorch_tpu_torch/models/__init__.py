"""Models of the PyTorch port."""
from kfac_pytorch_tpu_torch.models.cifar_resnet import CifarResNet
from kfac_pytorch_tpu_torch.models.cifar_resnet import init_weights
from kfac_pytorch_tpu_torch.models.cifar_resnet import resnet20
from kfac_pytorch_tpu_torch.models.cifar_resnet import resnet32
