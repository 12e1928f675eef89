"""Models of the PyTorch port."""
from kfac_pytorch_tpu_torch.models.cifar_resnet import CifarResNet
from kfac_pytorch_tpu_torch.models.cifar_resnet import init_weights
from kfac_pytorch_tpu_torch.models.cifar_resnet import resnet20
from kfac_pytorch_tpu_torch.models.cifar_resnet import resnet32
from kfac_pytorch_tpu_torch.models.gpt import GPT
from kfac_pytorch_tpu_torch.models.gpt import gpt_125m
from kfac_pytorch_tpu_torch.models.gpt import gpt_tiny
from kfac_pytorch_tpu_torch.models.gpt import GPTConfig
from kfac_pytorch_tpu_torch.models.resnet import Bottleneck
from kfac_pytorch_tpu_torch.models.resnet import ResNet
from kfac_pytorch_tpu_torch.models.resnet import resnet101
from kfac_pytorch_tpu_torch.models.resnet import resnet152
from kfac_pytorch_tpu_torch.models.resnet import resnet50
from kfac_pytorch_tpu_torch.models.tiny import LeNet
from kfac_pytorch_tpu_torch.models.tiny import TinyModel
