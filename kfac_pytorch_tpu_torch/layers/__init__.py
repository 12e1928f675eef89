"""Per-layer-type K-FAC helpers."""
from kfac_pytorch_tpu_torch.layers.helpers import ConvHelper
from kfac_pytorch_tpu_torch.layers.helpers import DenseHelper
from kfac_pytorch_tpu_torch.layers.helpers import LayerHelper
