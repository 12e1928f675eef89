"""Per-layer-type K-FAC helpers."""
from kfac_pytorch_tpu_torch.layers.coverage import DenseGeneralHelper
from kfac_pytorch_tpu_torch.layers.coverage import DenseGeneralReduceHelper
from kfac_pytorch_tpu_torch.layers.coverage import KfacExpandHelper
from kfac_pytorch_tpu_torch.layers.coverage import KfacReduceHelper
from kfac_pytorch_tpu_torch.layers.coverage import ScaleBiasHelper
from kfac_pytorch_tpu_torch.layers.coverage import TiedAttend
from kfac_pytorch_tpu_torch.layers.coverage import TiedAttendHelper
from kfac_pytorch_tpu_torch.layers.coverage import TiedEmbedHelper
from kfac_pytorch_tpu_torch.layers.helpers import ConvHelper
from kfac_pytorch_tpu_torch.layers.helpers import DenseHelper
from kfac_pytorch_tpu_torch.layers.helpers import EmbedHelper
from kfac_pytorch_tpu_torch.layers.helpers import LayerHelper
from kfac_pytorch_tpu_torch.layers.tensor import ColumnParallelHelper
from kfac_pytorch_tpu_torch.layers.tensor import RowParallelHelper
