"""K-FAC math on tensors: covariances, EMA/kl-clip, eigen, fused kernel."""
from kfac_pytorch_tpu_torch.ops.cov import append_bias_ones
from kfac_pytorch_tpu_torch.ops.cov import conv2d_a_factor
from kfac_pytorch_tpu_torch.ops.cov import conv2d_a_rows
from kfac_pytorch_tpu_torch.ops.cov import conv2d_g_factor
from kfac_pytorch_tpu_torch.ops.cov import conv2d_g_rows
from kfac_pytorch_tpu_torch.ops.cov import cov_from_rows
from kfac_pytorch_tpu_torch.ops.cov import extract_patches
from kfac_pytorch_tpu_torch.ops.cov import get_cov
from kfac_pytorch_tpu_torch.ops.cov import linear_a_factor
from kfac_pytorch_tpu_torch.ops.cov import linear_a_rows
from kfac_pytorch_tpu_torch.ops.cov import linear_g_factor
from kfac_pytorch_tpu_torch.ops.cov import linear_g_rows
from kfac_pytorch_tpu_torch.ops.eigen import compute_dgda
from kfac_pytorch_tpu_torch.ops.eigen import compute_factor_eigen
from kfac_pytorch_tpu_torch.ops.eigen import EigenFactors
from kfac_pytorch_tpu_torch.ops.eigen import precondition_grad_eigen
from kfac_pytorch_tpu_torch.ops.fused_precond import (
    fused_eigen_precondition,
)
from kfac_pytorch_tpu_torch.ops.fused_precond import (
    fused_eigen_precondition_reference,
)
from kfac_pytorch_tpu_torch.ops.fused_precond import (
    fused_eigen_precondition_sharded,
)
from kfac_pytorch_tpu_torch.ops.fused_precond import (
    fused_eigen_precondition_sharded_reference,
)
from kfac_pytorch_tpu_torch.ops.update import ema_update_factor
from kfac_pytorch_tpu_torch.ops.update import grad_scale_sum
from kfac_pytorch_tpu_torch.ops.update import kl_clip_scale
