"""K-FAC math on tensors: covariances, EMA/kl-clip, eigen, randomized
low-rank eigen, EKFAC scales, inverse, Newton–Schulz, triu packing,
fused kernel."""
from kfac_pytorch_tpu_torch.ops.cov import append_bias_ones
from kfac_pytorch_tpu_torch.ops.cov import attend_a_diag
from kfac_pytorch_tpu_torch.ops.cov import attend_g_factor
from kfac_pytorch_tpu_torch.ops.cov import conv2d_a_factor
from kfac_pytorch_tpu_torch.ops.cov import conv2d_a_rows
from kfac_pytorch_tpu_torch.ops.cov import conv2d_g_factor
from kfac_pytorch_tpu_torch.ops.cov import conv2d_g_rows
from kfac_pytorch_tpu_torch.ops.cov import cov_from_rows
from kfac_pytorch_tpu_torch.ops.cov import cov_psum_compressed
from kfac_pytorch_tpu_torch.ops.cov import embed_a_diag
from kfac_pytorch_tpu_torch.ops.cov import extract_patches
from kfac_pytorch_tpu_torch.ops.cov import get_cov
from kfac_pytorch_tpu_torch.ops.cov import layernorm_normalized
from kfac_pytorch_tpu_torch.ops.cov import linear_a_factor
from kfac_pytorch_tpu_torch.ops.cov import linear_a_rows
from kfac_pytorch_tpu_torch.ops.cov import linear_g_factor
from kfac_pytorch_tpu_torch.ops.cov import linear_g_rows
from kfac_pytorch_tpu_torch.ops.cov import linear_reduce_a_rows
from kfac_pytorch_tpu_torch.ops.cov import linear_reduce_g_rows
from kfac_pytorch_tpu_torch.ops.cov import reduce_sum_shared
from kfac_pytorch_tpu_torch.ops.cov import scale_bias_a_factor
from kfac_pytorch_tpu_torch.ops.cov import scale_bias_a_rows
from kfac_pytorch_tpu_torch.ops.eigen import compute_dgda
from kfac_pytorch_tpu_torch.ops.eigen import compute_factor_eig_general
from kfac_pytorch_tpu_torch.ops.eigen import compute_factor_eigen
from kfac_pytorch_tpu_torch.ops.eigen import EigenFactors
from kfac_pytorch_tpu_torch.ops.eigen import precondition_grad_eigen
from kfac_pytorch_tpu_torch.ops.eigen import precondition_grad_eigen_diag_a
from kfac_pytorch_tpu_torch.ops.eigen import symmetric_eigh
from kfac_pytorch_tpu_torch.ops.ekfac import ekfac_divergence
from kfac_pytorch_tpu_torch.ops.ekfac import ekfac_divergence_info
from kfac_pytorch_tpu_torch.ops.ekfac import ekfac_scale_contrib
from kfac_pytorch_tpu_torch.ops.ekfac import ekfac_scale_contrib_stacked
from kfac_pytorch_tpu_torch.ops.fused_precond import (
    fused_eigen_precond_op,
)
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
    fused_eigen_precondition_sharded_async,
)
from kfac_pytorch_tpu_torch.ops.fused_precond import (
    fused_eigen_precondition_sharded_reference,
)
from kfac_pytorch_tpu_torch.ops.fused_precond import substitute_quarantined
from kfac_pytorch_tpu_torch.ops.inverse import batched_damped_inv
from kfac_pytorch_tpu_torch.ops.inverse import compute_factor_inv
from kfac_pytorch_tpu_torch.ops.inverse import compute_factor_inv_general
from kfac_pytorch_tpu_torch.ops.inverse import precondition_grad_inverse
from kfac_pytorch_tpu_torch.ops.inverse import (
    precondition_grad_inverse_diag_a,
)
from kfac_pytorch_tpu_torch.ops.iterative import (
    batched_newton_schulz_inv_sqrt,
)
from kfac_pytorch_tpu_torch.ops.iterative import (
    batched_newton_schulz_inverse,
)
from kfac_pytorch_tpu_torch.ops.iterative import damped_stack
from kfac_pytorch_tpu_torch.ops.iterative import IterativeConfig
from kfac_pytorch_tpu_torch.ops.iterative import NewtonSchulzResult
from kfac_pytorch_tpu_torch.ops.iterative import spectral_norm_bound
from kfac_pytorch_tpu_torch.ops.lowrank import batched_randomized_eigh
from kfac_pytorch_tpu_torch.ops.lowrank import decompose_stack
from kfac_pytorch_tpu_torch.ops.lowrank import draw_sketch
from kfac_pytorch_tpu_torch.ops.lowrank import lowrank_engages
from kfac_pytorch_tpu_torch.ops.lowrank import LowRankEigen
from kfac_pytorch_tpu_torch.ops.lowrank import precondition_grad_lowrank
from kfac_pytorch_tpu_torch.ops.lowrank import randomized_eigh
from kfac_pytorch_tpu_torch.ops.lowrank import thin_eigen_fields
from kfac_pytorch_tpu_torch.ops.triu import fill_triu
from kfac_pytorch_tpu_torch.ops.triu import get_triu
from kfac_pytorch_tpu_torch.ops.triu import NonSquareTensorError
from kfac_pytorch_tpu_torch.ops.update import ema_update_factor
from kfac_pytorch_tpu_torch.ops.update import grad_scale_sum
from kfac_pytorch_tpu_torch.ops.update import kl_clip_scale
from kfac_pytorch_tpu_torch.ops.update import lr_squared
