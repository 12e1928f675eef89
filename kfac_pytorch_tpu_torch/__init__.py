"""K-FAC in PyTorch for NVIDIA Hopper: the port of ``kfac_pytorch_tpu``.

The JAX package beside this one is the reference; this package imports
``torch`` and nothing of JAX or of the JAX package.  It covers the main
path on one device: Linear/Conv2d capture through module hooks, factor
EMAs, the bucketed eigendecomposition refresh and the fused
eigen-preconditioning chain, which runs as a hand-written CUDA kernel on
CUDA tensors (``csrc/fused_eigen_precond.cu``) and as its plain PyTorch
version on CPU tensors.  ``ROADMAP.md`` lists what is not ported yet.
"""
from kfac_pytorch_tpu_torch import models
from kfac_pytorch_tpu_torch import ops
from kfac_pytorch_tpu_torch.enums import AssignmentStrategy
from kfac_pytorch_tpu_torch.enums import ComputeMethod
from kfac_pytorch_tpu_torch.enums import DistributedStrategy
from kfac_pytorch_tpu_torch.preconditioner import KFACPreconditioner
