"""K-FAC flavours for model-parallel transformer LMs.

Port of ``kfac_pytorch_tpu/gpt/``: the tensor-parallel
:class:`GPTKFACPreconditioner` on a ``('data', 'model')`` grid with its
:mod:`~kfac_pytorch_tpu_torch.gpt.mpu` helpers, the expert-sharded MoE
flavour and the stage-sharded GPipe flavour, the last two over the
shared stacked engine (:mod:`kfac_pytorch_tpu_torch.gpt.stacked`).
"""
from kfac_pytorch_tpu_torch.gpt import mpu
from kfac_pytorch_tpu_torch.gpt.moe import MoEKFACPreconditioner
from kfac_pytorch_tpu_torch.gpt.pipeline import PipelineKFACPreconditioner
from kfac_pytorch_tpu_torch.gpt.preconditioner import GPTKFACPreconditioner

__all__ = [
    'GPTKFACPreconditioner',
    'MoEKFACPreconditioner',
    'PipelineKFACPreconditioner',
    'mpu',
]
