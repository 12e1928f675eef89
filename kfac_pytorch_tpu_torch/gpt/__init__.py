"""K-FAC flavours for model-parallel transformer LMs.

Port of ``kfac_pytorch_tpu/gpt/``: the expert-sharded MoE flavour and
the stage-sharded GPipe flavour, over the shared stacked engine
(:mod:`kfac_pytorch_tpu_torch.gpt.stacked`).  The tensor-parallel
``GPTKFACPreconditioner`` and ``mpu`` are not ported yet (ROADMAP.md
Queue A item 25b).
"""
from kfac_pytorch_tpu_torch.gpt.moe import MoEKFACPreconditioner
from kfac_pytorch_tpu_torch.gpt.pipeline import PipelineKFACPreconditioner

__all__ = ['MoEKFACPreconditioner', 'PipelineKFACPreconditioner']
