"""Bucketing, the KAISA grid and collectives, the bucketed second-order
stage, the GPipe schedule, ring attention and tensor parallelism."""
from kfac_pytorch_tpu_torch.parallel import collectives
from kfac_pytorch_tpu_torch.parallel import pipeline
from kfac_pytorch_tpu_torch.parallel import ring_attention
from kfac_pytorch_tpu_torch.parallel import tensor
from kfac_pytorch_tpu_torch.parallel.bucketing import BucketLayout
from kfac_pytorch_tpu_torch.parallel.bucketing import BucketPlan
from kfac_pytorch_tpu_torch.parallel.bucketing import make_bucket_plan
from kfac_pytorch_tpu_torch.parallel.bucketing import pad_dim
from kfac_pytorch_tpu_torch.parallel.mesh import axis_groups
from kfac_pytorch_tpu_torch.parallel.mesh import AxisGroups
from kfac_pytorch_tpu_torch.parallel.mesh import data_world
from kfac_pytorch_tpu_torch.parallel.mesh import default_backend
from kfac_pytorch_tpu_torch.parallel.mesh import grid_shape
from kfac_pytorch_tpu_torch.parallel.mesh import kaisa_grid
from kfac_pytorch_tpu_torch.parallel.mesh import KaisaGrid
from kfac_pytorch_tpu_torch.parallel.second_order import BucketedSecondOrder
from kfac_pytorch_tpu_torch.parallel.second_order import BucketSecond
