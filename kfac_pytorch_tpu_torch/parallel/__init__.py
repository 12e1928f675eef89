"""Bucketing and the bucketed second-order stage (one device)."""
from kfac_pytorch_tpu_torch.parallel.bucketing import BucketLayout
from kfac_pytorch_tpu_torch.parallel.bucketing import BucketPlan
from kfac_pytorch_tpu_torch.parallel.bucketing import make_bucket_plan
from kfac_pytorch_tpu_torch.parallel.bucketing import pad_dim
from kfac_pytorch_tpu_torch.parallel.second_order import BucketedSecondOrder
from kfac_pytorch_tpu_torch.parallel.second_order import BucketSecond
