"""K-FAC warnings (port of ``kfac_pytorch_tpu/warnings.py``)."""
from __future__ import annotations


class ExperimentalFeatureWarning(Warning):
    """Warning for use of experimental features."""
