"""K-FAC in PyTorch for NVIDIA Hopper: the port of ``kfac_pytorch_tpu``.

The JAX package beside this one is the reference; this package imports
``torch`` and nothing of JAX or of the JAX package.  It covers the
bucketed path on one device and data-parallel across
``torch.distributed`` ranks on the KAISA grid (COMM-OPT, HYBRID-OPT,
MEM-OPT): Linear/Conv2d capture through module hooks (and, for
transformers, embeddings with an exact diagonal A factor, LayerNorm
scale+bias and a tied LM head), factor EMAs
averaged over the world, and a bucketed second-order refresh by one of
three methods — eigen (the fused eigen-preconditioning chain runs as a
hand-written CUDA kernel on CUDA tensors, ``csrc/fused_eigen_precond.cu``,
and as its plain PyTorch version on CPU tensors; without the predivided
eigenvalues, a matmul chain), inverse (damped Cholesky) and iterative
(warm-started Newton–Schulz); eigen also runs randomized low-rank
(``lowrank_rank``) and EKFAC (``ekfac``, with a drift-triggered refresh,
:class:`AdaptiveRefresh`, on every KAISA grid).  ``make_train_step`` and
``train_loop`` run the forward, backward, K-FAC and optimizer steps in
one call and feed Levenberg–Marquardt damping
(:class:`AdaptiveDamping`); ``last_step_info`` holds each step's
``vg_sum``.  ``accumulation_steps`` accumulates
micro-batches between steps; ``stagger_refresh`` spreads a refresh over
several steps, optionally choosing shards by drift
(:class:`AdaptiveRefreshConfig`); ``factor_comm='bf16_triu'``
compresses the factor all-reduce; ``bucketed=False`` runs the
replicated per-layer engine; ``state_dict``/``load_state_dict``
checkpoint and resume, and :class:`LambdaParamScheduler` schedules the
hyperparameters.  ``health=HealthConfig(...)`` turns on the
numerical-health guardrails (step-skip, decomposition retries, fallback
and quarantine, factor self-healing) and ``consistency=
ConsistencyConfig(...)`` the cross-replica consistency guard, and
``watchdog=WatchdogConfig(...)`` the trajectory watchdog; ``elastic``
saves and restores streaming checkpoints (no recompute on restore, any
world size) and ``utils.checkpoint`` the monolithic rotation;
``observe`` holds the monitor, the profiler ranges and timeline, the
cost ledger, the emission sinks and the flight recorder
(``observe=ObserveConfig(...)``, ``flight=FlightConfig(...)``), and
``runtime`` the bounded multi-process init, barriers and rank-death
detection;
``testing`` holds their fault injectors and ``tracing`` the event tally.
``placement`` solves the KAISA grid on a model of NVLink nodes joined by
a network (``grad_worker_fraction='auto', topology=PodTopology(...)``),
and ``_native`` builds the host C++ planners and data kernels with
``g++`` at their first use.
``gpt`` holds the MoE and GPipe flavours (``MoEKFACPreconditioner``,
``PipelineKFACPreconditioner``) and the tensor-parallel
``GPTKFACPreconditioner`` with ``mpu``; ``parallel`` the ring attention
and Megatron's tensor-parallel layers of the sequence- and
tensor-parallel GPT.  The models are the CIFAR ResNets, the ImageNet
ResNets, the GPT, the MoE model and the pipeline LM; ``examples/``
holds the CIFAR and ImageNet
trainers and ``bench`` the K-FAC/SGD step-time bench.  ``ROADMAP.md``
lists what is not ported yet.
"""
from kfac_pytorch_tpu_torch import elastic
from kfac_pytorch_tpu_torch import gpt
from kfac_pytorch_tpu_torch import models
from kfac_pytorch_tpu_torch import observe
from kfac_pytorch_tpu_torch import ops
from kfac_pytorch_tpu_torch import runtime
from kfac_pytorch_tpu_torch import testing
from kfac_pytorch_tpu_torch import tracing
from kfac_pytorch_tpu_torch.adaptive import AdaptiveDamping
from kfac_pytorch_tpu_torch.adaptive import AdaptiveRefresh
from kfac_pytorch_tpu_torch.consistency import ConsistencyConfig
from kfac_pytorch_tpu_torch.enums import AssignmentStrategy
from kfac_pytorch_tpu_torch.enums import ComputeMethod
from kfac_pytorch_tpu_torch.enums import DistributedStrategy
from kfac_pytorch_tpu_torch.health import HealthConfig
from kfac_pytorch_tpu_torch.ops import IterativeConfig
from kfac_pytorch_tpu_torch.preconditioner import KFACPreconditioner
from kfac_pytorch_tpu_torch.scheduler import AdaptiveRefreshConfig
from kfac_pytorch_tpu_torch.scheduler import LambdaParamScheduler
from kfac_pytorch_tpu_torch.watchdog import WatchdogConfig
# Last: the solver reads the bench's card table, which imports the
# preconditioner.
from kfac_pytorch_tpu_torch import placement  # noqa: E402
from kfac_pytorch_tpu_torch.placement import PodTopology  # noqa: E402
