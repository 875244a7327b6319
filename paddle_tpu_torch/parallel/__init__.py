"""The parallel layouts of the dense-model path: data parallel and ZeRO
(``spmd.SpmdTrainer``, ``sharding``'s stages), the hybrid trainer over a
dp×pp×cp×mp(×sh) mesh of logical ranks, the pipeline trainer (F-then-B, 1F1B
and interleave; ``pipeline_1f1b``), the heterogeneous pipeline
(``heter_pipeline``, ``heter_channel``), tensor- and
expert-parallel layers, context-parallel attention and the topology
arithmetic (the ported part of the JAX package's ``parallel``).
``HybridParallelTrainer`` loads on first use: ``models.ernie`` builds on
this package's layers, and the trainer on ``models.ernie``."""

from .moe import ExpertFFN, MoELayer, top1_gate, top2_gate
from .mp_layers import (ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
                        VocabParallelEmbedding)
from .pipeline import LayerDesc, PipelineLayer, PipelineTrainer, pipeline_spmd_fn
from .ring_attention import (local_attention, ring_attention, ring_flash_attention,
                             ulysses_attention)
from .sharding import ShardingStage1, ShardingStage2, ShardingStage3, group_sharded_parallel
from .spmd import DataParallel, SpmdTrainer, make_sharding_rules, shard_largest_dim
from .topology import CommunicateTopology, HybridCommunicateGroup

__all__ = ["ColumnParallelLinear", "CommunicateTopology", "DataParallel", "ExpertFFN",
           "HybridCommunicateGroup", "HybridParallelTrainer", "LayerDesc", "MoELayer",
           "ParallelCrossEntropy", "PipelineLayer", "PipelineTrainer", "RowParallelLinear",
           "ShardingStage1", "ShardingStage2", "ShardingStage3", "SpmdTrainer",
           "VocabParallelEmbedding", "group_sharded_parallel", "local_attention",
           "make_sharding_rules", "pipeline_spmd_fn", "ring_attention", "ring_flash_attention",
           "shard_largest_dim", "top1_gate", "top2_gate", "ulysses_attention"]


def __getattr__(name):
    if name == "HybridParallelTrainer":
        from .hybrid import HybridParallelTrainer

        return HybridParallelTrainer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
