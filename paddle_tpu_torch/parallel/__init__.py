"""The parallel layouts of the dense-model path: the hybrid trainer over a
dp×pp×cp×mp mesh of logical ranks, its pipeline, tensor- and
expert-parallel layers, context-parallel attention and the topology
arithmetic (the ported part of the JAX package's ``parallel``).
``HybridParallelTrainer`` loads on first use: ``models.ernie`` builds on
this package's layers, and the trainer on ``models.ernie``."""

from .moe import ExpertFFN, MoELayer, top1_gate, top2_gate
from .mp_layers import (ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
                        VocabParallelEmbedding)
from .pipeline import pipeline_spmd_fn
from .ring_attention import (local_attention, ring_attention, ring_flash_attention,
                             ulysses_attention)
from .topology import CommunicateTopology, HybridCommunicateGroup

__all__ = ["ColumnParallelLinear", "CommunicateTopology", "ExpertFFN", "HybridCommunicateGroup",
           "HybridParallelTrainer", "MoELayer", "ParallelCrossEntropy", "RowParallelLinear",
           "VocabParallelEmbedding", "local_attention", "pipeline_spmd_fn", "ring_attention",
           "ring_flash_attention", "top1_gate", "top2_gate", "ulysses_attention"]


def __getattr__(name):
    if name == "HybridParallelTrainer":
        from .hybrid import HybridParallelTrainer

        return HybridParallelTrainer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
