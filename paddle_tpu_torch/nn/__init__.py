"""Neural-network pieces of the port: the JAX package's layers, recurrent
layers and functional ops (``Sequential`` and ``LayerList`` are
``torch.nn``'s ``Sequential`` and ``ModuleList``, which name their
children "0", "1", ... as the JAX package does)."""

from torch.nn import ModuleList as LayerList
from torch.nn import Sequential

from . import functional
from .layers import (AdaptiveAvgPool2D, AvgPool2D, BatchNorm1D, BatchNorm2D,
                     BCEWithLogitsLoss, Conv2D, CrossEntropyLoss, Dropout, Embedding,
                     Flatten, GELU, LayerNorm, Linear, MaxPool2D, MSELoss, ReLU, Sigmoid,
                     Softmax, Tanh)
from .rnn import GRU, LSTM

__all__ = ["AdaptiveAvgPool2D", "AvgPool2D", "BCEWithLogitsLoss", "BatchNorm1D",
           "BatchNorm2D", "Conv2D", "CrossEntropyLoss", "Dropout", "Embedding", "Flatten",
           "GELU", "GRU", "LSTM", "LayerList", "LayerNorm", "Linear", "MSELoss",
           "MaxPool2D", "ReLU", "Sequential", "Sigmoid", "Softmax", "Tanh", "functional"]
