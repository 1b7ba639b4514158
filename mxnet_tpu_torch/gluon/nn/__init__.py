"""Layers of the port: basic layers and the convolution and pooling
layers, as Gluon blocks."""
from .basic_layers import (Activation, BatchNorm, Dense, Dropout, Embedding,
                           Flatten, HybridLambda, HybridSequential, Lambda,
                           LayerNorm, Sequential)
from .conv_layers import Conv2D, GlobalAvgPool2D, MaxPool2D

__all__ = ["Activation", "BatchNorm", "Conv2D", "Dense", "Dropout",
           "Embedding", "Flatten", "GlobalAvgPool2D", "HybridLambda",
           "HybridSequential", "Lambda", "LayerNorm", "MaxPool2D",
           "Sequential"]
