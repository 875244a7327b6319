"""Models of the port.

The vision families' constructors, DIN, the multitask family
(``ESMM``, ``MMoE``) and DeepWalk (``DeepWalkConfig``,
``make_deepwalk_train_step``) are exported here, as the JAX package's ``models``
exports them; the other CTR, recsys and ERNIE models are imported from
their modules (``models.ctr``, ``models.gru4rec``, ...)."""

from .alexnet import AlexNet, alexnet
from .densenet import DenseNet, densenet121, densenet161, densenet169, densenet201
from .din import DIN, make_ctr_attention_train_step
from .googlenet import GoogLeNet, googlenet
from .graph_embedding import DeepWalkConfig, make_deepwalk_train_step
from .lenet import LeNet
from .mobilenet import MobileNetV1, MobileNetV2, mobilenet_v1, mobilenet_v2
from .multitask import ESMM, MMoE, make_multitask_train_step
from .resnet import ResNet, resnet18, resnet34, resnet50, resnet101, resnet152
from .shufflenetv2 import (ShuffleNetV2, shufflenet_v2_x0_25, shufflenet_v2_x0_5,
                           shufflenet_v2_x1_0, shufflenet_v2_x1_5, shufflenet_v2_x2_0)
from .squeezenet import SqueezeNet, squeezenet1_0, squeezenet1_1
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19

__all__ = ["AlexNet", "DIN", "DeepWalkConfig", "DenseNet", "ESMM", "GoogLeNet", "LeNet", "MMoE", "MobileNetV1",
           "MobileNetV2", "ResNet", "ShuffleNetV2", "SqueezeNet", "VGG", "alexnet",
           "densenet121", "densenet161", "densenet169", "densenet201", "googlenet",
           "make_ctr_attention_train_step", "make_deepwalk_train_step", "make_multitask_train_step", "mobilenet_v1",
           "mobilenet_v2",
           "resnet101", "resnet152", "resnet18", "resnet34", "resnet50", "shufflenet_v2_x0_25",
           "shufflenet_v2_x0_5", "shufflenet_v2_x1_0", "shufflenet_v2_x1_5",
           "shufflenet_v2_x2_0", "squeezenet1_0", "squeezenet1_1", "vgg11", "vgg13", "vgg16",
           "vgg19"]
