"""Model zoo subset (counterpart of ``incubator_mxnet_tpu/models``)."""
from .bert import (BERTEncoder, BERTEncoderCell, BERTForPretrain, BERTModel,
                   BERTPretrainLoss, MultiHeadAttentionCell, PositionwiseFFN,
                   bert_12_768_12, get_bert_model)
from .resnet import (BasicBlockV1, BasicBlockV2, BottleneckV1, BottleneckV2,
                     ResNetV1, ResNetV2, SpaceToDepthStem, get_resnet,
                     resnet18_v1,
                     resnet18_v2, resnet34_v1, resnet34_v2, resnet50_v1,
                     resnet50_v2, resnet101_v1, resnet101_v2, resnet152_v1,
                     resnet152_v2)
from .transformer_lm import (CausalSelfAttention, TransformerLM,
                             TransformerLMCell, lm_loss, transformer_lm_base,
                             transformer_lm_small)

__all__ = ["BERTEncoder", "BERTEncoderCell", "BERTForPretrain", "BERTModel",
           "BERTPretrainLoss",
           "MultiHeadAttentionCell", "PositionwiseFFN", "bert_12_768_12",
           "get_bert_model", "BasicBlockV1", "BasicBlockV2", "BottleneckV1",
           "BottleneckV2", "ResNetV1", "ResNetV2", "SpaceToDepthStem",
           "get_resnet",
           "resnet18_v1", "resnet18_v2", "resnet34_v1", "resnet34_v2",
           "resnet50_v1", "resnet50_v2", "resnet101_v1", "resnet101_v2",
           "resnet152_v1", "resnet152_v2", "CausalSelfAttention",
           "TransformerLM", "TransformerLMCell", "lm_loss",
           "transformer_lm_base", "transformer_lm_small"]
