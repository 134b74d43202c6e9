"""Model zoo subset (counterpart of ``incubator_mxnet_tpu/models``)."""
from .bert import (BERTEncoder, BERTEncoderCell, BERTModel,
                   MultiHeadAttentionCell, PositionwiseFFN, bert_12_768_12,
                   get_bert_model)

__all__ = ["BERTEncoder", "BERTEncoderCell", "BERTModel",
           "MultiHeadAttentionCell", "PositionwiseFFN", "bert_12_768_12",
           "get_bert_model"]
