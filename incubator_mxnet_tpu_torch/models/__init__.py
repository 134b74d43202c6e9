"""Model zoo subset (counterpart of ``incubator_mxnet_tpu/models``)."""
from .bert import (BERTEncoder, BERTEncoderCell, BERTModel,
                   MultiHeadAttentionCell, PositionwiseFFN, bert_12_768_12,
                   get_bert_model)
from .transformer_lm import (CausalSelfAttention, TransformerLM,
                             TransformerLMCell, lm_loss, transformer_lm_base,
                             transformer_lm_small)

__all__ = ["BERTEncoder", "BERTEncoderCell", "BERTModel",
           "MultiHeadAttentionCell", "PositionwiseFFN", "bert_12_768_12",
           "get_bert_model", "CausalSelfAttention", "TransformerLM",
           "TransformerLMCell", "lm_loss", "transformer_lm_base",
           "transformer_lm_small"]
