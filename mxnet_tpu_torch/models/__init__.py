"""Model definitions of the port."""
from __future__ import annotations

from . import bert, transformer
from .bert import (BERTClassifier, BERTForPretraining, BERTModel,
                   BERTRegression, bert_base, bert_large, get_bert)
from .transformer import TransformerNMT, transformer_base

__all__ = ["bert", "transformer", "TransformerNMT", "transformer_base",
           "BERTModel", "BERTForPretraining", "BERTClassifier",
           "BERTRegression", "bert_base", "bert_large", "get_bert"]
