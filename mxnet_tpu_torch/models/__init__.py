"""Model definitions of the port."""
from __future__ import annotations

from . import bert, mlp, transformer
from .bert import (BERTClassifier, BERTForPretraining, BERTModel,
                   BERTRegression, bert_base, bert_large, get_bert)
from .mlp import get_mlp
from .transformer import TransformerNMT, transformer_base

__all__ = ["bert", "mlp", "transformer", "get_mlp", "TransformerNMT", "transformer_base",
           "BERTModel", "BERTForPretraining", "BERTClassifier",
           "BERTRegression", "bert_base", "bert_large", "get_bert"]
