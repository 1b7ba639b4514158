"""Model zoo of the port."""
from . import bert
from .bert import BERTModel, bert_base

__all__ = ["bert", "BERTModel", "bert_base"]
