"""Model zoo of the port."""
from . import bert
from .bert import (BERTForPretraining, BERTModel, BERTPretrainingLoss,
                   bert_base)

__all__ = ["bert", "BERTForPretraining", "BERTModel", "BERTPretrainingLoss",
           "bert_base"]
