"""Model zoo of the port: BERT, TransformerLM, the vision models, the
LSTM word language model, DLRM, and the weight carrier that loads the JAX
package's parameters into them."""
from . import bert, carrier, lstm_lm, vision
from . import dlrm as dlrm_zoo
from .bert import (BERTForPretraining, BERTModel, BERTPretrainingLoss,
                   TransformerLM, bert_base)
from .carrier import load_jax_params, params_from_jax
from .dlrm import DLRM, dlrm_tiny
from .lstm_lm import LSTMLanguageModel, ptb_medium

__all__ = ["bert", "carrier", "dlrm_zoo", "lstm_lm", "vision", "DLRM",
           "dlrm_tiny", "BERTForPretraining",
           "BERTModel", "BERTPretrainingLoss", "LSTMLanguageModel",
           "TransformerLM", "bert_base", "load_jax_params",
           "params_from_jax", "ptb_medium"]
