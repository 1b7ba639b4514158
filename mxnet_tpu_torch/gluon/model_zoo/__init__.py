"""Model zoo of the port: BERT, TransformerLM, the vision models, and the
weight carrier that loads the JAX package's parameters into them."""
from . import bert, carrier, vision
from .bert import (BERTForPretraining, BERTModel, BERTPretrainingLoss,
                   TransformerLM, bert_base)
from .carrier import load_jax_params, params_from_jax

__all__ = ["bert", "carrier", "vision", "BERTForPretraining", "BERTModel",
           "BERTPretrainingLoss", "TransformerLM", "bert_base",
           "load_jax_params", "params_from_jax"]
