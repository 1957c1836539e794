"""Models: the Llama-family decoder, its named configs, and the weight
bridge from the JAX package's parameter tree.

``__all__`` names the counterparts of ``gofr_tpu.models``' exports. The
JAX package's decoder is functions over a parameter tree; the port's is a
module: ``init_transformer`` is ``Transformer.random`` (or
``Transformer(cfg, device)``), and ``transformer_forward``, ``prefill``,
``decode_step`` and ``init_cache`` are ``Transformer``'s methods."""

from gofr_tpu_torch.models.bert import BertConfig, bert_embed, init_bert
from gofr_tpu_torch.models.mlp import MLPConfig, init_mlp, mlp_forward
from gofr_tpu_torch.models.transformer import Transformer, TransformerConfig

__all__ = [
    "MLPConfig", "init_mlp", "mlp_forward",
    "BertConfig", "init_bert", "bert_embed",
    "TransformerConfig", "Transformer",
]
