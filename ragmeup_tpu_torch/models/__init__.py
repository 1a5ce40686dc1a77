from ragmeup_tpu_torch.models.encoder import BertConfig, BertEncoder, SentenceEncoder
from ragmeup_tpu_torch.models.cross_encoder import CrossEncoder
from ragmeup_tpu_torch.models.tokenizer import SimpleTokenizer, WordPieceTokenizer, load_tokenizer

__all__ = [
    "BertConfig",
    "BertEncoder",
    "SentenceEncoder",
    "CrossEncoder",
    "SimpleTokenizer",
    "WordPieceTokenizer",
    "load_tokenizer",
]
