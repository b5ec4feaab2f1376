"""EMA corpus adapters (port of `arttts_tpu/corpora/`): label->IPA phnm3
converters and EMA readers for MNGU0, MOCHA-TIMIT, MSPKA and PB2007 (ref
`src/utils_dataset/`)."""

from arttts_tpu_torch.corpora.registry import CORPORA, get_corpus

__all__ = ["CORPORA", "get_corpus"]
