"""Embedding text files and training checkpoints (``persist.py``)."""

from come_tpu_torch.iohelpers.persist import (
    load_checkpoint,
    load_checkpoint_global,
    load_checkpoint_meta,
    load_checkpoint_sharded,
    load_embedding_word2vec,
    save_checkpoint,
    save_checkpoint_sharded,
    save_embedding_word2vec,
)

__all__ = [
    "save_embedding_word2vec",
    "load_embedding_word2vec",
    "save_checkpoint",
    "load_checkpoint",
    "save_checkpoint_sharded",
    "load_checkpoint_sharded",
    "load_checkpoint_meta",
    "load_checkpoint_global",
]
