from come_tpu_torch.sampling.alias import (
    build_alias_table,
    sample_alias,
    unigram_weights,
)
from come_tpu_torch.sampling.stars import build_star_layout, star_layout_stats
from come_tpu_torch.sampling.walks import random_walks
from come_tpu_torch.sampling.windows import (
    skipgram_pairs,
    subsample_keep_probs,
)

__all__ = [
    "build_alias_table",
    "build_star_layout",
    "random_walks",
    "sample_alias",
    "skipgram_pairs",
    "star_layout_stats",
    "subsample_keep_probs",
    "unigram_weights",
]
