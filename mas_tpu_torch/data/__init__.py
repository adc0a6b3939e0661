"""Data layer of the PyTorch port: seg maps, tar shards, datasets and
batching, prefetching, the data factory and the text tokenizer."""

from .segmap import (NUM_SEG_CHANNELS, assemble_seg_map, one_hot_seg,
                     pad_boxes, sanitize_bboxes)
from .tario import iter_tar_samples, shard_split, warn_and_continue
from .dataset import (PreprocessedWebDataset, PreprocessedLocalDataset,
                      SyntheticSegBatches, SyntheticImgBatches,
                      SyntheticTokenBatches, collate)
from .prefetch import PrefetchIterator, prefetch
