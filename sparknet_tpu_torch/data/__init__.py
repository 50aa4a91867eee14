from .cifar import load_cifar10_binary, write_cifar10_binary
from .integrity import (DataCorruptionError, Quarantine, QuarantineExceeded,
                        QuarantinePolicy)
from .minibatch import MinibatchSampler, make_minibatches
from .mnist import load_mnist_idx, write_mnist_idx
from .partition import PartitionedDataset
from .pipeline import (BufferRing, DecodePool, DecodeWorkerError, FeedStats,
                       ShardCache, feed_depth, feed_workers)
from .prefetch import DeviceFeed, FeedStalled, PrefetchIterator, device_feed
from .records import (RecordShard, ShardSet, ShardWriter, convert_to_shards,
                      is_records_source, records_feed, write_shard)
from .transforms import center_crop, compute_mean_image, random_crop_mirror
