from .cifar import load_cifar10_binary, write_cifar10_binary
from .partition import PartitionedDataset
from .pipeline import (BufferRing, DecodePool, DecodeWorkerError, FeedStats,
                       feed_depth)
from .prefetch import DeviceFeed, FeedStalled, PrefetchIterator, device_feed
from .transforms import center_crop, compute_mean_image, random_crop_mirror
