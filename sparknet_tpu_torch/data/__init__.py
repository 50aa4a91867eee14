from .cifar import load_cifar10_binary, write_cifar10_binary
from .partition import PartitionedDataset
from .transforms import center_crop, compute_mean_image, random_crop_mirror
