from .partition import PartitionedDataset
from .transforms import center_crop, compute_mean_image, random_crop_mirror
