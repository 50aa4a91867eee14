from .trainer import (DistributedTrainer, TrainerConfig, crop_mirror_mean,
                      device_crop_mirror_mean)
