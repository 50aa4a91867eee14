from .mesh import CHIP_AXIS, HOST_AXIS, make_mesh, make_pod_mesh
from .trainer import (DistributedTrainer, TrainerConfig,
                      TrainingDivergedError, comm_config_from_env,
                      crop_mirror_mean, device_crop_mirror_mean)
