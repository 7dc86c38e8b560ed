from .config import LidarConfig, PatchworkConfig, default_lidar_configs
from .device import accelerator_available, cleanup, device_info, initialize
from .timing import StageTimes, Timer
from .types import GroundResult, PointCloud, ScanBatch
