from .config import DeepSpeedZeroConfig
from .partition import ZeroPartitionPlan
