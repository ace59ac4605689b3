from tensorflowdistributedlearning_tpu_torch.utils.compare import metric_comparison
from tensorflowdistributedlearning_tpu_torch.utils.devices import get_available_devices
from tensorflowdistributedlearning_tpu_torch.utils.params import count_params

__all__ = ["get_available_devices", "metric_comparison", "count_params"]
