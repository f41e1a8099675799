from tpusim_torch.config.simon import (
    AppInfo,
    CustomConfig,
    DescheduleConfig,
    ExportConfig,
    SimonCR,
    WorkloadInflationConfig,
    WorkloadTuningConfig,
    load_simon_cr,
)
from tpusim_torch.config.scheduler import SchedulerConfig, load_scheduler_config

__all__ = [
    "AppInfo",
    "CustomConfig",
    "DescheduleConfig",
    "ExportConfig",
    "SimonCR",
    "WorkloadInflationConfig",
    "WorkloadTuningConfig",
    "load_simon_cr",
    "SchedulerConfig",
    "load_scheduler_config",
]
