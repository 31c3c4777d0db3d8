"""Training on the GPU: the twin of ``repro.train``: optimizer, loop,
checkpoint/restart, fault tolerance and gradient compression."""
from repro_torch.train.checkpoint import (
    AsyncCheckpointer,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.train.compression import (
    CompressionConfig,
    compress_gradients,
    compress_int8,
    compress_topk,
    init_residual,
)
from repro_torch.train.fault_tolerance import (
    ElasticPlan,
    FailureInjector,
    HeartbeatMonitor,
    StragglerDetector,
    data_skip_offset,
)
from repro_torch.train.loop import Trainer, TrainerConfig, WorkerFailure, train_step
from repro_torch.train.optimizer import AdamWConfig, adamw_update, init_opt_state, schedule

__all__ = ["AdamWConfig", "adamw_update", "init_opt_state", "schedule", "AsyncCheckpointer",
           "latest_step", "restore_checkpoint", "save_checkpoint", "CompressionConfig",
           "compress_gradients", "compress_int8", "compress_topk", "init_residual",
           "ElasticPlan", "FailureInjector", "HeartbeatMonitor", "StragglerDetector",
           "data_skip_offset", "Trainer", "TrainerConfig", "WorkerFailure", "train_step"]
