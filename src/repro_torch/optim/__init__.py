from repro_torch.optim.adamw import AdamWConfig, global_norm, init, schedule, update

__all__ = ["AdamWConfig", "global_norm", "init", "schedule", "update"]
