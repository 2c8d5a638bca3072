from repro_torch.checkpoint.manager import CheckpointManager, manifest, restore, save

__all__ = ["CheckpointManager", "manifest", "restore", "save"]
