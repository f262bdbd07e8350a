from repro_torch.checkpoint.manager import CheckpointManager, restore_state, save_state

__all__ = ["CheckpointManager", "save_state", "restore_state"]
