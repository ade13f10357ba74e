from repro_torch.checkpoint.checkpointer import CheckpointManager, restore_tree, save_tree

__all__ = ["CheckpointManager", "restore_tree", "save_tree"]
