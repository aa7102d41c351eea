from repro_torch.checkpoint.checkpointer import (MANIFEST_VERSION, Block,
                                                 CheckpointError,
                                                 Checkpointer)

__all__ = ["MANIFEST_VERSION", "Block", "CheckpointError", "Checkpointer"]
