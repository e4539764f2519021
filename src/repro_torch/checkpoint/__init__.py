from repro_torch.checkpoint.sharded import (CheckpointManager, latest_step,
                                            restore_checkpoint,
                                            save_checkpoint)
