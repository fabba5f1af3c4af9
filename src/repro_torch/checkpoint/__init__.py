from repro_torch.checkpoint.ckpt import (CheckpointManager, save_checkpoint,
                                         restore_checkpoint, latest_step)
from repro_torch.checkpoint.fixpoint import FixpointCheckpointer
