from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     cosine_lr, global_norm)
from repro_torch.optim.compress import (compress_grads, decompress_grads,
                                        error_feedback_update,
                                        init_compress_state, CompressState)
