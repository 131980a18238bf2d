from repro_torch.optim.adamw import (AdamWConfig, apply_updates,  # noqa: F401
                                     clip_by_global_norm, global_norm,
                                     init_state, schedule_lr,
                                     state_specs)
