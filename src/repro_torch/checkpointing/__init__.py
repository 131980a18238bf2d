from repro_torch.checkpointing.checkpoint import (AsyncCheckpointer,  # noqa: F401
                                                  list_steps, load,
                                                  load_latest, save)
