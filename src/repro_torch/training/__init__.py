from repro_torch.training.trainer import (Trainer, TrainerConfig,  # noqa: F401
                                          TrainResult, make_train_step)
